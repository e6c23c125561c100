"""Fault-tolerant checkpointing of the port (the JAX package's
``checkpoint/checkpointer.py``), in the same on-disk format, so a checkpoint
written by either package restores in the other.

  * atomic: write into ``<dir>/tmp.<step>``, fsync, rename to
    ``step_<n:08d>`` -- a crash mid-save never corrupts the latest
    checkpoint; the last 3 steps are kept.
  * integrity: ``manifest.json`` stores ``step`` and, per leaf,
    ``{file, shape, dtype, sha256}``; restore verifies before use.
  * leaves: one ``.npy`` each, named ``md5(leaf name)[:16]``; leaf names
    are JAX's (``"/".join(str(k) for k in path)``): ``['params']/['stacks']/
    ['j0']/['attn']/['wq']`` for dict keys, ``.store/.pool`` for a
    HashMem's fields.  A model's layer leaves are stacked on a leading layer
    axis, as JAX stacks them; a HashMem's ``pool``, ``planes``, ``fprints``
    and ``stash`` are written as uint32 (the port holds their bits as
    int32); a bfloat16 leaf is written as JAX writes it, npy descr ``<V2``
    and manifest dtype ``bfloat16``, and read back through an int16 view.
  * snapshot: ``save`` copies every leaf to host memory before it returns
    (the port updates parameters and moments in place); a writer thread
    (``async_save``) writes those copies while training goes on.  Leaves are
    written and hashed, and read and verified, by a pool of threads.
  * restore: into a target of the saved tree's structure -- a ``Model``
    built on the meta device, a ``ParamDict`` or dict of (meta) tensors, an
    empty (or stacked) HashMem -- placed on ``device`` (None: the card).  A
    table saved with a leading shard axis restores as a stacked table (JAX
    restores it elastically onto a mesh; the port stacks shards on one
    card).
  * over the ranks of a ``ModelMesh`` (``Checkpointer(dir, mesh=...)``,
    every rank making the same calls): a state whose tensors are blocks
    (each with its ``.spec``) is saved in the same format, one whole
    ``.npy`` a leaf: each tensor is all-gathered on the card one at a time
    and rank 0 alone copies it to the host and writes; ``wait`` ends with a
    barrier, so every rank then sees the same ``latest_step``.  Restore
    onto any mesh (``model.rank_model_meta`` and ``init_opt_state`` of it
    as the target): every rank reads and verifies each leaf and keeps its
    block, JAX's elastic restore.
"""
from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core import hashmap
from repro_torch.core.layout import resolve_device
from repro_torch.distributed import sharding
from repro_torch.models.model import ParamDict, jax_leaves, named_tensors

BF16_DESCR = "<V2"       # how numpy writes JAX's bfloat16 (ml_dtypes)
# a PageStore's array fields in the JAX dataclass's order, which is the
# order of the leaves in JAX's manifest
HASHMEM_FIELDS = ("pool", "planes", "page_next", "page_fill", "free_top",
                  "fprints", "stash", "stash_fill", "local_depth")
IO_THREADS = min(8, os.cpu_count() or 1)


# ---------------------------------------------------------------------------
# The tree as JAX flattens it: [(leaf name, tensors, stacked)]
# ---------------------------------------------------------------------------

def _key(k) -> str:
    return f"['{k}']"


def _flatten(tree, prefix: str = "") -> list:
    """(name, [tensors], stacked) for every leaf, in JAX's order: dict keys
    sorted, a HashMem's fields in its dataclass order (``store`` then
    ``bucket_head``; a None field has no leaf), a model's or ParamDict's
    leaves by JAX path with one tensor a layer to stack."""
    join = (prefix + "/") if prefix else ""
    if isinstance(tree, (nn.Module, ParamDict)):
        named = named_tensors(tree)
        return [(join + "/".join(_key(k) for k in path.split("/")),
                 [named[n] for n in names], stacked)
                for path, (names, stacked) in jax_leaves(tree).items()]
    if isinstance(tree, hashmap.HashMem):
        out = [(f"{join}.store/.{f}", [getattr(tree.store, f)], False)
               for f in HASHMEM_FIELDS if getattr(tree.store, f) is not None]
        return out + [(f"{join}.bucket_head", [tree.bucket_head], False)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _flatten(tree[k], join + _key(k))]
    return [(prefix, [torch.as_tensor(tree)], False)]


def _with_spec(t, like):
    if hasattr(like, "spec"):
        t.spec = like.spec
    return t


def _empty_like(tree, dev):
    """``tree``'s structure with uninitialised tensors of its shapes and
    dtypes on ``dev``: where a restore writes.  Each tensor keeps its
    source's ``.spec``."""
    if isinstance(tree, nn.Module):
        out = copy.deepcopy(tree).to_empty(device=dev)
        src = dict(tree.named_parameters())
        for n, t in out.named_parameters():
            _with_spec(t, src[n])
        return out
    if isinstance(tree, ParamDict):
        return ParamDict({n: _with_spec(torch.empty_like(t, device=dev), t)
                          for n, t in tree.items()})
    if isinstance(tree, hashmap.HashMem):
        return hashmap._map_leaves(
            [tree], lambda ts: torch.empty_like(ts[0], device=dev))
    if isinstance(tree, dict):
        return {k: _empty_like(v, dev) for k, v in tree.items()}
    return torch.empty_like(torch.as_tensor(tree), device=dev)


def _dtype_name(name: str, t: torch.Tensor) -> str:
    """The leaf's dtype as JAX writes it in the manifest."""
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    if any(name.endswith(f".{f}") for f in hashmap.U32_LEAVES):
        return "uint32"
    return str(torch.empty(0, dtype=t.dtype).numpy().dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A bfloat16 tensor's bits as int16 (numpy has no bfloat16)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _host_copy(name: str, ts: list, stacked: bool, mesh=None):
    """(host array, manifest dtype) of one leaf: a copy, never a view.  Over
    ``mesh`` each tensor is made whole on the card (``sharding.
    full_tensor``) and copied out before the next; ranks other than 0 take
    part in the gathers and return None."""
    dtype = _dtype_name(name, ts[0])
    out = None
    for i, t in enumerate(ts):
        if mesh is not None:
            with torch.no_grad():
                t = sharding.full_tensor(t, mesh)
            if mesh.rank != 0:
                continue
        t = _bits(t.detach())
        if out is None:
            out = torch.empty(((len(ts),) if stacked else ()) +
                              tuple(t.shape), dtype=t.dtype)
        (out[i] if stacked else out).copy_(t)
    if out is None:
        return None, dtype
    arr = out.numpy()
    return (arr.view(np.uint32) if dtype == "uint32" else arr), dtype


def _save_npy(path: Path, arr: np.ndarray, dtype: str):
    """``np.save``; a bfloat16 leaf's bits under JAX's header (descr
    ``<V2``), so the file is the one JAX writes."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        header = np.lib.format.header_data_from_array_1_0(arr)
        header["descr"] = BF16_DESCR
        np.lib.format.write_array_header_1_0(f, header)
        arr.tofile(f)


def _load_npy(path: Path, dtype: str) -> np.ndarray:
    arr = np.load(path)
    if dtype == "bfloat16":
        return arr.view(np.int16)
    return arr.view(np.int32) if dtype == "uint32" else arr


def _sha256(arr: np.ndarray) -> str:
    """sha256 of the leaf's bytes (JAX hashes ``arr.tobytes()``)."""
    return hashlib.sha256(
        np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).hexdigest()


class Checkpointer:
    def __init__(self, directory: str, async_save: bool = True, mesh=None):
        self.dir = Path(directory)
        self.mesh = mesh
        if self._writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier()

    @property
    def _writer(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self, failed: bool = False):
        """Over a mesh: wait for every rank, and raise on every rank if one
        failed."""
        if self.mesh is None:
            return
        flag = torch.full((1,), float(failed), device=self.mesh.device)
        if float(self.mesh.all_reduce(flag, self.mesh.axis_names)[0]) and \
                not failed:
            raise IOError("checkpoint: another rank failed to write")

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, blocking: bool = False):
        """Snapshot ``tree`` to host memory, then write it: in a thread,
        unless ``blocking`` or the checkpointer is synchronous.  Over a mesh
        every rank calls it; rank 0 writes."""
        self.wait()
        host = [(name, *_host_copy(name, ts, st, self.mesh))
                for name, ts, st in _flatten(tree)]
        if not self._writer:
            return
        if self.async_save and not blocking:
            self._thread = threading.Thread(target=self._write_async,
                                            args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write_async(self, step: int, host: list):
        try:
            self._write(step, host)
        except BaseException as e:   # raised again by wait() in the caller
            self._error = e

    def _write(self, step: int, host: list):
        tmp = self.dir / f"tmp.{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        def write_leaf(leaf):
            name, arr, dtype = leaf
            fn = hashlib.md5(name.encode()).hexdigest()[:16] + ".npy"
            _save_npy(tmp / fn, arr, dtype)
            return name, {"file": fn, "shape": list(arr.shape),
                          "dtype": dtype, "sha256": _sha256(arr)}

        with ThreadPoolExecutor(IO_THREADS) as pool:
            arrays = dict(pool.map(write_leaf, host))
        manifest = {"step": step, "arrays": arrays}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        fd = os.open(tmp, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
        final = self.dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc(keep=3)

    def wait(self):
        """Join the writer thread; raise what it raised (over a mesh, on
        every rank, after a barrier)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        self._barrier(err is not None)
        if err is not None:
            raise err

    def _gc(self, keep: int):
        steps = sorted(self.all_steps())
        for s in steps[:-keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, step: int, target_tree: Any, device=None,
                verify: bool = True):
        """The tree saved at ``step`` in ``target_tree``'s structure, on
        ``device`` (None: the card).  Raises IOError on a leaf whose sha256
        differs from the manifest's and ValueError on a shape or dtype the
        target does not have.  Over a mesh the target's tensors are blocks
        with their ``.spec``, and each rank keeps its block of each leaf."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        out = _empty_like(target_tree, resolve_device(device))
        leaves = _flatten(out)
        mesh = self.mesh

        def whole(t):
            if mesh is None:
                return tuple(t.shape)
            return sharding.whole_shape(t.shape, getattr(t, "spec", ()), mesh)

        def read_leaf(leaf):
            name, ts, stacked = leaf
            meta = manifest["arrays"][name]
            arr = _load_npy(d / meta["file"], meta["dtype"])
            if verify and _sha256(arr) != meta["sha256"]:
                raise IOError(f"checkpoint corruption in {name}")
            shape = ((len(ts),) if stacked else ()) + whole(ts[0])
            if arr.shape != shape:
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{arr.shape} vs {shape}")
            if meta["dtype"] != _dtype_name(name, ts[0]):
                raise ValueError(f"dtype mismatch for {name}: {meta['dtype']}"
                                 f" vs {_dtype_name(name, ts[0])}")
            return arr

        with ThreadPoolExecutor(IO_THREADS) as pool, torch.no_grad():
            for (name, ts, stacked), arr in zip(leaves,
                                                pool.map(read_leaf, leaves)):
                src = torch.from_numpy(arr)
                for i, t in enumerate(ts):
                    a = src[i] if stacked else src
                    if mesh is not None:
                        a = sharding.local_block(a, getattr(t, "spec", ()),
                                                 mesh)
                    _bits(t).copy_(a)
        return out
