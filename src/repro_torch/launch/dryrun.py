"""Dry-run of the port over the production meshes: every (arch x shape x
mesh) cell traced on fake tensors (the JAX package's ``launch/dryrun.py``,
which lowers and compiles each cell for 512 forced host devices).

For each cell, one rank's train, prefill or decode step runs at published
widths under ``FakeTensorMode`` on the CPU device (the port's entry points
refuse the meta device), over a
``launch.mesh.RecordingMesh`` of the (16, 16) ``("data", "model")`` mesh or
the (2, 16, 16) multi-pod one: every tensor has its shape and dtype and no
storage, so nothing is allocated and no kernel runs.  The record of a cell
(JAX's keys where there is a counterpart) holds, for that rank:

  * ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``'s
    count (matmuls, forward and backward; not elementwise ops);
  * ``bytes_per_device``: every op's tensor inputs and outputs, once each
    (``Traffic``): the traffic of the port's eager, unfused ops, views and
    empty allocations moving nothing;
  * ``argument_size_in_bytes``: the rank's parameter blocks, its optimizer
    state (train) or decode states (decode), and its rows of the batch,
    also apart (``params_bytes``, ``opt_bytes``, ``state_bytes``,
    ``batch_bytes``); ``output_size_in_bytes``: the step's outputs (a train
    step's updated parameters and moments are its arguments, in place);
  * ``temp_size_in_bytes`` and ``peak_memory_in_bytes`` as an estimate
    (``"memory_estimate": true``): the peak of the live storages the step
    makes, and that plus the arguments.  It leaves out the allocator's
    rounding and caching, the CUDA context and library workspaces, and
    whatever a kernel allocates out of PyTorch's sight;
  * ``collectives`` in JAX's form (``jax_collectives``): bytes by kind as
    the results of the calls (an all-gather's whole result, a
    reduce-scatter's block), an all-reduce counted twice (a ring moves
    about twice its payload), ``_count_<kind>`` and ``total_bytes``; and
    ``collectives_by_kind``, the recording mesh's own "{kind}/{pass}"
    calls and bytes sent, a real ``ModelMesh``'s call for call;
  * ``trace_s``, the seconds of the traced step, where JAX has
    ``compile_s``; JAX's ``hlo_chars`` and
    ``generated_code_size_in_bytes`` have no counterpart;
  * ``model_flops`` (train): ``train_flops``'s count of the global step.

The port's Python loops run every layer, chunk and time step, so a
``full`` record's FLOPs are exact (JAX counts a scanned body once and
needs the unit probes).  xlstm's sLSTM loops once a token: where a cell's
sequence is longer than ``SLSTM_STEPS[1]``, its train and prefill traces
run each sLSTM over ``SLSTM_STEPS`` steps and extrapolate every count
linearly to the sequence (``"slstm_steps_scaled"``): exact for the
FLOPs, bytes and collectives, which are linear in the steps; the peak
extrapolated so is a lower bound (``"peak_is_lower_bound"``), and such
a cell's ``fits_card`` is False where it exceeds the card, else None.

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
        --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out \\
        artifacts/dryrun_torch
    REPRO_MESH=2,2 python -m repro_torch.launch.dryrun --arch \\
        h2o-danube-1.8b --shape decode_32k     # a test-scale mesh

It needs no card and never looks for one: it is no fallback of the
entry points, which still run on the card.  This module also keeps the
card's rates and the counts that bound a step (``HBM_RATE``,
``BF16_RATE``, ``decode_bound``, ``train_flops``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, OptimConfig, ServeConfig, cells, \
    get_config
from repro_torch.distributed import sharding, steps
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.mesh import make_production_mesh, recording_mesh
from repro_torch.models import model, moe, transformer, xlstm

# The card the port targets, the H100 SXM (NVIDIA data sheet): its memory
# rate in bytes/s, its dense bf16 tensor-core rate in FLOP/s, and its
# memory in bytes (the data sheet's 80 GB)
HBM_RATE = 3.35e12
BF16_RATE = 989e12
CARD_BYTES = 80e9

WHISPER_DECODE_ENC_FRAMES = 1504  # 30 s of audio (whisper frame rate), padded

# per-arch training-regime overrides (memory fit; the JAX dry-run's)
TRAIN_OVERRIDES = {
    "llama4-maverick-400b-a17b": dict(param_dtype="bfloat16"),
    "jamba-v0.1-52b": dict(param_dtype="bfloat16"),
}
OPTIM_OVERRIDES = {
    "llama4-maverick-400b-a17b": OptimConfig(state_dtype="bfloat16"),
    "jamba-v0.1-52b": OptimConfig(state_dtype="bfloat16"),
}
# the sLSTM steps a long train or prefill trace runs, extrapolated to S
SLSTM_STEPS = (8, 16)
JAX_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


# ---------------------------------------------------------------------------
# The card's bounds of a step
# ---------------------------------------------------------------------------

def decode_bound(cfg, kw):
    """(bound ms, weight bytes, KV bytes, recurrent state bytes) of one
    decode step of ``serve(cfg, **kw)``: every weight read once as stored,
    every attention layer's KV pools once (the gather path reads whole
    block tables), every recurrent state read and written once (a mamba
    layer's conv and SSM states, an mLSTM's float32 (C, n, m), an sLSTM's
    (c, n, h, m)); against the operations of 2 x batch x the parameters
    plus an mLSTM step's state products (k v^T, q C: 4 dh^2 a head) at the
    bf16 rate."""
    meta = model.Model(cfg, "meta")
    n_params = sum(p.numel() for p in meta.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in meta.parameters())
    B, pt = kw["batch"], kw["page_tokens"]
    n_pages = kw["horizon"] // pt
    kinds = [transformer.layer_kind(cfg, i) for i in range(cfg.num_layers)]
    H, dh = cfg.num_heads, cfg.head_dim
    kv_bytes = 2 * kinds.count("attn") * B * n_pages * pt \
        * cfg.num_kv_heads * cfg.head_dim * 4
    state_bytes = 2 * B * (
        kinds.count("mamba") * cfg.d_inner * (
            cfg.ssm_state_dim * 4 + (cfg.ssm_conv_width - 1) * 2)
        + kinds.count("mlstm") * H * (dh * dh + dh + 1) * 4
        + kinds.count("slstm") * 4 * H * dh * 4)
    ops = 2 * B * n_params + kinds.count("mlstm") * B * H * 4 * dh * dh
    bound_ms = max((w_bytes + kv_bytes + state_bytes) / HBM_RATE,
                   ops / BF16_RATE) * 1e3
    return bound_ms, w_bytes, kv_bytes, state_bytes


def train_flops(cfg, B, S):
    """(matmul FLOPs of one remat train step, attention and mLSTM FLOPs,
    parameters, active parameters): 8 x the parameters of every matmul
    (forward, its recompute, and a backward of twice the forward) x the
    tokens it takes, plus 4 passes of QK^T and PV on each attention layer
    (causal: the scores at or below the diagonal, inside the window; an
    encoder layer: all S^2; a cross-attention: S_dec x S_enc) and of each
    mLSTM chunk's products (QK^T and the decayed PV over the chunk, q C and
    the state update k^T v: 4 L dh + 4 dh^2 a token and head).  A dense
    matmul, the router and a shared expert take every token; a routed
    expert's weights take the C capacity-padded rows of its buffer (T k cf
    / E tokens), which it computes whether a pair fills them or not.
    Encdec: S frames and min(512, S) decoder tokens; the encoder's weights
    and the cross K/V projections take the frames, the rest the decoder
    tokens, the tied embedding the logits.  The embedding (a gather),
    mamba's depthwise conv and A_log, and the norm scales and gate biases
    are not matmuls."""
    meta = model.Model(cfg, "meta")
    n_params = sum(p.numel() for p in meta.parameters())
    Sd = min(512, S) if cfg.is_encoder_decoder else S
    T, Td = B * S, B * Sd
    C = moe._capacity(cfg, T) if cfg.num_experts else 0
    mm = 0
    for n, p in meta.named_parameters():
        leaf = n.split(".")[-1]
        if n == "embed" and cfg.tie_embeddings:
            mm += 8 * p.numel() * Td                 # the logits
            continue
        if p.dim() < 2 or n == "embed" or \
                leaf in ("conv_w", "A_log", "gn_scale", "bg"):
            continue
        routed = ".ffn_moe." in n and ".shared." not in n and \
            leaf != "router"
        frames = n.startswith("encoder.") or ".cross.wk" in n or \
            ".cross.wv" in n
        mm += 8 * p.numel() * (C if routed else T if frames else Td)
    per_pair = 4 * 2 * 2 * B * cfg.num_heads * cfg.head_dim
    kinds = [transformer.layer_kind(cfg, i) for i in range(cfg.num_layers)]
    w = min(cfg.sliding_window or Sd, Sd)
    pairs = sum(min(i + 1, w) for i in range(Sd)) * kinds.count("attn")
    if cfg.is_encoder_decoder:
        pairs += cfg.num_encoder_layers * S * S + cfg.num_layers * Sd * S
    L, dh = min(cfg.mlstm_chunk, S), cfg.head_dim
    mlstm = 4 * kinds.count("mlstm") * T * cfg.num_heads * (
        4 * L * dh + 4 * dh * dh)
    return mm, per_pair * pairs + mlstm, n_params, \
        model.count_params(cfg, active_only=True)


# ---------------------------------------------------------------------------
# Counting a traced step
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    """The tensors of ``tree``: a tensor, a module's parameters, or dicts,
    lists and tuples of them."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for v in tree for t in _tensors(v)]


def nbytes(tree) -> int:
    """The bytes of every tensor in ``tree`` (as ``_tensors``), a tensor
    that appears twice once."""
    seen, n = set(), 0
    for t in _tensors(tree):
        key = (t.untyped_storage()._cdata, t.storage_offset(), t.shape)
        if key not in seen:
            seen.add(key)
            n += t.numel() * t.element_size()
    return n


def _moves_nothing(func) -> bool:
    """A view, a query of a tensor's metadata (the ``prim`` ops), or an
    allocation that writes nothing."""
    ns, _, name = func.name().partition("::")
    return func.is_view or ns != "aten" or name.split(".")[0] in (
        "empty", "empty_like", "new_empty", "empty_strided",
        "new_empty_strided", "_unsafe_view", "detach", "lift_fresh", "alias")


class Traffic(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts, for the ops run inside it, the bytes of every tensor input
    and output (``bytes``: the traffic of eager, unfused ops), and the
    storages the ops make: those alive now (``live``) and the most alive
    at once (``peak``).  A storage is the ops' own when no input of the op
    that made it shares it (an in-place op or a view makes none)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs = {}

    def _drop(self, key, n):
        self.live -= n
        self._refs.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not _moves_nothing(func):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        mine = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in mine or key in self._refs:
                continue
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._refs[key] = weakref.ref(
                st, lambda _, key=key, n=n: self._drop(key, n))
        return out


@dataclass
class Counts:
    """What one traced step counted (``count``)."""

    flops: float = 0.0
    bytes: float = 0.0
    temp: float = 0.0
    by_kind: dict = field(default_factory=dict)
    results: dict = field(default_factory=dict)
    seconds: float = 0.0


@contextmanager
def count(mesh):
    """Count the ops run inside the block: FLOPs, traffic, the peak of the
    storages they make, and ``mesh``'s collectives (a ``RecordingMesh``,
    counted from zero; None: none).  Yields the ``Counts``, filled at the
    end of the block."""
    from torch.utils.flop_counter import FlopCounterMode
    c = Counts()
    if mesh is not None:
        mesh.reset()
    fc, tr = FlopCounterMode(display=False), Traffic()
    t0 = time.perf_counter()
    with fc, tr:
        yield c
    c.seconds = time.perf_counter() - t0
    c.flops, c.bytes, c.temp = float(fc.get_total_flops()), float(tr.bytes), \
        float(tr.peak)
    if mesh is not None:
        c.by_kind = {k: dict(v) for k, v in
                     mesh.collectives["by_kind"].items()}
        c.results = {k: dict(v) for k, v in mesh.results.items()}


def _extrapolate(c1: Counts, c2: Counts, s1: int, s2: int, S: int) -> Counts:
    """The counts of S steps of a loop, from traces of s1 and s2 steps (a
    count linear in the steps; the collectives must not depend on them).
    The peak of the live storages is the largest, over the points of the
    step, of a memory linear in the steps: a convex function of them,
    which the line through two probes can only underestimate beyond
    them.  So the extrapolated ``temp`` is a lower bound."""
    if c1.by_kind != c2.by_kind or c1.results != c2.results:
        raise RuntimeError("the collectives of the sLSTM probes differ: "
                           "the loop issues collectives, so its steps "
                           "cannot be extrapolated")
    at = lambda a, b: a + (b - a) / (s2 - s1) * (S - s1)   # noqa: E731
    return Counts(flops=at(c1.flops, c2.flops), bytes=at(c1.bytes, c2.bytes),
                  temp=at(c1.temp, c2.temp), by_kind=c2.by_kind,
                  results=c2.results, seconds=c1.seconds + c2.seconds)


@contextmanager
def slstm_steps(limit):
    """Run each sLSTM layer's time loop for its first ``limit`` steps only
    (None: all), the later steps passing the carry on unchanged.  Raises
    at the end of the block unless some loop ran and every loop ran
    exactly ``limit`` steps (a limit that did not take would count the
    wrong steps)."""
    if limit is None:
        yield
        return
    apply, cell = xlstm.apply_slstm, xlstm._slstm_cell
    ran = []                                   # the steps each loop ran

    def apply_slstm(*a, **kw):
        ran.append(0)
        return apply(*a, **kw)

    def slstm_cell(r, bg, carry, gx):
        if ran[-1] >= limit:
            return carry
        ran[-1] += 1
        return cell(r, bg, carry, gx)
    xlstm.apply_slstm, xlstm._slstm_cell = apply_slstm, slstm_cell
    try:
        yield
    finally:
        xlstm.apply_slstm, xlstm._slstm_cell = apply, cell
    if not ran or any(n != limit for n in ran):
        raise RuntimeError(f"the sLSTM limit of {limit} steps did not "
                           f"take: the loops ran {ran} steps")


def jax_collectives(results: dict) -> dict:
    """JAX's ``parse_collectives`` form of a ``RecordingMesh``'s
    ``results``: bytes by kind (JAX's names) as the calls' results, an
    all-reduce counted twice, ``_count_<kind>`` and ``total_bytes``."""
    out = {}
    for kind, r in sorted(results.items()):
        name = JAX_KINDS[kind]
        out[name] = r["bytes"] * (2.0 if kind == "all_reduce" else 1.0)
        out["_count_" + name] = r["calls"]
    out["total_bytes"] = sum(v for k, v in out.items()
                             if not k.startswith("_"))
    return out


# ---------------------------------------------------------------------------
# Tracing one rank's step
# ---------------------------------------------------------------------------

@dataclass
class Traced:
    """One rank's traced step: its counts and its memory."""

    counts: Counts
    args: dict                      # {"params", "opt", "state", "batch"}
    output_bytes: int
    meta: dict = field(default_factory=dict)


def _inputs(specs: dict) -> dict:
    """``model.input_specs``' meta tensors as fake ones (inside the mode)."""
    return {k: torch.empty(v.shape, dtype=v.dtype) for k, v in specs.items()}


def _params(cfg, mesh):
    """The rank's parameter blocks (``mesh`` None: the whole model), drawn
    from seed 0 (inside the mode)."""
    if mesh is None:
        return model.init_params(cfg, 0, "cpu")
    return model.init_params_sharded(cfg, 0, mesh)


def _rows(batch: dict, mesh) -> int:
    """The bytes of ``mesh``'s rank's rows of a train or prefill batch."""
    if mesh is None:
        return nbytes(batch)
    B = next(iter(batch.values())).shape[0]
    entry = sharding.batch_spec(mesh, B)
    n = mesh.size(entry) if entry else 1
    return nbytes(batch) // n


def trace_train(cfg, oc, shape, mesh=None, *, seq_shard: bool = True,
                grad_compression: str = "none", slstm=None) -> Traced:
    """One rank's ``build_train_step`` (the loss, its gradient, AdamW) on
    the whole batch of ``shape``, from ``init_train_state``'s blocks, on
    fake tensors; ``mesh`` a ``RecordingMesh`` or None (one device);
    ``slstm`` as ``slstm_steps``."""
    with FakeTensorMode():
        params, opt = steps.init_train_state(cfg, oc, mesh, device="cpu")
        step = steps.build_train_step(cfg, oc, mesh, seq_shard=seq_shard,
                                      grad_compression=grad_compression)
        batch = _inputs(model.input_specs(cfg, shape))
        args = {"params": nbytes(params), "opt": nbytes(opt), "state": 0,
                "batch": _rows(batch, mesh)}
        with slstm_steps(slstm), count(mesh) as c:
            out = step(params, opt, batch)
        return Traced(c, args, nbytes(out))


def trace_prefill(cfg, shape, mesh=None, slstm=None) -> Traced:
    """One rank's forward trunk and the last position's logits (its
    vocabulary block), without autograd, on fake tensors; over a mesh
    with ``ShardCtx(mesh, seq_shard=True)``, where the last position is
    the last ``"model"`` block's last row (gathered, one row a rank)."""
    with FakeTensorMode(), torch.no_grad():
        params = _params(cfg, mesh)
        batch = _inputs(model.input_specs(cfg, shape))
        args = {"params": nbytes(params), "opt": 0, "state": 0,
                "batch": _rows(batch, mesh)}
        B = next(iter(batch.values())).shape[0]
        with slstm_steps(slstm), count(mesh) as c:
            if mesh is None:
                x, _ = model.forward(params, cfg, batch)
            else:
                ctx = sharding.ShardCtx(mesh, seq_shard=True).bind(
                    B, batch["labels"].shape[1])
                x, _ = model.forward(params, cfg, ctx.local_batch(batch),
                                     shard_ctx=ctx)
                if ctx.seq:
                    x = tp.all_gather(x[:, -1:], mesh, ("model",), 1)
            out = model.logits_fn(params, cfg, x[:, -1:])
        return Traced(c, args, nbytes(out))


def trace_decode(cfg, serve_cfg, mesh=None, *, kv_dtype=torch.bfloat16,
                 full_logits: bool = False) -> Traced:
    """One rank's ``build_serve_step`` step on its rows (``full_logits``
    False as ``serve`` calls it), from its parameter blocks and
    ``init_decode_states`` (an encdec model's encoder run on
    ``WHISPER_DECODE_ENC_FRAMES`` stub frames, outside the count), on fake
    tensors."""
    step, ctx = steps.build_serve_step(cfg, serve_cfg, mesh)
    B = serve_cfg.shape.global_batch
    rows = ctx.local_batch(B)
    b = rows.stop - rows.start
    with FakeTensorMode():
        params = _params(cfg, mesh)
        kw = {}
        if cfg.is_encoder_decoder:
            kw["enc_frames"] = torch.empty(
                (b, WHISPER_DECODE_ENC_FRAMES, cfg.d_model),
                dtype=torch.bfloat16)
        states = model.init_decode_states(params, cfg, b, ctx,
                                          kv_dtype=kv_dtype, **kw)
        inp = {k: v[rows] for k, v in _inputs(model.input_specs(
            cfg, serve_cfg.shape, ctx)).items()}
        args = {"params": nbytes(params), "opt": 0, "state": nbytes(states),
                "batch": nbytes(inp)}
        with count(mesh) as c:
            out = step(params, states, inp["tokens"], inp["pos"],
                       inp["block_table"], full_logits=full_logits)
        return Traced(c, args, nbytes(out),
                      {"n_pages": ctx.n_pages, "pool_pages": ctx.pool_pages})


# ---------------------------------------------------------------------------
# The cells
# ---------------------------------------------------------------------------

def _cfg_for(arch: str, shape_name: str, probe: str):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        cfg = cfg.replace(**TRAIN_OVERRIDES.get(arch, {}))
    else:
        cfg = cfg.replace(param_dtype="bfloat16")  # inference weights bf16
    if os.environ.get("REPRO_OPT"):
        # the tuned configuration: EP MoE dispatch, and the sqrt-remat
        # grouping of the mLSTM scan (a field only JAX's scan reads)
        if cfg.num_experts:
            cfg = cfg.replace(moe_impl="ep")
        if cfg.family == "ssm":
            cfg = cfg.replace(mlstm_scan_groups=8)
    if probe in ("unit1", "unit2"):
        unit = transformer.scan_unit_size(cfg)
        n = unit if probe == "unit1" else 2 * unit
        # scan_layers, inner_unroll and mlstm_unroll steer only JAX's
        # scans; kept as JAX sets them
        kw = dict(num_layers=n, scan_layers=False, inner_unroll=True)
        if cfg.is_encoder_decoder:
            kw["num_encoder_layers"] = 1 if probe == "unit1" else 2
        if shape.kind in ("train", "prefill"):
            kw["mamba_chunk"] = min(max(shape.seq_len // 8, 64), 2048)
        if cfg.family == "ssm":
            kw["mlstm_unroll"] = False
        cfg = cfg.replace(**kw)
    return cfg, shape


def _slstm_limits(cfg, shape):
    """The sLSTM steps of the two probes of a long train or prefill cell,
    or None: trace every step."""
    if cfg.slstm_every and shape.kind in ("train", "prefill") and \
            shape.seq_len > SLSTM_STEPS[1]:
        return SLSTM_STEPS
    return None


def trace_cell(arch: str, shape_name: str, mesh, probe: str = "full"):
    """Trace one cell on one rank of ``mesh`` (a ``RecordingMesh``):
    returns (``Traced``, meta), as JAX's ``lower_cell`` returns its
    compiled program."""
    cfg, shape = _cfg_for(arch, shape_name, probe)
    meta = {"arch": arch, "shape": shape_name, "probe": probe,
            "num_layers": cfg.num_layers, "mesh": dict(mesh.shape)}
    limits = _slstm_limits(cfg, shape)
    if shape.kind == "decode":
        traced = trace_decode(cfg, ServeConfig(model=cfg, shape=shape), mesh)
        meta.update(traced.meta)
        return traced, meta
    if shape.kind == "train":
        oc = OPTIM_OVERRIDES.get(arch, OptimConfig())
        meta["model_flops"] = float(sum(train_flops(
            cfg, shape.global_batch, shape.seq_len)[:2]))

        def run(limit):
            return trace_train(cfg, oc, shape, mesh, slstm=limit)
    else:
        def run(limit):
            return trace_prefill(cfg, shape, mesh, slstm=limit)
    if limits is None:
        return run(None), meta
    t1, t2 = run(limits[0]), run(limits[1])
    t2.counts = _extrapolate(t1.counts, t2.counts, *limits, shape.seq_len)
    meta["slstm_steps_scaled"] = [list(limits), shape.seq_len]
    return t2, meta


def analyze(traced: Traced, meta) -> dict:
    """The record of a traced cell (JAX's ``analyze`` keys where the port
    has a counterpart; the module's docstring says which)."""
    c, a = traced.counts, traced.args
    rec = dict(meta)
    rec["flops_per_device"] = c.flops
    rec["bytes_per_device"] = c.bytes
    arg = sum(a.values())
    rec.update({f"{k}_bytes": v for k, v in a.items()})
    rec["argument_size_in_bytes"] = arg
    rec["output_size_in_bytes"] = traced.output_bytes
    rec["temp_size_in_bytes"] = int(c.temp)
    rec["peak_memory_in_bytes"] = int(arg + c.temp)
    rec["memory_estimate"] = True
    fits = arg + c.temp <= CARD_BYTES
    if "slstm_steps_scaled" in meta:
        # an extrapolated peak is a lower bound (``_extrapolate``): it
        # shows a cell too large, never one that fits
        rec["peak_is_lower_bound"] = True
        fits = None if fits else False
    rec["fits_card"] = fits
    rec["collectives"] = jax_collectives(c.results)
    rec["collectives_by_kind"] = c.by_kind
    rec["trace_s"] = c.seconds
    return rec


def _mesh_for(mesh_kind: str):
    """The production mesh's rank 0, or a test-scale mesh through
    ``REPRO_MESH=d,m`` (the multi-pod one adds a pod axis of 2)."""
    ov = os.environ.get("REPRO_MESH")
    if ov:
        d, m = (int(x) for x in ov.split(","))
        shape = {"data": d, "model": m}
        if mesh_kind == "multi":
            shape = {"pod": 2, **shape}
        return recording_mesh(shape)
    return recording_mesh(make_production_mesh(
        multi_pod=(mesh_kind == "multi")))


def report_name(arch, shape_name, mesh_kind, probe) -> str:
    """Canonical per-cell report filename (tests import this — keep in sync)."""
    return f"{arch}__{shape_name}__{mesh_kind}__{probe}.json"


def run_cell(arch, shape_name, mesh_kind, probe, out_dir: Path):
    name = report_name(arch, shape_name, mesh_kind, probe)
    out = out_dir / name
    if out.exists():
        print(f"[skip] {name}")
        return json.loads(out.read_text())
    t0 = time.time()
    try:
        mesh = _mesh_for(mesh_kind)
        traced, meta = trace_cell(arch, shape_name, mesh, probe)
        rec = analyze(traced, meta)
        rec["ok"] = True
        del traced
    except Exception as e:       # the cell's record says why it failed
        rec = {"arch": arch, "shape": shape_name, "probe": probe,
               "mesh_kind": mesh_kind, "ok": False, "error": repr(e)[:2000]}
    rec["wall_s"] = time.time() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    status = "ok" if rec.get("ok") else "FAIL"
    print(f"[{status}] {name}  wall={rec['wall_s']:.1f}s "
          f"flops/dev={rec.get('flops_per_device', 0):.3e} "
          f"coll={rec.get('collectives', {}).get('total_bytes', 0):.3e}B",
          flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--probe", default="full",
                    choices=["full", "unit1", "unit2", "all"])
    ap.add_argument("--all", action="store_true", help="all assigned cells")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args()

    out_dir = Path(args.out)
    todo = cells() if args.all else [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    probes = ["full", "unit1", "unit2"] if args.probe == "all" \
        else [args.probe]

    failures = 0
    jobs = []
    for pr in probes:                      # all 'full' cells first
        for arch, shape_name in todo:
            for mk in meshes:
                if pr != "full" and mk == "multi":
                    continue  # cost probes are single-pod
                jobs.append((arch, shape_name, mk, pr))
    for arch, shape_name, mk, pr in jobs:
        rec = run_cell(arch, shape_name, mk, pr, out_dir)
        failures += 0 if rec.get("ok") else 1
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
