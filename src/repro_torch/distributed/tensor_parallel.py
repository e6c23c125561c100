"""Tensor-parallel decode over a ``ModelMesh``: the collectives GSPMD adds
for JAX where ``param_specs`` shards a dense leaf.

A rank's parameters are the blocks of ``sharding.param_specs`` (each
tensor carries its spec as ``.spec``, ``model.shard_params``).  At use:

  * a dimension on a batch axis (``"embed"`` on ``"data"``: fully sharded
    data parallelism) is all-gathered over that axis, every such leaf of a
    module in one packed collective (``view``);
  * a dimension on ``"model"`` stays local: the heads of ``wq``, ``wk``,
    ``wv`` and the columns of ``gate``/``up`` are column-parallel, so ``q``,
    ``k`` and ``v`` come out with the rank's heads and are all-gathered by
    head in one packed collective (``gather_heads``); ``wo`` and ``down``
    are row-parallel: their input is cut to the rank's block
    (``narrow_to``) and the partial products summed (``reduce_partial``);
    the embedding is a vocab-parallel masked lookup and a sum
    (``embed_lookup``); the logits stay vocab-sharded, and the greedy token
    is the first index of the largest logit over the whole padded
    vocabulary (``greedy``), as ``jnp.argmax`` picks it;
  * a dimension the rules replicate (2 KV heads on a 4-way ``"model"``
    axis) is used whole.

Row-parallel partial sums are added in float32 and rounded once to the
activation dtype: in float32 the result equals the one-card product up to
the order of the additions; in bfloat16 each rank's partial product is
rounded to bfloat16 before the sum, where one card rounds the whole sum
once.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import entry_axes

F32 = torch.float32
TP_AXES = ("model",)


def spec_of(w) -> tuple:
    return getattr(w, "spec", ())


def _tp(w, dim: int, mesh) -> bool:
    """Whether ``w``'s dimension ``dim`` is split over ``"model"`` (of more
    than one rank)."""
    spec = spec_of(w)
    dim = dim % w.dim()
    return dim < len(spec) and entry_axes(spec[dim]) == TP_AXES \
        and mesh.size(TP_AXES) > 1


def view(module, mesh, recurse: bool = True) -> SimpleNamespace:
    """``module``'s leaves as a namespace of the same tree (``v.attn.wq``),
    each dimension on a batch axis all-gathered over it: one packed
    ``all_gather`` per axis set and dtype.  Dimensions on ``"model"`` stay
    local; each tensor keeps its spec, the gathered entries None."""
    full = dict(module.named_parameters(recurse=recurse))
    todo: dict = {}
    for name, w in full.items():
        for d, e in enumerate(spec_of(w)):
            axes = entry_axes(e)
            if axes and axes != TP_AXES and mesh.size(axes) > 1:
                todo.setdefault((axes, w.dtype), []).append((name, d))
    for (axes, _), items in todo.items():
        n = mesh.size(axes)
        flat = torch.cat([full[name].reshape(-1) for name, _ in items])
        parts = mesh.all_gather(flat, axes).view(n, -1)
        at = 0
        for name, d in items:
            w = full[name]
            k = w.numel()
            t = torch.cat([parts[r, at:at + k].view(w.shape)
                           for r in range(n)], dim=d)
            t.spec = tuple(None if i == d else e
                           for i, e in enumerate(spec_of(w)))
            full[name] = t
            at += k
    root = SimpleNamespace()
    for name, t in full.items():
        node = root
        *heads, last = name.split(".")
        for h in heads:
            if not hasattr(node, h):
                setattr(node, h, SimpleNamespace())
            node = getattr(node, h)
        setattr(node, last, t)
    return root


def gather_heads(mesh, pairs):
    """[(x (B,S,n,hd), w)]: each ``x`` whose weight ``w`` has its heads
    (dimension 1) on ``"model"`` holds the rank's heads; all of them are
    all-gathered by head in one packed collective and come back whole, in
    the order given."""
    need = [i for i, (_, w) in enumerate(pairs) if _tp(w, 1, mesh)]
    out = [x for x, _ in pairs]
    if not need:
        return out
    n = mesh.size(TP_AXES)
    B, S = out[need[0]].shape[:2]
    flat = torch.cat([out[i].reshape(B * S, -1) for i in need], dim=-1)
    parts = mesh.all_gather(flat, TP_AXES).view(n, B * S, -1)
    at = 0
    for i in need:
        x = out[i]
        k = x.shape[2] * x.shape[3]
        blk = parts[:, :, at:at + k].reshape(n, B, S, x.shape[2], x.shape[3])
        out[i] = blk.permute(1, 2, 0, 3, 4).reshape(B, S, -1, x.shape[3])
        at += k
    return out


def narrow_to(x, dim: int, w, w_dim: int, mesh):
    """``x`` (whole along ``dim``) cut to the rank's block where ``w``'s
    dimension ``w_dim`` is on ``"model"``: the input of a row-parallel
    product."""
    if not _tp(w, w_dim, mesh):
        return x
    n = w.shape[w_dim]
    return x.narrow(dim, mesh.index(TP_AXES) * n, n)


def reduce_partial(y, w, w_dim: int, mesh):
    """The partial product ``y`` of a row-parallel weight ``w`` (its
    contracting dimension ``w_dim`` on ``"model"``) summed over the ranks
    in float32 and rounded once to ``y``'s dtype."""
    if not _tp(w, w_dim, mesh):
        return y
    return mesh.all_reduce(y.to(F32), TP_AXES).to(y.dtype)


def embed_lookup(table, tokens, mesh):
    """The rows of ``tokens`` in ``table`` (V, d): with the vocabulary on
    ``"model"``, each rank looks up the tokens in its rows, zeros for the
    rest, and the ranks' rows are summed (one nonzero a token: exact)."""
    tokens = tokens.to(torch.int64)
    if not _tp(table, 0, mesh):
        return F.embedding(tokens, table)
    vl = table.shape[0]
    t = tokens - mesh.index(TP_AXES) * vl
    inside = (t >= 0) & (t < vl)
    rows = F.embedding(t.clamp(0, vl - 1), table).to(F32) \
        * inside[..., None]
    return mesh.all_reduce(rows, TP_AXES).to(table.dtype)


def gather_vocab(logits, head, mesh):
    """Vocab-sharded logits (..., V_local) made whole over ``"model"``."""
    if not _tp(head, 0, mesh):
        return logits
    return mesh.all_gather(logits, TP_AXES, dim=-1)


def greedy(logits, head, mesh):
    """The first index of the largest logit of each row of ``logits`` (B,
    V_local), over the whole padded vocabulary: each rank's first argmax
    with its global index, all-gathered, then the largest value and, on a
    tie, the smallest index (``jnp.argmax``)."""
    idx = torch.argmax(logits, dim=-1)
    if not _tp(head, 0, mesh):
        return idx
    val = logits.gather(-1, idx[:, None])[:, 0].to(F32)
    idx = idx + mesh.index(TP_AXES) * logits.shape[-1]
    both = mesh.all_gather(torch.stack([val, idx.to(F32)], -1)[None],
                           TP_AXES)                       # (n, B, 2)
    v, i = both[..., 0], both[..., 1]
    best = v.amax(0)
    i = torch.where(v == best, i, float("inf")).amin(0)
    return i.to(torch.int64)
