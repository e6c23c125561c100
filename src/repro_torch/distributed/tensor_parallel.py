"""Tensor parallelism over a ``ModelMesh``: the collectives GSPMD adds for
JAX where ``param_specs`` shards a leaf, for decode and for training.

A rank's parameters are the blocks of ``sharding.param_specs`` (each
tensor carries its spec as ``.spec``, ``model.shard_params``).  At use:

  * a dimension on a batch axis (``"embed"`` on ``"data"``: fully sharded
    data parallelism) is all-gathered over that axis, every such leaf of a
    module in one packed collective (``view``);
  * a dimension on ``"model"`` stays local: the heads of ``wq``, ``wk``,
    ``wv`` and the columns of ``gate``/``up`` are column-parallel, so ``q``,
    ``k`` and ``v`` come out with the rank's heads (decode all-gathers them
    by head in one packed collective, ``gather_heads``; training attends
    over the rank's heads); ``wo`` and ``down`` are row-parallel: their
    input is cut to the rank's block (``narrow_to``) and the partial
    products summed (``reduce_partial``; in training ``leave_tp``); the
    embedding is a vocab-parallel masked lookup and a sum
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

Training differentiates through the collectives.  Each has an autograd
function whose backward is its conjugate: all-gather and reduce-scatter,
all-reduce and all-reduce, all-to-all and the reverse all-to-all.  The
gradients follow one convention, the partial one: every rank's backward
starts from its share of the loss (the loss over the number of ranks that
compute the same value, ``share``), so the gradient a rank holds of any
tensor is its part of the whole, and the whole is the sum over the ranks
that hold the tensor.  A column-parallel product then needs no collective
on its input (the parts of the input's gradient are summed where the input
was gathered or reduced), and ``reduce_grads`` sums each parameter's
gradient over the axes its spec replicates it on.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import entry_axes

F32 = torch.float32
TP_AXES = ("model",)


# ---------------------------------------------------------------------------
# Collectives with a backward
# ---------------------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_reduce(x.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axes, backward=True), \
            None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axes, ctx.dim,
                                       backward=True), None, None, None


class _AllGatherAs(torch.autograd.Function):
    """All-gather ``x`` cast to ``dtype``; the backward reduce-scatters the
    gradient in ``x``'s dtype (the cast's backward, then the gather's)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, dtype):
        ctx.mesh, ctx.axes, ctx.dim, ctx.dt = mesh, axes, dim, x.dtype
        return mesh.all_gather(x.to(dtype), axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g.to(ctx.dt), ctx.axes, ctx.dim,
                                       backward=True), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.reduce_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axes, ctx.dim, backward=True), \
            None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_to_all(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g, ctx.axes, backward=True), None, None


class _Share(torch.autograd.Function):
    """The sum over ``axes`` of a value that ``n`` ranks compute alike;
    its backward starts each of them from 1/n."""

    @staticmethod
    def forward(ctx, x, mesh, axes, n):
        ctx.n = n
        return mesh.all_reduce(x.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None, None


def _grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce(x, mesh, axes):
    """``x`` summed over ``axes``; differentiable (the backward sums the
    parts of the gradient over the same ranks)."""
    if mesh.size(axes) == 1:
        return x
    if _grad(x):
        return _AllReduce.apply(x, mesh, tuple(axes))
    return mesh.all_reduce(x, axes)


def all_gather(x, mesh, axes, dim: int = 0):
    """``x`` joined over ``axes`` on ``dim``; the backward reduce-scatters."""
    if mesh.size(axes) == 1:
        return x
    if _grad(x):
        return _AllGather.apply(x, mesh, tuple(axes), dim)
    return mesh.all_gather(x, axes, dim)


def reduce_scatter(x, mesh, axes, dim: int = 0):
    """``x`` summed over ``axes``, this rank's block on ``dim``; the
    backward all-gathers."""
    if mesh.size(axes) == 1:
        return x
    if _grad(x):
        return _ReduceScatter.apply(x, mesh, tuple(axes), dim)
    return mesh.reduce_scatter(x, axes, dim)


def all_to_all(x, mesh, axes):
    """``mesh.all_to_all``; the backward is the reverse all-to-all."""
    if mesh.size(axes) == 1:
        return x
    if _grad(x):
        return _AllToAll.apply(x, mesh, tuple(axes))
    return mesh.all_to_all(x, axes)


def share(x, mesh, axes, n: int):
    """The loss term ``x`` summed over ``axes`` (nothing to sum where
    ``axes`` is empty), where each value is computed alike by ``n`` ranks:
    its backward seeds each of them with 1/n, the partial convention."""
    return _Share.apply(x, mesh, tuple(axes), n)


def spec_of(w) -> tuple:
    return getattr(w, "spec", ())


def _tp(w, dim: int, mesh) -> bool:
    """Whether ``w``'s dimension ``dim`` is split over ``"model"`` (of more
    than one rank)."""
    spec = spec_of(w)
    dim = dim % w.dim()
    return dim < len(spec) and entry_axes(spec[dim]) == TP_AXES \
        and mesh.size(TP_AXES) > 1


def _gather_dims(full: dict, mesh, todo: dict, dtype=None):
    """All-gather ``full[name]``'s dimension ``d`` over ``axes`` for every
    ``(axes, dtype): [(name, d)]`` of ``todo``, one packed (differentiable)
    collective per key, cast to ``dtype`` first where one is given; each
    gathered tensor's spec entry becomes None."""
    for (axes, _), items in todo.items():
        n = mesh.size(axes)
        flat = torch.cat([full[name].reshape(-1) for name, _ in items])
        if dtype is not None and dtype != flat.dtype:
            parts = _AllGatherAs.apply(flat, mesh, tuple(axes), 0,
                                       dtype).view(n, -1)
        else:
            parts = all_gather(flat, mesh, axes).view(n, -1)
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


def gather_sharded(named: dict, mesh, keep=lambda name, d, axes: False,
                   dtype=None):
    """{name: tensor} with every dimension on a mesh axis (of more than one
    rank) all-gathered, but those ``keep(name, dim, axes)`` holds: one
    packed collective per axis set and dtype, the batch axes first.  With
    ``dtype`` the tensors are gathered cast to it (a consumer that casts
    them anyway gets the same values from half the bytes; the gradient
    comes back in the tensors' own dtype)."""
    full = dict(named)
    for tp_round in (False, True):
        todo: dict = {}
        for name, w in full.items():
            for d, e in enumerate(spec_of(w)):
                axes = entry_axes(e)
                if axes and (axes == TP_AXES) == tp_round and \
                        mesh.size(axes) > 1 and not keep(name, d, axes):
                    todo.setdefault((axes, w.dtype), []).append((name, d))
        _gather_dims(full, mesh, todo, dtype)
    return full


def _tree(full: dict) -> SimpleNamespace:
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


def view(module, mesh, recurse: bool = True, *, tp: bool = False,
         skip: tuple = ()) -> SimpleNamespace:
    """``module``'s leaves as a namespace of the same tree (``v.attn.wq``),
    each dimension on a batch axis all-gathered over it: one packed
    ``all_gather`` per axis set and dtype.  Dimensions on ``"model"`` stay
    local unless ``tp``; each tensor keeps its spec, the gathered entries
    None.  Leaves under a child named in ``skip`` are left out.
    Differentiable: the gathers' backward reduce-scatters."""
    named = {n: w for n, w in module.named_parameters(recurse=recurse)
             if n.split(".")[0] not in skip}
    return _tree(gather_sharded(
        named, mesh, keep=lambda n, d, axes: axes == TP_AXES and not tp))


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


def narrow_to(x, dim: int, w, w_dim: int, mesh, unit: int = 1):
    """``x`` (whole along ``dim``) cut to the rank's block where ``w``'s
    dimension ``w_dim`` is on ``"model"``: the input of a row-parallel
    product.  ``unit`` elements of ``x`` stand for one of ``w`` (a head's
    channels)."""
    if not _tp(w, w_dim, mesh):
        return x
    n = w.shape[w_dim] * unit
    return x.narrow(dim, mesh.index(TP_AXES) * n, n)


def reduce_partial(y, w, w_dim: int, mesh):
    """The partial product ``y`` of a row-parallel weight ``w`` (its
    contracting dimension ``w_dim`` on ``"model"``) summed over the ranks
    in float32 and rounded once to ``y``'s dtype; ``y`` itself on one
    device (``mesh`` None) or where ``w`` is not row-parallel."""
    if mesh is None or not _tp(w, w_dim, mesh):
        return y
    return all_reduce(y.to(F32), mesh, TP_AXES).to(y.dtype)


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
    return all_reduce(rows, mesh, TP_AXES).to(table.dtype)


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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def kv_for_local_heads(cfg, k, v, wq, wk, mesh):
    """k, v (B,S,K,hd) made to meet this rank's query heads where ``wq``'s
    heads are on ``"model"`` and ``wk``'s are not (2 KV heads on 4 ranks):
    query head h attends KV head h // (H / K), so the rank keeps the run of
    KV heads its heads [m H/M, (m+1) H/M) use.  Every arch's groups line
    up with the rank's heads (a whole number of groups a rank, or of
    ranks a group)."""
    if not _tp(wq, 1, mesh) or _tp(wk, 1, mesh):
        return k, v
    G = cfg.num_heads // cfg.num_kv_heads
    hl = wq.shape[1]
    if hl % G and G % hl:
        raise NotImplementedError(f"{hl} query heads a rank straddle KV "
                                  f"groups of {G} unevenly")
    a = mesh.index(TP_AXES) * hl
    lo, hi = a // G, (a + hl - 1) // G + 1
    return k[:, :, lo:hi], v[:, :, lo:hi]


def replicated_axes(w, mesh) -> tuple:
    """The mesh axes (of more than one rank) ``w``'s spec does not shard
    it on."""
    used = {a for e in spec_of(w) for a in entry_axes(e)}
    return tuple(a for a in mesh.shape if a not in used and mesh.shape[a] > 1)


def reduce_grads(mesh, params: dict, grads: dict) -> dict:
    """Each parameter's gradient (its parts, the partial convention) summed
    over the axes its spec replicates it on: one packed all-reduce per axis
    set and dtype.  A dimension gathered in the forward pass was summed by
    the gather's reduce-scatter already."""
    todo: dict = {}
    for n, w in params.items():
        axes = replicated_axes(w, mesh)
        if axes:
            todo.setdefault((axes, grads[n].dtype), []).append(n)
    out = dict(grads)
    for (axes, _), names in todo.items():
        flat = mesh.all_reduce(torch.cat([grads[n].reshape(-1)
                                          for n in names]), axes)
        at = 0
        for n in names:
            k = grads[n].numel()
            out[n] = flat[at:at + k].view_as(grads[n])
            at += k
    return out


def first_replica(w, mesh) -> bool:
    """Whether this rank is the first of the ranks holding ``w``'s block
    (index 0 on every axis its spec replicates it on)."""
    return all(mesh.coords[a] == 0 for a in replicated_axes(w, mesh))


def vocab_ce_chunk(hx, lx, head, mesh, v0):
    """One chunk's (loss sum, token count) with ``head`` (V_loc, d) this
    rank's vocabulary block from row ``v0``: each rank's (max, sum of
    exponentials, gold logit) over its block, all-gathered over
    ``"model"``; the log-sum-exp over the whole padded vocabulary and the
    gold logit from them.  hx (B,c,d) float32, lx (B,c), -100 = pad."""
    logits = hx @ head.T                                       # (B,c,V_loc)
    m = logits.amax(-1).detach()
    s = torch.exp(logits - m[..., None]).sum(-1)
    lbl = lx.to(torch.int64) - v0
    inside = (lbl >= 0) & (lbl < head.shape[0])
    lbl = lbl.clamp(0, head.shape[0] - 1)
    gold = torch.gather(logits, -1, lbl[..., None])[..., 0] * inside
    parts = all_gather(torch.stack([m, s, gold])[None], mesh, TP_AXES)
    mr = parts[:, 0].detach()
    mm = mr.amax(0)
    lse = mm + torch.log((parts[:, 1] * torch.exp(mr - mm)).sum(0))
    mask = lx >= 0
    loss = torch.where(mask, lse - parts[:, 2].sum(0), 0.0)
    return loss.sum(), mask.sum().to(F32)
