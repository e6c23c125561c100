"""Parity of the port's MoE FFN (``repro_torch.models.moe``) with the JAX
package's ``models/moe.py`` at ``smoke_config`` of olmoe-1b-7b (8 experts
top-4), jamba-v0.1-52b (8 top-2) and llama4-maverick-400b-a17b (8 top-1
and a shared expert), in float32, on the same parameters (JAX's ``init``
carried across) and inputs: learned routing, ``router_mode="hash"``, a
drop case (``capacity_factor`` 0.25) and a tie case (``x = 0``: uniform
router probabilities, where both pick experts 0..k-1).

Tolerances.  Routing indices, keep masks and ``moe_dropped`` are exact.
``y`` within 1e-5 absolute (observed <= 1.4e-6 on outputs of std ~0.5): the
expert einsums and the router differ from XLA's in summation order; the
combine adds a token's k contributions in ascending expert order, the
order of JAX's CPU scatter-add (``.at[t_s].add`` walks the updates in
their sorted order), and is bit-equal to it in float32 and bfloat16
(``test_combine_is_jax_scatter_add``), so only the matmuls differ.  ``moe_aux`` and
``moe_z`` within 1e-6 relative (observed <= 3e-7).  Gradients of
``sum(y * r) + moe_aux + moe_z`` through ``torch.autograd`` against
``jax.grad``: within 1e-5 of each leaf's largest magnitude (observed <=
6.6e-7); the x = 0 case has all-zero gradients on both sides.  One
exception: with one expert a token (llama4, learned routing) the gate is
g / g = 1, whose derivative 1/g - g/g^2 vanishes in exact arithmetic, so
both frameworks compute float32 cancellation noise on that path (about
1e-7 x |dL/dgate| / g a token, through the softmax); the router's own
gradient (aux and z terms only) is ~9e-4 at most, so the noise is held to
2e-5 absolute instead (observed 2.7e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import moe as jmoe
from repro.models.layers import split_params

from repro_torch.configs import smoke_config
from repro_torch.models import moe

ARCHS = ["olmoe-1b-7b", "jamba-v0.1-52b", "llama4-maverick-400b-a17b"]
MODES = {"learned": {}, "hash": {}, "drop": dict(capacity_factor=0.25),
         "tie": {}}
B, S = 2, 16
Y_ATOL = 1e-5
AUX_RTOL = 1e-6
GRAD_TOL = 1e-5
TOP1_ROUTER_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and PyTorch's thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def load(module, tree):
    """Copy a nested dict of numpy arrays into ``module`` by name."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            a = tree
            for k in name.split("."):
                a = a[k]
            p.copy_(t(a))
    return module


def j_route(p, cfg, x, router_mode):
    """JAX's routing and dispatch as its ``apply`` computes them: (idx,
    keep in sorted order)."""
    T = B * S
    E, k = cfg.num_experts, cfg.top_k
    xf = x.reshape(T, -1)
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32),
                        p["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    if router_mode == "hash":
        from repro.core.hashing import murmur3_fmix
        h = murmur3_fmix(jnp.arange(T, dtype=jnp.uint32))
        idx = (h[:, None] % jnp.uint32(E)).astype(jnp.int32)
        idx = jnp.concatenate([((idx + j) % E) for j in range(k)], axis=1)
    else:
        _, idx = jax.lax.top_k(probs, k)
    C = jmoe._capacity(cfg, T)
    e_s = idx.reshape(-1)[jnp.argsort(idx.reshape(-1))]
    start = jnp.searchsorted(e_s, e_s, side="left")
    keep = jnp.arange(T * k) - start < C
    return np.asarray(idx), np.asarray(keep)


@pytest.fixture(scope="module", params=[(a, m) for a in ARCHS for m in MODES],
                ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    arch, mode = request.param
    jcfg = j_smoke_config(arch).replace(dtype="float32", **MODES[mode])
    cfg = smoke_config(arch).replace(dtype="float32", **MODES[mode])
    jp, _ = split_params(jmoe.init(jax.random.PRNGKey(3), jcfg))
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if mode == "tie":
        x[:] = 0
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    rm = "hash" if mode == "hash" else "learned"

    def j_obj(p, x):
        y, aux = jmoe.apply(p, jcfg, x, router_mode=rm)
        return jnp.sum(y * r) + aux["moe_aux"] + aux["moe_z"], (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        j_obj, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    want = dict(y=np.asarray(jy), aux={k: float(v) for k, v in jaux.items()},
                grads=(jax.tree.map(np.asarray, jg[0]), np.asarray(jg[1])),
                route=j_route(jp, jcfg, jnp.asarray(x), rm))

    m = load(moe.MoE(cfg, device="cpu"), tree)
    tx = t(x).requires_grad_(True)
    y, aux = moe.apply(m, cfg, tx, router_mode=rm)
    obj = (y * t(r)).sum() + aux["moe_aux"] + aux["moe_z"]
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(obj, (*params, tx))
    with torch.no_grad():
        _, _, _, idx = moe.route(m, cfg, t(x).reshape(B * S, -1), rm)
        _, _, keep = moe.dispatch(cfg, idx, moe._capacity(cfg, B * S))
    got = dict(y=y.detach().numpy(),
               aux={k: float(v.detach()) for k, v in aux.items()},
               grads=(dict(zip(names, (g.numpy() for g in grads[:-1]))),
                      grads[-1].numpy()),
               route=(idx.numpy(), keep.numpy()))
    return dict(arch=arch, mode=mode, cfg=cfg, want=want, got=got)


def test_routing_and_keep_masks_exact(case):
    (gi, gk), (wi, wk) = case["got"]["route"], case["want"]["route"]
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gk, wk)
    k = case["cfg"].top_k
    if case["mode"] == "tie":     # uniform probabilities: experts 0..k-1
        np.testing.assert_array_equal(gi, np.tile(np.arange(k), (B * S, 1)))
    if case["mode"] in ("drop", "tie"):
        assert not gk.all()


def test_outputs_and_aux_match_jax(case):
    got, want = case["got"], case["want"]
    assert np.abs(got["y"] - want["y"]).max() <= Y_ATOL
    assert got["aux"]["moe_dropped"] == want["aux"]["moe_dropped"]
    for k in ("moe_aux", "moe_z"):
        assert abs(got["aux"][k] - want["aux"][k]) <= \
            AUX_RTOL * abs(want["aux"][k]), k
    if case["mode"] == "drop":
        assert want["aux"]["moe_dropped"] > 0


def test_gradients_match_jax(case):
    (gp, gx), (wp, wx) = case["got"]["grads"], case["want"]["grads"]
    assert np.abs(gx - wx).max() <= GRAD_TOL * np.abs(wx).max()
    for name, g in gp.items():
        w = wp
        for k in name.split("."):
            w = w[k]
        tol = GRAD_TOL * np.abs(w).max()
        if name == "router" and case["cfg"].top_k == 1 and \
                case["mode"] != "hash":
            tol = TOP1_ROUTER_ATOL
        assert np.abs(g - w).max() <= tol, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_is_jax_scatter_add(dtype):
    """The combine adds a token's k rows in JAX's CPU scatter-add order:
    bit-equal to a jitted ``zeros.at[t_s].add(contrib)``."""
    rng = np.random.default_rng(8)
    T, k, E, d = 64, 4, 8, 32
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    order, _, _ = moe.dispatch(smoke_config("olmoe-1b-7b"), t(idx), T)
    t_s = np.repeat(np.arange(T), k)[order.numpy()]
    c = (rng.standard_normal((T * k, d)) * 10).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.jit(lambda c: jnp.zeros((T, d), jdt).at[t_s].add(
        c.astype(jdt)))(c).astype(jnp.float32)
    got = moe.combine(t(c).to(tdt), order, T, k)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


def test_capacity_matches_jax():
    for arch in ARCHS:
        jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
        for T in (1, 7, 16, 32, 4096):
            assert moe._capacity(cfg, T) == jmoe._capacity(jcfg, T)
