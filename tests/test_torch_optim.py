"""Parity of the port's AdamW (``repro_torch.optim``) and gradient
compression (``repro_torch.distributed.compression``) with the JAX
package's, on the same leaves.

Tolerances.  ``lr_schedule``: 5e-7 relative at every step.  Both compute
in float32 with the same operations, but XLA's float32 ``cos`` is one ulp
off the correctly rounded value that PyTorch returns at 3 of the 101 steps
(80, 82 and 98).  The schedule's factor ``0.1 + 0.9 * (0.5 + 0.5 cos)`` is
at least 0.1, so one ulp of cos (3e-8 after the halving) moves the rate by
at most 0.9 * 3e-8 / 0.1 = 2.7e-7 relative, plus two roundings; observed
2.16e-7.  ``adamw_update``: params, m, v, ``grad_norm`` and ``lr`` within
1e-6 over three steps, relative to each leaf's largest magnitude
(``assert_rel``); the step exact.  The update math is float32 in both; the
global norm sums its squares in another order (observed one ulp apart,
1.2e-7), which moves every clipped gradient by as much; observed <= 1e-7
of the leaf's scale.  bfloat16 moments are compared after the same float32
math and one rounding.  Compression is bit-equal: the same float32
divisions and round-half-even.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimConfig as JOptimConfig
from repro.distributed import compression as jcomp
from repro.optim import adamw as jadamw

from repro_torch.configs import OptimConfig
from repro_torch.distributed import compression
from repro_torch.distributed.fault_tolerance import (
    FailureInjector, InjectedFailure, RestartPolicy, StragglerMonitor)
from repro_torch.models.model import ParamDict, _jax_path
from repro_torch.models.layers import flatten_tree, unflatten_tree
from repro_torch.optim import adamw

# A mixed tree: an embedding, a norm scale, and two layer leaves stacked on
# a leading axis of 2 (a weight and a norm scale)
SHAPES = {"embed": (6, 4), "final_norm/scale": (4,),
          "stacks/j0/attn/wq": (2, 4, 3), "stacks/j0/norm1/scale": (2, 4)}
PORT_NAMES = {"embed": "embed", "final_norm/scale": "final_norm.scale",
              "stacks/j0/attn/wq": "units.{}.j0.attn.wq",
              "stacks/j0/norm1/scale": "units.{}.j0.norm1.scale"}


def mixed_tree(rng, scale=1.0, layer_scales=(1.0, 1.0)):
    """{JAX path: float32 array}; layer i of a stacked leaf times
    ``layer_scales[i]``."""
    out = {}
    for path, shape in SHAPES.items():
        a = rng.standard_normal(shape).astype(np.float32) * scale
        if path.startswith("stacks"):
            a = a * np.asarray(layer_scales, np.float32).reshape(
                (2,) + (1,) * (len(shape) - 1))
        out[path] = a
    return out


def to_port(flat) -> ParamDict:
    """The JAX leaves as the port's tensors, one a layer."""
    out = ParamDict()
    for path, a in flat.items():
        if path.startswith("stacks"):
            for i in range(a.shape[0]):
                out[PORT_NAMES[path].format(i)] = torch.from_numpy(a[i].copy())
        else:
            out[PORT_NAMES[path]] = torch.from_numpy(a.copy())
    return out


def to_jax_flat(pd: ParamDict) -> dict:
    """The port's tensors as {JAX path: float32 array}, layers stacked."""
    stacks, flat = {}, {}
    for name, t in pd.items():
        path, i = _jax_path(name)
        a = t.float().numpy()
        if i is None:
            flat[path] = a
        else:
            stacks.setdefault(path, {})[i] = a
    flat.update({p: np.stack([d[i] for i in sorted(d)])
                 for p, d in stacks.items()})
    return flat


def jtree(flat):
    return jax.tree.map(jnp.asarray, unflatten_tree(flat))


def jflat(tree):
    return flatten_tree(jax.tree.map(
        lambda x: np.asarray(jnp.asarray(x, jnp.float32)), tree))


def assert_rel(got, want, rtol, what):
    """Relative to the leaf: |got - want| <= rtol * max |want| over the
    leaf, elementwise (an element that sums terms of opposite signs, such
    as a moment, keeps the leaf's absolute error, not its own relative
    one)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"{what}: relative error {err}"


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_jax():
    oc = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    steps = np.arange(0, 101, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jadamw.lr_schedule(
        JOptimConfig(**oc), s))(jnp.asarray(steps)))
    got = np.asarray([float(adamw.lr_schedule(
        OptimConfig(**oc), torch.tensor(s, dtype=torch.int32)))
        for s in steps])
    rel = np.abs(got - want)[1:] / want[1:]      # want[0] == 0 == got[0]
    assert rel.max() <= 5e-7, rel.max()
    assert got[0] == 0.0 and abs(got[10] - 1e-3) < 1e-9


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

CASES = {
    "clip_active_f32": dict(grad_clip=1.0, state_dtype="float32", gscale=10),
    "clip_inactive_f32": dict(grad_clip=1e3, state_dtype="float32", gscale=1),
    "clip_off_bf16": dict(grad_clip=0.0, state_dtype="bfloat16", gscale=1),
    "clip_active_bf16": dict(grad_clip=1.0, state_dtype="bfloat16",
                             gscale=10),
}


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_update_matches_jax(case):
    c = CASES[case]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=c["grad_clip"], state_dtype=c["state_dtype"])
    joc, oc = JOptimConfig(**kw), OptimConfig(**kw)
    rng = np.random.default_rng(5)
    p0 = mixed_tree(rng, 0.5)
    grads = [mixed_tree(rng, c["gscale"], (1.0, 3.0)) for _ in range(3)]

    jp = jtree(p0)
    jstate = jadamw.init_opt_state(jp, joc)
    tp = to_port(p0)
    tstate = adamw.init_opt_state(tp, oc)
    sdt = torch.bfloat16 if c["state_dtype"] == "bfloat16" else torch.float32
    assert all(m.dtype == sdt for m in tstate["m"].values())
    for g in grads:
        jp, jstate, jstats = jadamw.adamw_update(jp, jtree(g), jstate, joc)
        tp, tstate, tstats = adamw.adamw_update(tp, to_port(g), tstate, oc)
        assert int(tstate["step"]) == int(jstate["step"])
        assert tstate["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert_rel(float(tstats[k]), float(jstats[k]), 1e-6, k)
        for what, want, got in (("params", jflat(jp), to_jax_flat(tp)),
                                ("m", jflat(jstate["m"]),
                                 to_jax_flat(tstate["m"])),
                                ("v", jflat(jstate["v"]),
                                 to_jax_flat(tstate["v"]))):
            for path in SHAPES:
                assert_rel(got[path], want[path], 1e-6, f"{what} {path}")
    if c["grad_clip"] == 1.0:    # the norm is reported before clipping
        assert float(tstats["grad_norm"]) > 1.0


def test_decay_mask_reads_the_jax_path():
    assert adamw._decay_mask("units.3.j0.attn.wq")
    assert adamw._decay_mask("embed") and adamw._decay_mask("head")
    for name in ("final_norm.scale", "units.0.j0.norm1.scale",
                 "units.2.j0.attn.q_scale", "units.1.j0.norm2.scale"):
        assert not adamw._decay_mask(name), name


def test_no_decay_on_norm_scales():
    oc = OptimConfig(lr=0.1, warmup_steps=0, total_steps=10,
                     weight_decay=1.0)
    params = ParamDict({"units.0.j0.ffn.up": torch.ones(4),
                        "units.0.j0.norm1.scale": torch.ones(4)})
    state = adamw.init_opt_state(params, oc)
    g = ParamDict({n: torch.zeros_like(p) for n, p in params.items()})
    adamw.adamw_update(params, g, state, oc)
    assert float((params["units.0.j0.norm1.scale"] - 1).abs().max()) < 1e-6
    assert float((params["units.0.j0.ffn.up"] - 1).abs().max()) > 1e-3


def test_adamw_converges_quadratic():
    oc = OptimConfig(lr=0.05, warmup_steps=5, total_steps=200,
                     weight_decay=0.0, grad_clip=1.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = ParamDict({"w": torch.zeros(3)})
    state = adamw.init_opt_state(params, oc)
    for _ in range(200):
        g = ParamDict({"w": 2 * (params["w"] - target)})
        params, state, _ = adamw.adamw_update(params, g, state, oc)
    assert float((params["w"] - target).abs().max()) < 0.05


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def test_round_half_to_even_in_both():
    x = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 126.5],
                   np.float32)
    want = np.asarray(jnp.round(jnp.asarray(x)))
    got = torch.round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [-2, -2, -0, 0, 2, 2, 4, 126])


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compress_tree_bit_equal_to_jax(mode):
    rng = np.random.default_rng(11)
    # the stacked leaves' layers have maxima 3x apart: JAX's one scale per
    # leaf is the larger
    g = mixed_tree(rng, 1.0, (1.0, 3.0))
    # the embedding's scale is exactly 1: values half-way between int8
    # steps round half to even on both sides
    g["embed"][0] = [127.0, 2.5, 3.5, -0.5]
    want = jflat(jcomp.compress_tree(jtree(g), mode))
    got = to_jax_flat(compression.compress_tree(to_port(g), mode))
    for path in SHAPES:
        np.testing.assert_array_equal(got[path], want[path], path)
    if mode == "int8":
        np.testing.assert_array_equal(got["embed"][0], [127, 2, 4, -0.0])     # a per-layer scale would give layer 0 other values
        per_layer = to_jax_flat(compression.compress_tree(
            ParamDict({"a": to_port(g)["units.0.j0.attn.wq"]}), mode))["a"]
        assert not np.array_equal(per_layer, got["stacks/j0/attn/wq"][0])


def test_int8_error_feedback_two_steps_bit_equal_to_jax():
    rng = np.random.default_rng(12)
    gs = [mixed_tree(rng, 1.0, (2.0, 0.5)) for _ in range(2)]
    jef, tef = jcomp.Int8ErrorFeedback(), compression.Int8ErrorFeedback()
    jerr, terr = jef.init(jtree(gs[0])), tef.init(to_port(gs[0]))
    for g in gs:
        jq, jerr = jef.apply(jtree(g), jerr)
        tq, terr = tef.apply(to_port(g), terr)
        for want, got in ((jflat(jq), to_jax_flat(tq)),
                          (jflat(jerr), to_jax_flat(terr))):
            for path in SHAPES:
                np.testing.assert_array_equal(got[path], want[path], path)


def test_unknown_compression_mode_raises():
    with pytest.raises(ValueError):
        compression.compress_tree(ParamDict({"w": torch.zeros(2)}), "fp4")


# ---------------------------------------------------------------------------
# Fault tolerance (pure Python, copied)
# ---------------------------------------------------------------------------

def test_injector_fires_once():
    inj = FailureInjector((3,))
    inj.check(2)
    with pytest.raises(InjectedFailure):
        inj.check(3)
    inj.check(3)


def test_restart_policy_gives_up():
    pol = RestartPolicy(max_restarts=2)
    assert pol.on_failure(RuntimeError())
    assert pol.on_failure(RuntimeError())
    assert not pol.on_failure(RuntimeError())


def test_straggler_detection():
    mon = StragglerMonitor(factor=3.0, warmup=3)
    for s in range(6):
        assert not mon.observe(s, 0.1)
    assert mon.observe(6, 1.0)
    assert mon.backup_runs == 1
    assert not mon.observe(7, 0.12)
