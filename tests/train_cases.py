"""Parity of the port's training stack (``repro_torch.models.model.loss_fn``,
``distributed.steps.build_train_step``, ``launch.train``) with the JAX
package's, at ``smoke_config`` of llama3-8b, qwen3-8b and h2o-danube-1.8b
(window 12, which the 64-token sequences pass) in float32, and llama3-8b in
bfloat16; of the moe and hybrid families in float32: one step of
olmoe-1b-7b and of jamba-v0.1-52b, 8 steps of ``train`` of jamba (its units
hold both MoE and mamba layers), the decay mask and int8 compression on
their ``stacks/j{j}`` trees; and of the ssm, encdec and vlm families in
float32: one step and 8 steps of ``train`` of xlstm-1.3b, whisper-tiny and
internvl2-2b, the decay mask on the ``stacks/{encoder, decoder}`` and
xLSTM trees, ``input_specs`` of encdec and vlm.  Parameters cross from JAX by ``params_from_numpy`` or through a
step-0 checkpoint JAX wrote (the loss tests take the port's draw, carried
to JAX); every JAX function runs jitted, once a case.

Tolerances, each from what float32 summation order can do:
  * loss and cross-entropy (``loss_fn``, ``chunked_cross_entropy``, pads of
    -100 included): 1e-6 relative; observed <= 2.3e-7.
  * one ``train_step``: loss, ``grad_norm`` and ``lr`` within 1e-5
    relative (observed <= 2.3e-7); every gradient within 1e-5 of its
    leaf's largest magnitude (observed <= 2.5e-6); the new parameters within
    1e-5 absolute wherever JAX's gradient is at least 1e-6.  AdamW's first
    step moves an element by lr * g / (|g| + eps), eps = 1e-8, so where |g|
    is within a few eps of zero a float32 difference of 1e-9 in g moves the
    element by up to 0.07 lr (3.4e-5 at lr 5e-4, observed on 1-3 elements
    of 600k, all with |g| <= 1.2e-7); there the bound is the step's own
    size, 2 lr.
  * bfloat16 (activations and per-einsum weight casts): the loss within
    1e-4 relative (observed 3.1e-6) and ``grad_norm`` within 1e-3 (observed
    1.3e-4).  bfloat16 keeps 8 bits and the frameworks round at different
    points, so gradients differ by up to 2.5% of their leaf's scale and the
    first AdamW step (a sign, nearly) flips on small elements: the new
    parameters are held to the 2 lr bound only.
  * 8 steps of ``train`` resumed from the same JAX step-0 checkpoint: every
    loss within 1e-5 relative of JAX's (observed <= 3.9e-7).
  * xlstm-1.3b, whisper-tiny and internvl2-2b take the float32 bounds
    above (whisper's 8 losses observed <= 2.6e-7, internvl2's <= 2.4e-7),
    but for xlstm's gradients and later losses.  Its exponential gates
    amplify float32 rounding through the stack, the port's and JAX's
    alike: against a float64 recurrence the port's mLSTM errs 1.38e-6 of
    its largest output, JAX's 1.49e-6; yet JAX against itself at mLSTM
    chunk 64 instead of 16 (the same function) moves one step's gradients
    by up to 1.8e-5 of a leaf's largest and the losses of steps 2-7 by up
    to 2.4e-3 relative (``tests/xlstm_drift.py --train``).  So xlstm's gradients are held within 1e-4 of their
    leaf's largest (observed 5.7e-5) and its losses of steps 2-7 within
    5e-3 relative (observed <= 1.5e-3; steps 0-1 within 1e-5, observed
    4.0e-6).  Whisper's ``final_norm/bias``, which the loss never reads,
    has a zero gradient and zero moments and stays zero, as in JAX.
  * olmoe and jamba take the float32 bounds above; their losses carry the
    MoE aux terms, and the router's gradient flows through the gates, the
    load-balance and the z loss.  Routing is discrete, so the bounds hold
    only while both sides route alike: the MoE tests check that every
    routing decision agrees (``tests/test_torch_moe_*.py``).
  * the decay mask and int8 compression on the unit trees: exact.

Shared by the ``tests/test_torch_train_*.py`` files: each binds the
module-scoped fixtures below, so each compiles JAX's step once a case.
"""
import jax
import numpy as np
import pytest

from repro.configs import smoke_config as j_smoke_config
from repro.distributed import steps as jsteps
from repro.launch.mesh import make_mesh
from repro.models import model as jmodel

from repro_torch.configs import ShapeConfig, smoke_config
from repro_torch.data import SyntheticLMData

CPU = "cpu"
OC = dict(lr=1e-3, warmup_steps=2, total_steps=16)
B, S = 4, 64

# xLSTM's exponential gates amplify float32 rounding through the stack:
# JAX against itself at another mLSTM chunking (the same function) moves
# these gradients by up to 1.8e-5 of a leaf's largest, the port by 5.7e-5
GRAD_TOL = {"xlstm-1.3b": 1e-4}
# ... and its training trajectory: JAX against itself at another chunking
# differs by up to 2.4e-3 relative in the losses of steps 2-7
LOSS_TOL = {"xlstm-1.3b": 5e-3}


def configs(arch, dtype):
    kw = dict(dtype=dtype)
    if arch == "h2o-danube-1.8b":
        kw["sliding_window"] = 12
    return j_smoke_config(arch).replace(**kw), smoke_config(arch).replace(**kw)


def case_id(c):
    return f"{c[0]}-{c[1]}"


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def jax_state():
    """JAX's train state drawn from ``PRNGKey(0)``, once a config, as
    numpy (zero moments, step 0, as ``init_opt_state`` makes them):
    ``test_train_step_matches_jax`` takes its parameters and
    ``test_train_from_jax_checkpoint_follows_jax`` saves it at step 0.
    JAX's init does not read ``dtype``: llama3-8b's float32 and bfloat16
    cases share one draw."""
    from repro.optim import init_opt_state as j_init_opt_state
    cache = {}

    def get(jcfg, joc):
        key = (jcfg.replace(dtype="float32"), joc)
        if key not in cache:
            # eager: the configs share most leaf shapes, so their draws share
            # compiled primitives where one jitted init a config would not
            params = jax.tree.map(np.asarray, jmodel.init_params(
                key[0], jax.random.PRNGKey(0)))
            opt = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                               jax.eval_shape(lambda p: j_init_opt_state(
                                   p, joc), params))
            cache[key] = params, opt
        return cache[key]
    return get


@pytest.fixture(scope="module", autouse=True)
def jax_train_step_once():
    """JAX's jitted train step of a config, compiled once for the module:
    ``test_train_step_matches_jax`` and, through JAX's ``train``,
    ``test_train_from_jax_checkpoint_follows_jax`` build the same step (the
    same config, optimizer, mesh and batch shapes), and each build would
    compile it again.  The arguments are placed with the step's shardings
    first, as JAX's ``train`` places them, so both calls trace the same
    types.  The one program also returns the gradient the step's update
    takes (``adamw_update``'s argument, uncompressed here), which
    ``jitted(batch).with_grads`` gives: the test needs no second program
    that differentiates the loss again."""
    from repro.data import make_batch_specs
    build = jsteps.build_train_step
    adamw_update = jsteps.adamw_update
    taken = []

    def taking_adamw_update(params, grads, opt_state, oc):
        taken.append(grads)
        return adamw_update(params, grads, opt_state, oc)
    cache = {}

    def build_once(cfg, oc, mesh, *, seq_shard=True,
                   grad_compression="none"):
        key = (cfg, oc, id(mesh), seq_shard, grad_compression)
        if key not in cache:
            step, _, pshard, oshard = build(
                cfg, oc, mesh, seq_shard=seq_shard,
                grad_compression=grad_compression)
            jits = {}

            def step_and_grads(params, opt_state, batch):
                taken.clear()
                return (*step(params, opt_state, batch), taken[0])

            def jitted_once(batch_tree):
                shapes = tuple(sorted((k, tuple(v.shape))
                                      for k, v in batch_tree.items()))
                if shapes not in jits:
                    where = (pshard, oshard,
                             make_batch_specs(mesh, batch_tree))
                    # JAX's jitted step (``build_train_step``'s
                    # ``jitted``), the gradient its fourth output
                    fn = jax.jit(step_and_grads, in_shardings=where,
                                 out_shardings=(pshard, oshard, None, None),
                                 donate_argnums=(0, 1))

                    def with_grads(*args, fn=fn, where=where):
                        return fn(*jax.device_put(args, where))

                    def run(*args, with_grads=with_grads):
                        return with_grads(*args)[:3]
                    run.with_grads = with_grads
                    jits[shapes] = run
                return jits[shapes]
            cache[key] = (step, jitted_once, pshard, oshard)
        return cache[key]
    jsteps.build_train_step = build_once
    jsteps.adamw_update = taking_adamw_update
    yield
    jsteps.build_train_step = build
    jsteps.adamw_update = adamw_update


def batch_np(cfg, step=0):
    b = SyntheticLMData(cfg, ShapeConfig("t", S, B, "train")).batch_at(step)
    b["labels"][0, :10] = -100          # pads
    b["labels"][2, -5:] = -100
    return b


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))
