"""What each rank of ``tests/test_torch_train_ranks.py``'s world runs, the
seeded inputs both sides take, and the JAX side (one subprocess with four
forced XLA devices that writes every output to an ``.npz``).  This module
imports no JAX itself, so a rank starts in a second or two; the JAX side
is a source string run in the subprocess, one jitted program a case (the
gradient, then every step), so no case compiles twice; each compiles
and runs in a thread of its own while the next is traced.

Cases (``CASES``), float32 smoke configs at 2 layers, batch 4 x 64 with
pads (-100 labels) in rows 0 and 2, from parameters the port draws
(``params_path``):
  * qwen3-8b on (2, 2) with ``seq_shard``, 2 steps; its step-1 state is
    saved by the ranks' ``Checkpointer`` (``CKPT_CASE``), restored on
    (1, 4), and the step resumed from it;
  * qwen3-8b with 2 KV heads on (1, 4), ``seq_shard=False``, int8
    gradient compression (``wk``/``wv`` replicate over four ranks);
  * olmoe-1b-7b with ``moe_impl="ep"`` and with ``"gspmd"`` on (2, 2)
    (the latter's loss also without autograd, its MoE expert-stationary);
  * jamba-v0.1-52b at 4 layers (mamba, attention and MoE; the smoke
    unit) with ``moe_impl="ep"`` on (2, 2) with ``seq_shard``;
  * xlstm-1.3b (an sLSTM and an mLSTM, head-parallel) on (2, 2) with
    ``seq_shard``;
  * whisper-tiny with 6 heads on (1, 4) with ``seq_shard`` (its attention
    leaves replicated over ``"model"``; its ``final_norm/bias``, which the
    loss never reads, gets a zero gradient).
The xlstm case's loss and gradient also run at 4 x 32, their collectives
counted by kind at both lengths (``SEQ_CASE``); every case's first step
keeps its collectives' calls and bytes by kind and pass, which a
``RecordingMesh``'s trace of the step must equal.  Then, without JAX:
internvl2-2b on (2, 2) from ``init_params_sharded``
(the test holds it against the port's one-device step), and the
uninterrupted run the train CLI's ``--mesh 2 2`` restart must follow
(``CLI``)."""
import os
import subprocess
import sys
import textwrap

import numpy as np

WORLD = 4
MESHES = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4}}
B, S = 4, 64
LAYERS = {"num_layers": 2}
OC = dict(lr=1e-3, warmup_steps=2, total_steps=16)
CASES = {
    "qwen3-2x2": dict(arch="qwen3-8b", over={}, mesh="2x2", seq_shard=True,
                      comp="none", steps=2),
    "qwen3-kv2-1x4": dict(arch="qwen3-8b", over={"num_kv_heads": 2},
                          mesh="1x4", seq_shard=False, comp="int8", steps=1),
    "olmoe-ep-2x2": dict(arch="olmoe-1b-7b", over={"moe_impl": "ep"},
                         mesh="2x2", seq_shard=True, comp="none", steps=1),
    "olmoe-gspmd-2x2": dict(arch="olmoe-1b-7b", over={}, mesh="2x2",
                            seq_shard=True, comp="none", steps=1),
    "jamba-ep-2x2": dict(arch="jamba-v0.1-52b",
                         over={"moe_impl": "ep", "num_layers": 4},
                         mesh="2x2", seq_shard=True, comp="none", steps=1),
    "xlstm-2x2": dict(arch="xlstm-1.3b", over={}, mesh="2x2",
                      seq_shard=True, comp="none", steps=1),
    "whisper-h6-1x4": dict(arch="whisper-tiny",
                           over={"num_heads": 6, "num_kv_heads": 6},
                           mesh="1x4", seq_shard=True, comp="none", steps=1),
}
CKPT_CASE = "qwen3-2x2"
# the case whose collectives are counted at S and at S / 2
SEQ_CASE = "xlstm-2x2"
VLM = dict(arch="internvl2-2b", mesh="2x2", seq_shard=True, seed=0)
# the train CLI's --mesh 2 2 run (olmoe smoke at its dtypes) and the same
# run without a failure, here in the world
CLI = dict(arch="olmoe-1b-7b", steps=3, batch=4, seq=64, lr=3e-4)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def cli_args(ckpt_dir: str) -> list:
    return ["--arch", CLI["arch"], "--smoke", "--mesh", "2", "2", "--device",
            "cpu", "--steps", str(CLI["steps"]), "--batch", str(CLI["batch"]),
            "--seq", str(CLI["seq"]), "--lr", str(CLI["lr"]), "--ckpt-dir",
            ckpt_dir, "--ckpt-every", "1", "--inject-failure-at", "2"]


def torch_config(arch, over):
    from repro_torch.configs import smoke_config
    return smoke_config(arch).replace(dtype="float32", **{**LAYERS, **over})


def batch_np(data_cls, cfg, shape_cls, step: int) -> dict:
    """The global batch of ``step`` (the port's and JAX's
    ``SyntheticLMData`` are the same numpy code), with pads."""
    b = data_cls(cfg, shape_cls("t", S, B, "train")).batch_at(step)
    b["labels"][0, :10] = -100
    b["labels"][2, -5:] = -100
    return b


def params_path(tmp: str, arch: str, over: dict) -> str:
    tag = arch + "".join(f"-{k}{v}" for k, v in sorted(over.items())
                         if k != "moe_impl")
    return os.path.join(tmp, f"params-{tag}.npz")


def write_params(tmp: str):
    """The port's draw of every case's model (seed 0), JAX's tree as
    ``.npz``: both sides start from it."""
    from repro_torch.models import model
    from repro_torch.models.layers import flatten_tree
    for c in CASES.values():
        path = params_path(tmp, c["arch"], c["over"])
        if not os.path.exists(path):
            cfg = torch_config(c["arch"], c["over"])
            np.savez(path, **flatten_tree(model.params_to_numpy(
                model.init_params(cfg, 0, "cpu"))))


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf} (numpy only: the JAX side uses it)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def load_tree(path: str) -> dict:
    """The ``.npz`` of ``write_params`` as JAX's nested tree (numpy only:
    the JAX side reads it too)."""
    out: dict = {}
    with np.load(path) as z:
        for k in z.files:
            *heads, last = k.split("/")
            node = out
            for h in heads:
                node = node.setdefault(h, {})
            node[last] = z[k]
    return out


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _blocks(tree) -> dict:
    return {n: t.detach().numpy().copy() for n, t in tree.items()}


def _collectives_since(mesh, before) -> dict:
    """{kind/pass: calls} since ``before``, the kinds called."""
    out = {k: v["calls"] - before.get(k, {"calls": 0})["calls"]
           for k, v in mesh.collectives["by_kind"].items()}
    return {k: n for k, n in out.items() if n}


def _sent_since(mesh, before) -> dict:
    """{kind/pass: [calls, bytes]} since ``before``, the kinds called."""
    zero = {"calls": 0, "bytes": 0}
    out = {k: [v["calls"] - before.get(k, zero)["calls"],
               v["bytes"] - before.get(k, zero)["bytes"]]
           for k, v in mesh.collectives["by_kind"].items()}
    return {k: v for k, v in out.items() if v[0]}


def _case_rank(meshes, name, tmp):
    import copy

    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import OptimConfig, ShapeConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import steps
    from repro_torch.launch.train import _restore_tree_shapes
    from repro_torch.models import model
    c = CASES[name]
    mesh = meshes[c["mesh"]]
    cfg = torch_config(c["arch"], c["over"])
    oc = OptimConfig(**OC)
    before = copy.deepcopy(mesh.collectives["by_kind"])
    full = model.params_from_numpy(cfg, load_tree(
        params_path(tmp, c["arch"], c["over"])), "cpu")
    params = model.shard_params(full, mesh)
    opt = steps.init_opt_state(params, oc)
    step = steps.build_train_step(cfg, oc, mesh, seq_shard=c["seq_shard"],
                                  grad_compression=c["comp"])
    batches = [{k: torch.from_numpy(v) for k, v in batch_np(
        SyntheticLMData, cfg, ShapeConfig, s).items()}
        for s in range(c["steps"])]
    _, _, grads = step.loss_and_grads(params, batches[0])
    out = {"grads": _blocks(grads), "metrics": [], "params": [],
           "specs": {n: p.spec for n, p in params.named_parameters()}}
    if cfg.num_experts and cfg.moe_impl != "ep":
        # the loss without autograd: its MoE layers expert-stationary
        from repro_torch.distributed import sharding
        ctx = sharding.ShardCtx(mesh, c["seq_shard"]).bind(B, S)
        with torch.no_grad():
            out["nograd_loss"] = float(model.loss_fn(
                params, cfg, ctx.local_batch(batches[0]), shard_ctx=ctx)[0])
    for s, b in enumerate(batches):
        sent = copy.deepcopy(mesh.collectives["by_kind"])
        params, opt, m = step(params, opt, b)
        if s == 0:
            # the first step's own collectives, calls and bytes
            out["step_collectives"] = _sent_since(mesh, sent)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append(_blocks(dict(params.named_parameters())))
        if name == CKPT_CASE and s == 0:
            ck = Checkpointer(os.path.join(tmp, "ckpt"), mesh=mesh)
            ck.save(1, {"params": params, "opt": opt})
            ck.wait()
    out["collectives"] = _collectives_since(mesh, before)
    if name == SEQ_CASE:
        # the loss and gradient alone at the whole and half the sequence
        out["by_seq"] = {}
        for seq in (S, S // 2):
            before = copy.deepcopy(mesh.collectives["by_kind"])
            step.loss_and_grads(params, {k: v[:, :seq] if v.dim() > 1 else v
                                         for k, v in batches[0].items()})
            out["by_seq"][seq] = _collectives_since(mesh, before)
    if name == CKPT_CASE:
        # restored on the other mesh, and the step resumed on this one
        other = meshes["1x4"]
        ck = Checkpointer(os.path.join(tmp, "ckpt"), mesh=other)
        st = ck.restore(1, _restore_tree_shapes(cfg, oc, other), "cpu")
        out["restored_1x4"] = _blocks(dict(st["params"].named_parameters()))
        ck = Checkpointer(os.path.join(tmp, "ckpt"), mesh=mesh)
        st = ck.restore(ck.latest_step(), _restore_tree_shapes(cfg, oc, mesh),
                        "cpu")
        params, _, m = step(st["params"], st["opt"], batches[1])
        out["resumed"] = (_blocks(dict(params.named_parameters())),
                          {k: float(v) for k, v in m.items()})
    return out


def _vlm_rank(meshes):
    import torch
    from repro_torch.configs import OptimConfig, ShapeConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import steps
    cfg = torch_config(VLM["arch"], {})
    oc = OptimConfig(**OC)
    mesh = meshes[VLM["mesh"]]
    params, opt = steps.init_train_state(cfg, oc, mesh, VLM["seed"])
    step = steps.build_train_step(cfg, oc, mesh, seq_shard=VLM["seq_shard"])
    b = {k: torch.from_numpy(v) for k, v in batch_np(
        SyntheticLMData, cfg, ShapeConfig, 0).items()}
    _, _, grads = step.loss_and_grads(params, b)
    params, opt, m = step(params, opt, b)
    return {"grads": _blocks(grads),
            "metrics": {k: float(v) for k, v in m.items()},
            "params": _blocks(dict(params.named_parameters())),
            "specs": {n: p.spec for n, p in params.named_parameters()}}


def _cli_reference(meshes):
    from repro_torch.configs import OptimConfig, ShapeConfig, smoke_config
    from repro_torch.launch.train import train
    cfg = smoke_config(CLI["arch"])
    n = CLI["steps"]
    oc = OptimConfig(lr=CLI["lr"], warmup_steps=min(20, n // 5 + 1),
                     total_steps=n)
    _, _, losses, _, pol = train(
        cfg, ShapeConfig("cli", CLI["seq"], CLI["batch"], "train"), oc,
        meshes["2x2"], num_steps=n, ckpt_dir=None, verbose=False)
    return [losses[s] for s in sorted(losses)], pol.restarts


def train_world(world, tmp):
    """Every case on this rank (every rank makes both meshes and runs every
    case in the same order)."""
    from repro_torch.launch.mesh import make_model_mesh
    meshes = {n: make_model_mesh(world, s) for n, s in MESHES.items()}
    out = {"coords": {n: m.coords for n, m in meshes.items()}}
    for name in CASES:
        out[name] = _case_rank(meshes, name, tmp)
    out["vlm"] = _vlm_rank(meshes)
    out["cli"] = _cli_reference(meshes)
    return out


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

JAX_SIDE = """
import sys
sys.path.insert(0, {tests!r})
from concurrent.futures import ThreadPoolExecutor
import numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.configs.base import OptimConfig, ShapeConfig
from repro.data import SyntheticLMData
from repro.distributed import sharding as shd
from repro.distributed import steps as jsteps
from repro.launch.mesh import make_mesh
from repro.models import model as jmodel
from repro.optim import init_opt_state
import train_rank_cases as tc

oc = OptimConfig(**tc.OC)
# the gradients the steps' updates take, as the cases are traced
taken = []
adamw_update = jsteps.adamw_update


def _adamw_update(params, grads, opt, oc):
    taken.append(grads)
    return adamw_update(params, grads, opt, oc)


jsteps.adamw_update = _adamw_update


def lower(name):
    c = tc.CASES[name]
    cfg = smoke_config(c["arch"]).replace(dtype="float32",
                                          **{{**tc.LAYERS, **c["over"]}})
    shape = tc.MESHES[c["mesh"]]
    mesh = make_mesh(tuple(shape.values()), tuple(shape))
    train_step, _, pshard, oshard = jsteps.build_train_step(
        cfg, oc, mesh, seq_shard=c["seq_shard"], grad_compression=c["comp"])
    ctx = shd.ShardCtx(mesh, seq_shard=c["seq_shard"])
    params = jax.tree.map(jnp.asarray, tc.load_tree(
        tc.params_path({tmp!r}, c["arch"], c["over"])))
    opt = init_opt_state(params, oc)
    bs = [{{k: jnp.asarray(v) for k, v in tc.batch_np(
        SyntheticLMData, cfg, ShapeConfig, s).items()}}
        for s in range(c["steps"])]
    bshard = {{k: jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
        shd.batch_spec(mesh, v.shape[0]), *([None] * (v.ndim - 1))))
        for k, v in bs[0].items()}}

    def prog(params, opt, bs):
        # the first step's gradient is the one its update takes; where it
        # is compressed first, the loss's own
        taken.clear()
        grads = None if c["comp"] == "none" else jax.grad(
            lambda p: jmodel.loss_fn(p, cfg, bs[0], shard_ctx=ctx)[0])(params)
        outs = []
        for b in bs:
            params, opt, m = train_step(params, opt, b)
            outs.append((params, opt, m))
        return taken[0] if grads is None else grads, outs
    args = jax.device_put((params, opt, bs),
                          (pshard, oshard, [bshard] * len(bs)))
    return name, jax.jit(prog).lower(*args), args


def finish(name, lowered, args):
    grads, outs = lowered.compile()(*args)
    out = {{}}
    for k, v in tc.flatten(jax.tree.map(np.asarray, grads)).items():
        out[f"{{name}}/grads/{{k}}"] = v
    for s, (p, o, m) in enumerate(outs):
        for k, v in m.items():
            out[f"{{name}}/metrics{{s}}/{{k}}"] = np.asarray(v)
        for k, v in tc.flatten(jax.tree.map(np.asarray, p)).items():
            out[f"{{name}}/params{{s}}/{{k}}"] = v
        if s == 0:
            for k, v in tc.flatten(jax.tree.map(
                    np.asarray, {{"m": o["m"], "v": o["v"]}})).items():
                out[f"{{name}}/opt0/{{k}}"] = v
    return out


# the cases are traced one after another, the longest first, and each
# compiles and runs in a thread of its own meanwhile
out = {{}}
with ThreadPoolExecutor(len(tc.CASES)) as ex:
    jobs = [ex.submit(finish, *lower(n)) for n in reversed(tc.CASES)]
    for f in jobs:
        out.update(f.result())
np.savez({path!r}, **out)
print("JAX OK")
"""


def start_jax_side(tmp: str):
    """Start the JAX side, which reads the parameters under ``tmp`` and
    writes ``{tmp}/jax.npz``; ``finish_jax_side`` waits for it."""
    env = dict(os.environ)
    # one compute thread: the compiles dominate, and the suite's other
    # workers share the cores
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={WORLD} "
                        f"--xla_cpu_multi_thread_eigen=false")
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"),
                                         os.path.join(ROOT, "tests")])
    path = os.path.join(tmp, "jax.npz")
    code = JAX_SIDE.format(tests=os.path.join(ROOT, "tests"), tmp=tmp,
                           path=path)
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env), path


def finish_jax_side(proc) -> dict:
    proc, path = proc
    so, se = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
