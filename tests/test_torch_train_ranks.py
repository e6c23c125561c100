"""Training over a ("data", "model") mesh of ranks (``launch.mesh.ModelMesh``,
``torch.distributed`` over gloo on the CPU) against the JAX package's
``build_train_step`` on a mesh of four forced XLA devices.

ONE world of 4 spawned CPU ranks runs every case of
``tests/train_rank_cases.py`` while ONE JAX subprocess runs JAX's side of
them (one jitted program a case) and the train CLI runs ``--mesh 2 2``;
both sides start from the same parameters, which the port draws here:
  * ``build_train_step``'s gradient and steps on each rank against JAX's:
    qwen3-8b smoke at 2 layers on (2, 2) with ``seq_shard`` (2 steps), its
    2-KV-head variant on (1, 4) without ``seq_shard`` and with int8
    compression, olmoe-1b-7b with ``moe_impl="ep"`` (``moe.apply_ep``) and
    ``"gspmd"`` on (2, 2) (the latter's loss also without autograd, its MoE
    layers ``moe.apply_stationary``), jamba-v0.1-52b at 4 layers with
    ``"ep"`` on (2, 2) with ``seq_shard`` (tensor-parallel mamba);
  * the ranks' step-1 checkpoint of the first case: JAX's ``Checkpointer``
    reads it as JAX's own state; the port restores it on one device
    bit-equal to the gathered blocks, and on (1, 4) bit-equal to the
    blocks of that mesh; the step resumed from it equals the uninterrupted
    one bit for bit;
  * internvl2-2b on (2, 2) from ``init_params_sharded`` against the port's
    one-device step (its -100 labels test the global token count);
  * ``--mesh 2 2 --inject-failure-at 2`` restarts once and its losses equal
    a run without the failure;
  * the xlstm step's collectives do not grow with the sequence (the
    sLSTM's time loop issues none);
  * the dry-run's ``RecordingMesh`` trace of a case's first step, on fake
    tensors, counts what every rank's gloo mesh sent in that step, call
    for call and byte for byte, by kind and pass (dense on (2, 2) with
    ``seq_shard`` and on (1, 4) with int8 compression, the MoE with
    expert parallelism, the hybrid);
  * a bare shape of more than one shard refuses
    (``tests/test_torch_train.py``).

Bounds, those of ``tests/test_torch_train.py``, from what float32
summation order can do: loss, cross-entropy, grad norm, lr, ``moe_aux`` and
``moe_z`` within 1e-5 relative; ``moe_dropped`` exactly; each rank's
gradient block within 1e-5 of its leaf's largest |g| (xlstm's within
1e-4, its one-device bound: JAX's own mesh runs differ by 1.07e-5); the stepped
parameters within 1e-5 where |g| >= 1e-6 and within 2 lr everywhere (the
first AdamW step moves an element with |g| near eps by a sign)."""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import OptimConfig, ShapeConfig
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import sharding, steps
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import ModelMesh, mesh_coords, recording_mesh, \
    spawn_ranks
from repro_torch.launch.train import _restore_tree_shapes
from repro_torch.models import model
from repro_torch.models.layers import flatten_tree

import train_rank_cases as tc

TOL = 1e-5
# xLSTM's exponential gates amplify float32 rounding (ROADMAP Queue 3):
# JAX against itself on (2, 2) and (1, 4) against (1, 1) moves the smoke
# case's sLSTM ``up1`` gradient by 1.07e-5 of its largest, so its
# gradients take tests/test_torch_train.py's xLSTM bound
GRAD_TOL = {"xlstm-1.3b": 1e-4}
CPU = torch.device("cpu")


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(JAX's outputs, each rank's results, the CLI's completed process,
    the temp dir, the vlm case's one-device step)."""
    tmp = str(tmp_path_factory.mktemp("train"))
    tc.write_params(tmp)
    proc = tc.start_jax_side(tmp)
    env = dict(os.environ, PYTHONPATH=os.path.join(tc.ROOT, "src"))
    try:
        with ThreadPoolExecutor(1) as ex:
            world = ex.submit(spawn_ranks, tc.train_world, tc.WORLD, tmp,
                              device="cpu", timeout=300)
            vlm = vlm_one_device()          # while the ranks run
            ranks = world.result()
        # after the world, while JAX compiles: the two worlds at once would
        # take the cores JAX's compiles need
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train",
             *tc.cli_args(os.path.join(tmp, "cli_ckpt"))],
            capture_output=True, text=True, env=env, timeout=300)
    except BaseException:
        proc[0].kill()
        raise
    return tc.finish_jax_side(proc), ranks, \
        (cli.returncode, cli.stdout, cli.stderr), tmp, vlm


def vlm_one_device():
    """The vlm case's port step on one device: (its metrics, its gradient,
    the stepped parameters, the batch's labels)."""
    cfg = tc.torch_config(tc.VLM["arch"], {})
    oc = OptimConfig(**tc.OC)
    params = model.init_params(cfg, tc.VLM["seed"], CPU)
    step = steps.build_train_step(cfg, oc)
    b = {k: torch.from_numpy(v) for k, v in tc.batch_np(
        SyntheticLMData, cfg, ShapeConfig, 0).items()}
    _, _, grads = step.loss_and_grads(params, b)
    params, _, m = step(params, steps.init_opt_state(params, oc), b)
    want = {n: p.detach().numpy() for n, p in params.named_parameters()}
    return m, grads, want, b["labels"]


def rank_mesh(name, r, ranks):
    shape = tc.MESHES[name]
    return ModelMesh(shape, r, ranks[r]["coords"][name], CPU, "gloo", {})


def block(whole, spec, mesh):
    return sharding.local_block(torch.from_numpy(np.asarray(whole)), spec,
                                mesh).numpy()


def stacked(named: dict) -> dict:
    """{parameter name: array} -> {JAX leaf path: array}, layers stacked."""
    out: dict = {}
    for n, a in named.items():
        path, i = model._jax_path(n)
        out.setdefault(path, []).append((i, a))
    return {p: np.stack([a for _, a in sorted(v, key=lambda t: t[0])])
            if v[0][0] is not None else v[0][1] for p, v in out.items()}


def assemble(ranks_blocks, specs, mesh_name, ranks, shapes) -> dict:
    """The whole tensors from every rank's blocks."""
    out = {}
    for n, shape in shapes.items():
        full = np.zeros(shape, np.float32)
        idx = torch.arange(full.size).view(shape)
        for r, blocks in enumerate(ranks_blocks):
            at = sharding.local_block(idx, specs[n],
                                      rank_mesh(mesh_name, r, ranks)).numpy()
            full.reshape(-1)[at.reshape(-1)] = blocks[n].reshape(-1)
        out[n] = full
    return out


def check_step(got_m, want_m):
    assert set(got_m) == set(want_m)
    for k in ("loss", "ce_loss", "grad_norm", "lr", "moe_aux", "moe_z"):
        if k in want_m:
            assert rel(got_m[k], want_m[k]) <= TOL, (k, got_m[k], want_m[k])
    if "moe_dropped" in want_m:
        assert got_m["moe_dropped"] == float(want_m["moe_dropped"])


def check_params(got, want, g, lr, what):
    d = np.abs(got - want)
    sure = np.abs(g) >= 1e-6
    assert d[sure].max(initial=0) <= TOL, what
    assert d.max() <= 2 * lr, what


@pytest.mark.parametrize("name", list(tc.CASES))
def test_train_step_over_ranks_matches_jax(name, worlds):
    jax_out, ranks, _, _, _ = worlds
    c = tc.CASES[name]
    for r, res in enumerate(ranks):
        mesh = rank_mesh(c["mesh"], r, ranks)
        got = res[name]
        for s, m in enumerate(got["metrics"]):
            want = {k.rsplit("/", 1)[1]: v for k, v in jax_out.items()
                    if k.startswith(f"{name}/metrics{s}/")}
            check_step(m, want)
        if "nograd_loss" in got:
            assert rel(got["nograd_loss"], jax_out[f"{name}/metrics0/loss"]) \
                <= TOL
        lr = got["metrics"][0]["lr"]
        for n, g in got["grads"].items():
            path, i = model._jax_path(n)
            wg = jax_out[f"{name}/grads/{path}"]
            wg = wg if i is None else wg[i]
            spec = got["specs"][n]
            assert g.shape == sharding.local_shape(wg.shape, spec, mesh)
            assert np.abs(g - block(wg, spec, mesh)).max() <= \
                GRAD_TOL.get(c["arch"], TOL) * np.abs(wg).max(), (r, n)
            for s, params in enumerate(got["params"]):
                wp = jax_out[f"{name}/params{s}/{path}"]
                wp = wp if i is None else wp[i]
                check_params(params[n], block(wp, spec, mesh),
                             block(wg, spec, mesh), lr, (r, n, s))
        if "final_norm.bias" in got["grads"]:
            # the loss reads final_norm's scale only, as JAX's
            assert not np.any(got["grads"]["final_norm.bias"])
            assert not np.any(jax_out[f"{name}/grads/final_norm/bias"])


def test_moe_routes_over_the_mesh(worlds):
    """EP exchanges tokens by all-to-all, GSPMD gathers them; both drop."""
    jax_out, ranks, _, _, _ = worlds
    for res in ranks:
        ep, gs = res["olmoe-ep-2x2"], res["olmoe-gspmd-2x2"]
        assert ep["collectives"].get("all_to_all/forward", 0) > 0
        assert ep["collectives"].get("all_to_all/backward", 0) > 0
        assert "all_to_all/forward" not in gs["collectives"]
        assert ep["metrics"][0]["moe_dropped"] > 0
        assert ep["metrics"][0]["moe_dropped"] != \
            gs["metrics"][0]["moe_dropped"]


def test_sharded_checkpoint_is_jax_s_and_restores_on_any_mesh(worlds):
    from repro.checkpoint import Checkpointer as JCheckpointer
    jax_out, ranks, _, tmp, _ = worlds
    import jax
    from repro.configs import smoke_config as j_smoke_config
    from repro.configs.base import OptimConfig as JOptimConfig
    from repro.models import model as jmodel
    from repro.optim import init_opt_state as j_init_opt_state
    name = tc.CKPT_CASE
    c = tc.CASES[name]
    cfg = tc.torch_config(c["arch"], c["over"])
    oc = OptimConfig(**tc.OC)
    # the port on one device reads the ranks' files: the gathered blocks
    one = Checkpointer(os.path.join(tmp, "ckpt")).restore(
        1, _restore_tree_shapes(cfg, oc), CPU)
    whole = {n: p.detach().numpy() for n, p in
             one["params"].named_parameters()}
    specs = ranks[0][name]["specs"]
    gathered = assemble([r[name]["params"][0] for r in ranks], specs,
                        c["mesh"], ranks, {n: a.shape for n, a in
                                           whole.items()})
    for n in whole:
        np.testing.assert_array_equal(whole[n], gathered[n], err_msg=n)
    # ... on (1, 4): each rank its block of them
    for r, res in enumerate(ranks):
        mesh = rank_mesh("1x4", r, ranks)
        for n, a in res[name]["restored_1x4"].items():
            spec = sharding.spec_for(tc.MESHES["1x4"],
                                     model.leaf_axes(one["params"])[n],
                                     whole[n].shape)
            np.testing.assert_array_equal(a, block(whole[n], spec, mesh),
                                          err_msg=n)
        # the step resumed from it equals the uninterrupted one, bit for bit
        params, m = res[name]["resumed"]
        assert m == res[name]["metrics"][1]
        for n, a in params.items():
            np.testing.assert_array_equal(a, res[name]["params"][1][n],
                                          err_msg=n)
    # JAX reads them as its own state after step 1
    jcfg = j_smoke_config(c["arch"]).replace(dtype="float32", **tc.LAYERS)
    joc = JOptimConfig(**tc.OC)
    target = jax.eval_shape(lambda k: (lambda p: {"params": p, "opt":
                            j_init_opt_state(p, joc)})(
        jmodel.init_params(jcfg, k)), jax.random.PRNGKey(0))
    st = JCheckpointer(os.path.join(tmp, "ckpt")).restore(1, target)
    flat = flatten_tree(jax.tree.map(np.asarray, st))
    assert int(flat["opt/step"]) == 1
    lr = ranks[0][name]["metrics"][0]["lr"]
    for path, a in flatten_tree(jax.tree.map(np.asarray,
                                             st["params"])).items():
        g = jax_out[f"{name}/grads/{path}"]
        check_params(a, jax_out[f"{name}/params0/{path}"], g, lr, path)
        np.testing.assert_array_equal(a, stacked(whole)[path], err_msg=path)
        for mv in ("m", "v"):
            w = jax_out[f"{name}/opt0/{mv}/{path}"]
            assert np.abs(flat[f"opt/{mv}/{path}"] - w).max() <= \
                TOL * max(np.abs(w).max(), 1e-30), (mv, path)


def test_vlm_over_ranks_matches_one_device(worlds):
    _, ranks, _, _, (m, grads, want, labels) = worlds
    cfg = tc.torch_config(tc.VLM["arch"], {})
    assert (labels[:, :cfg.num_prefix_embeds] == -100).all()
    lr = float(m["lr"])
    for r, res in enumerate(ranks):
        mesh = rank_mesh(tc.VLM["mesh"], r, ranks)
        got = res["vlm"]
        check_step(got["metrics"], {k: float(v) for k, v in m.items()})
        for n, g in got["grads"].items():
            spec = got["specs"][n]
            wg = grads[n].numpy()
            assert np.abs(g - block(wg, spec, mesh)).max() <= \
                TOL * np.abs(wg).max(), (r, n)
            check_params(got["params"][n], block(want[n], spec, mesh),
                         block(wg, spec, mesh), lr, (r, n))


def test_train_cli_over_a_mesh_restarts_and_follows_an_uninterrupted_run(
        worlds):
    _, ranks, (rc, so, se), _, _ = worlds
    assert rc == 0, se
    lines = so.splitlines()
    assert any("restarts=1" in ln for ln in lines), so
    got = eval([ln for ln in lines if ln.startswith("losses: ")][0][8:])
    want, restarts = ranks[0]["cli"]
    assert restarts == 0 and got == want, (got, want)
    assert all(r["cli"] == ranks[0]["cli"] for r in ranks)


def test_collectives_are_counted_by_kind(worlds):
    _, ranks, _, _, _ = worlds
    for res in ranks:
        seen = res["qwen3-2x2"]["collectives"]
        # the sequence layout gathers and reduce-scatters; the remat'ed
        # units issue their forward collectives again in the backward pass
        for k in ("all_gather/forward", "reduce_scatter/forward",
                  "all_gather/recompute", "reduce_scatter/backward",
                  "all_reduce/forward"):
            assert seen.get(k, 0) > 0, (k, seen)
        assert "reduce_scatter/forward" not in \
            res["qwen3-kv2-1x4"]["collectives"]


def test_slstm_loop_issues_no_collective(worlds):
    """The sLSTM's time loop runs on the rank's heads alone: the xlstm
    step's collectives, counted by kind and pass, are the same at 4 x 64
    and 4 x 32 (and some are made)."""
    _, ranks, _, _, _ = worlds
    for res in ranks:
        by_seq = res[tc.SEQ_CASE]["by_seq"]
        assert list(by_seq) == [tc.S, tc.S // 2]
        assert by_seq[tc.S] == by_seq[tc.S // 2]
        assert by_seq[tc.S].get("all_gather/forward", 0) > 0


def test_meshes_are_laid_out_row_major(worlds):
    _, ranks, _, _, _ = worlds
    for r, res in enumerate(ranks):
        for name, shape in tc.MESHES.items():
            assert res["coords"][name] == mesh_coords(shape, r)


# the cases a RecordingMesh traces: dense on both meshes, the MoE with
# expert parallelism, the hybrid (mamba, attention and MoE)
RECORDED = ("qwen3-2x2", "qwen3-kv2-1x4", "olmoe-ep-2x2", "jamba-ep-2x2")


@pytest.mark.parametrize("name", RECORDED)
def test_recording_mesh_counts_a_train_step(name, worlds):
    """``dryrun.trace_train`` of the case's step on a ``RecordingMesh`` of
    the first and the last rank (their coordinates differ on every axis)
    counts, by kind and pass, the calls and bytes every rank's gloo mesh
    made in the case's first step."""
    _, ranks, _, _, _ = worlds
    c = tc.CASES[name]
    cfg = tc.torch_config(c["arch"], c["over"])
    for r in (0, tc.WORLD - 1):
        tr = dryrun.trace_train(
            cfg, OptimConfig(**tc.OC), ShapeConfig("t", tc.S, tc.B, "train"),
            recording_mesh(tc.MESHES[c["mesh"]], r),
            seq_shard=c["seq_shard"], grad_compression=c["comp"])
        got = {k: [v["calls"], v["bytes"]]
               for k, v in tr.counts.by_kind.items()}
        assert got and all(v["seconds"] == 0.0
                           for v in tr.counts.by_kind.values())
        for q, res in enumerate(ranks):
            assert got == res[name]["step_collectives"], (r, q)
