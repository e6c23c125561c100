"""Decode over a ("data", "model") mesh of ranks (``launch.mesh.ModelMesh``,
``torch.distributed`` over gloo on the CPU) against the JAX package's
decode on a mesh of four forced XLA devices, on (1, 4) and (2, 2).

ONE world of 4 spawned CPU ranks runs every case of ``tests/decode_cases.py``
on both meshes while ONE JAX subprocess runs JAX's side of them; both start
from the same JAX parameters (drawn here, written to ``.npz``; the ranks
carry them across with ``params_from_numpy`` and ``shard_params``):
  * ``append_sharded`` and ``decode_attention_sharded`` on each rank
    against JAX's inside ``shard_map``: the output rows within 1e-5, the
    pools, joined in the grouped order, equal;
  * 8 float32 ``decode_step``s through the serve step: every rank's logits
    rows within 1e-5 of JAX's, the greedy tokens equal, the pools joined
    and each rank's mamba ``conv``/``ssm`` blocks within 1e-5 of JAX's
    (qwen3-8b smoke at 2 layers on both meshes, and its 2-KV-head variant,
    whose ``wk``/``wv`` the rules replicate on 4 ranks; olmoe-1b-7b on
    (2, 2), jamba-v0.1-52b at 4 layers on both meshes, internvl2-2b on
    (1, 4), xlstm-1.3b at 2 layers on both meshes, each rank's blocks of
    every mLSTM (C, n, m) and sLSTM (c, n, h, m) within 1e-5 of JAX's,
    whisper-tiny on (2, 2) and with 6 heads on (1, 4), whose attention
    leaves replicate over ``"model"``, from the same stub frames, each
    rank's cross ``ek``/``ev`` block within 1e-5 of JAX's); the MoE archs'
    steps gather no expert weight;
  * ``serve``: every rank's outputs and steps equal JAX's ``serve`` on
    the same mesh (qwen3-8b on both meshes, jamba on (2, 2), xlstm on
    (1, 4)), and every rank's page-table trace (so its block tables),
    leaves and free lists equal rank 0's;
  * ``init_params_sharded``: every rank's blocks equal the slices of
    ``init_params`` on the same device;
  * no family refuses a mesh; whisper's ``serve`` on a mesh of ranks
    refuses encoder-decoder archs as on one device (``refuse_encdec``);
  * the CLI's ``--mesh 2 2`` serves from four rank processes;
  * the dry-run's ``RecordingMesh`` trace of one decode step, on fake
    tensors, counts what every rank's gloo mesh sent a step in the logits
    cases, call for call and byte for byte by kind (dense on both meshes
    and with replicated KV heads, the MoE experts stationary, the
    hybrid).
float32 on both sides; the tolerance covers the order of the partial
sums."""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import model as jmodel

from repro_torch.configs import ServeConfig, ShapeConfig, smoke_config
from repro_torch.distributed import sharding, steps
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import ModelMesh, recording_mesh, spawn_ranks
from repro_torch.models import model
from repro_torch.models.layers import flatten_tree

import decode_cases as dc

TOL = 1e-5
CLI_ARGS = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--requests",
            "3", "--batch", "2", "--max-new", "3", "--horizon", "32",
            "--page-tokens", "8"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(JAX's outputs, each rank's results, the serve CLI's completed
    process)."""
    tmp = str(tmp_path_factory.mktemp("decode"))
    models = {(arch, tuple(sorted(over.items())))
              for arch, _, _, over in dc.SERVE_CASES.values()} | {
        (arch, tuple(sorted(over.items())))
        for arch, _, over in dc.LOGITS_CASES.values()}
    init = jax.jit(jmodel.init_params, static_argnums=0)

    def draw(arch, over):
        jcfg = j_smoke_config(arch).replace(dtype="float32",
                                            **{**dc.LAYERS, **dict(over)})
        tree = jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(0)))
        np.savez(dc.params_path(tmp, arch, dict(over)), **flatten_tree(tree))
    # the draws compile apart, in threads of their own
    with ThreadPoolExecutor(len(models)) as ex:
        for f in [ex.submit(draw, *m) for m in sorted(models)]:
            f.result()
    proc = dc.start_jax_side(tmp)
    try:
        with ThreadPoolExecutor(1) as ex:
            ranks = ex.submit(spawn_ranks, dc.decode_world, dc.WORLD, tmp,
                              device="cpu", timeout=300).result()
        # after the world, while JAX compiles
        env = dict(os.environ, PYTHONPATH=os.path.join(dc.ROOT, "src"))
        cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                              *CLI_ARGS, "--mesh", "2", "2"],
                             capture_output=True, text=True, env=env,
                             timeout=300)
    except BaseException:
        proc[0].kill()
        raise
    return dc.finish_jax_side(proc), ranks, cli


@pytest.mark.parametrize("name", list(dc.ATTN_CASES))
def test_channel_parallel_cache_matches_jax(name, worlds):
    jax_out, ranks, _ = worlds
    res = [r[f"attn/{name}"] for r in ranks]
    # the grouped order, flat = g * Dm + m, is the rank's on a 2-D mesh
    assert [r["flat"] for r in res] == list(range(dc.WORLD))
    want = jax_out[f"attn/{name}/o"]
    for r in res:
        a, b = r["rows"]
        np.testing.assert_allclose(r["o"], want[a:b], rtol=0, atol=TOL)
    for pool in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(
            np.concatenate([r[pool] for r in res]),
            jax_out[f"attn/{name}/{pool}"])


@pytest.mark.parametrize("name", list(dc.LOGITS_CASES))
def test_decode_step_logits_match_jax(name, worlds):
    jax_out, ranks, _ = worlds
    res = [r[f"logits/{name}"] for r in ranks]
    want = jax_out[f"logits/{name}/logits"]
    for r in res:
        a, b = r["rows"]
        assert r["logits"].shape == want[:, a:b].shape
        np.testing.assert_allclose(r["logits"], want[:, a:b], rtol=0,
                                   atol=TOL)
        np.testing.assert_array_equal(r["next"],
                                      jax_out[f"logits/{name}/next"])
    arch, mesh, over, _, _ = dc.logits_inputs(name)
    cfg = dc.torch_config(arch, over)
    for i, layer in enumerate(res[0]["states"]):
        for key in layer:
            jp = jax_out[f"logits/{name}/L{i}/{key}"]
            if key in ("k_pool", "v_pool"):
                got = np.concatenate([r["states"][i][key] for r in res])
                np.testing.assert_allclose(got, jp, rtol=0, atol=TOL)
                assert np.array_equal(got.any(axis=(1, 2, 3)),
                                      jp.any(axis=(1, 2, 3)))
                continue
            # a recurrent state: the rank's rows and its d_inner channels
            # (mamba) or heads (xLSTM); the cross K/V its rows and KV heads
            # where they divide "model"
            axes = steps._STATE_AXES[(key, jp.ndim)]
            spec = sharding.spec_for(dc.MESHES[mesh], axes, jp.shape)
            if key in ("ek", "ev"):
                assert (spec[2:3] == ("model",)) == \
                    (cfg.num_kv_heads % dc.MESHES[mesh]["model"] == 0), spec
            else:
                assert spec[-1 if key == "conv" else 1] == "model", (key,
                                                                     spec)
            for r, got in enumerate(res):
                mm = ModelMesh(dc.MESHES[mesh], r, ranks[r]["coords"][mesh],
                               torch.device("cpu"), "gloo", {})
                want = sharding.local_block(torch.from_numpy(jp), spec,
                                            mm).numpy()
                assert got["states"][i][key].shape == want.shape
                np.testing.assert_allclose(got["states"][i][key], want,
                                           rtol=0, atol=TOL,
                                           err_msg=f"rank {r} L{i} {key}")
    specs, shapes = res[0]["specs"], res[0]["shapes"]
    if cfg.num_experts:
        # the experts stay where they lie: no all-gather as large as one
        # MoE layer's expert blocks (a gather of the layer packs them)
        per_layer: dict = {}
        for n, shp in shapes.items():
            layer, _, leaf = n.partition(".ffn_moe.")
            if leaf in ("gate", "up", "down"):
                per_layer[layer] = per_layer.get(layer, 0) + 4 * int(
                    np.prod(shp))
        blocks = min(per_layer.values())
        for r in res:
            big = max(v.get("largest", 0) for k, v in
                      r["collectives"]["by_kind"].items()
                      if k.startswith("all_gather/"))
            assert 0 < big < blocks, (big, blocks)
    M = dc.MESHES[mesh]["model"]
    if cfg.is_encoder_decoder:
        # the heads of every attention leaf on "model" where they divide
        # it, replicated where they do not (6 heads on 4 ranks)
        split = cfg.num_heads % M == 0
        for n in ("encoder.0.attn.wq", "decoder.0.attn.wo",
                  "decoder.0.cross.wq", "decoder.1.cross.wk"):
            axis = 0 if n.endswith("wo") else 1
            assert (specs[n][axis:axis + 1] == ("model",)) == split, n
            assert shapes[n][axis] == cfg.num_heads // (M if split else 1)
        assert split == (name != "whisper-h6-1x4")
        return
    if "units.0.j0.attn.wq" not in specs:
        return
    assert specs["units.0.j0.attn.wq"][1] == "model"
    assert shapes["units.0.j0.attn.wq"][1] == cfg.num_heads // M
    kv_split = cfg.num_kv_heads % M == 0
    assert (specs["units.0.j0.attn.wk"][1:2] == ("model",)) == kv_split
    assert shapes["units.0.j0.attn.wk"][1] == \
        cfg.num_kv_heads // (M if kv_split else 1)
    if name == "qwen3-kv2-1x4":
        assert not kv_split


@pytest.mark.parametrize("name", list(dc.SERVE_CASES))
def test_serve_over_ranks_matches_jax(name, worlds):
    jax_out, ranks, _ = worlds
    res = [r[f"serve/{name}"] for r in ranks]
    want = {int(k.rsplit("out", 1)[1]): v.tolist()
            for k, v in jax_out.items() if k.startswith(f"serve/{name}/out")}
    assert len(want) == dc.SERVE["requests"]
    for r, got in enumerate(res):
        assert got["out"] == want, f"rank {r}"
        assert got["steps"] == int(jax_out[f"serve/{name}/steps"])
        assert got["events"][2] == 0
        assert got["log"] == res[0]["log"], f"rank {r}: block tables differ"
        assert got["free"] == res[0]["free"]
        assert got["leaves"].keys() == res[0]["leaves"].keys()
        for n, a in got["leaves"].items():
            np.testing.assert_array_equal(a, res[0]["leaves"][n], err_msg=n)


@pytest.mark.parametrize("name", list(dc.MESHES))
def test_init_params_sharded_equals_slices(name, worlds):
    _, ranks, _ = worlds
    cfg = dc.torch_config(dc.INIT_ARCH, {})
    full = dict(model.init_params(cfg, 3, "cpu").named_parameters())
    axes = model.leaf_axes(model.Model(cfg, "meta"))
    shape = dc.MESHES[name]
    for r, res in enumerate(ranks):
        mesh = ModelMesh(shape, r, res["coords"][name], torch.device("cpu"),
                         "gloo", {})
        got = res[f"init/{name}"]
        assert got.keys() == full.keys()
        for n, w in full.items():
            spec = sharding.spec_for(shape, axes[n], w.shape)
            want = sharding.local_block(w.detach(), spec, mesh).numpy()
            np.testing.assert_array_equal(got[n], want, err_msg=n)
            assert got[n].size * mesh.size(
                [a for e in spec for a in sharding.entry_axes(e)]) == w.numel()


def test_other_families_refuse_to_decode_over_ranks(worlds):
    """No family refuses a mesh of ranks: the step builds for every family
    on a bare shape of more than one shard, and whisper's ``serve`` on a
    mesh of ranks refuses encoder-decoder archs with the error it gives on
    one device (the reference's serving loop cannot serve them; whisper
    decodes over ranks at the library level, ``LOGITS_CASES``)."""
    from repro_torch.launch import serve as tserve
    _, ranks, _ = worlds
    assert dc.REFUSED == ()
    cfg = smoke_config(dc.ENCDEC_ARCH)
    with pytest.raises(ValueError) as one_device:
        tserve.serve(cfg, device="cpu", verbose=False, batch=2, requests=2,
                     max_new=2, horizon=16, page_tokens=8)
    want = f"ValueError: {one_device.value}"
    assert "enc_frames" in want
    for r in ranks:
        assert r["refuse"] == {dc.ENCDEC_ARCH: want}
    for arch in ("xlstm-1.3b", dc.ENCDEC_ARCH):
        cfg = smoke_config(arch)
        scfg = ServeConfig(model=cfg, shape=ShapeConfig("t", 16, 2, "decode"),
                           kv_page_tokens=8)
        for shape in ({"data": 1, "model": 2}, {"data": 1, "model": 1}):
            _, ctx = steps.build_serve_step(cfg, scfg, mesh=shape)
            assert ctx.mesh == shape


def test_collectives_are_counted(worlds):
    _, ranks, _ = worlds
    for r in ranks:
        for name, st in r["collectives"].items():
            assert st["calls"] > 0 and st["bytes"] > 0, name


def test_serve_cli_decodes_over_a_mesh_of_ranks(worlds):
    """``--mesh 2 2``: four rank processes on the CPU (gloo) serve every
    request and drain the page table; rank 0 alone prints.  (The smoke
    config decodes in bfloat16, whose row-parallel partial sums round
    apart from one device's; the float32 cases above hold the tokens.)
    The fixture runs it, after the world."""
    _, _, r = worlds
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert sum(ln.startswith("served 3 requests") for ln in lines) == 1
    assert "live pages after drain: 0" in r.stdout
    assert sum("-> out [" in ln for ln in lines) == 3


# the logits cases a RecordingMesh traces
RECORDED = ("qwen3-1x4", "qwen3-2x2", "qwen3-kv2-1x4", "olmoe-2x2",
            "jamba-1x4", "jamba-2x2")


@pytest.mark.parametrize("name", RECORDED)
def test_recording_mesh_counts_a_decode_step(name, worlds):
    """``dryrun.trace_decode`` of one step (float32 pools, the whole
    vocabulary's logits, as the case runs it) on a ``RecordingMesh`` of
    the first and the last rank: its calls and bytes by kind, times the
    case's steps, and its largest call, are what every rank's gloo mesh
    counted over them."""
    _, ranks, _ = worlds
    arch, mesh, over = dc.LOGITS_CASES[name]
    cfg = dc.torch_config(arch, over)
    L = dc.LOGITS
    scfg = ServeConfig(model=cfg, shape=ShapeConfig(
        "t", L["horizon"], L["B"], "decode"), kv_page_tokens=L["pt"])
    for r in (0, dc.WORLD - 1):
        tr = dryrun.trace_decode(cfg, scfg, recording_mesh(dc.MESHES[mesh], r),
                                 kv_dtype=torch.float32, full_logits=True)
        got = {k: (v["calls"] * L["steps"], v["bytes"] * L["steps"],
                   v["largest"]) for k, v in tr.counts.by_kind.items()}
        assert got
        for q, res in enumerate(ranks):
            want = res[f"logits/{name}"]["collectives"]["by_kind"]
            assert got == {k: (v["calls"], v["bytes"], v["largest"])
                           for k, v in want.items()}, (r, q)
