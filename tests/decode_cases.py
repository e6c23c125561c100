"""What each rank of ``tests/test_torch_decode_ranks.py``'s world runs, the
seeded inputs both sides take, and the JAX side (one subprocess with four
forced XLA devices that writes every output to an ``.npz``).  This module
imports no JAX itself, so a rank starts in a second or two; the JAX side
is a source string run in the subprocess.

Cases, on the ("data", "model") meshes (1, 4) and (2, 2):
  * ``attn``: ``append_sharded`` and ``decode_attention_sharded`` on seeded
    pools, queries and a grouped block table (one case with a sliding
    window);
  * ``logits``: 8 teacher-forced ``decode_step``s of a float32 smoke model
    from JAX's parameters, each rank returning its logits rows and every
    layer's decode states: qwen3-8b at 2 layers (QK-norm included) on both
    meshes, and its 2-KV-head variant on (1, 4), whose ``wk``/``wv``
    replicate; olmoe-1b-7b at 2 layers on (2, 2) and jamba-v0.1-52b at 4
    (mamba, attention and MoE) on both meshes, their experts stationary
    (the largest all-gather of the MoE archs' steps is kept); internvl2-2b
    at 2 layers on (1, 4); xlstm-1.3b at 2 layers (an sLSTM and an mLSTM,
    head-parallel) on both meshes; whisper-tiny (2 + 2 layers) on (2, 2)
    and with 6 heads on (1, 4), whose attention leaves the rules replicate
    over ``"model"``, both from seeded stub frames (``enc_frames``);
  * ``serve``: ``serve`` of qwen3-8b on both meshes, of jamba on (2, 2)
    and of xlstm on (1, 4) from JAX's parameters, each rank returning its
    outputs, steps, page-table trace and leaves; qwen3-8b also on the pod
    mesh ("pod", "data", "model") = (2, 1, 2) (``POD_SERVE_CASES``), whose
    tokens must be JAX's on (1, 4);
  * ``init``: each rank's ``init_params_sharded`` leaves, on every mesh;
  * ``refuse``: whisper's ``serve`` on a mesh of ranks, which refuses
    encoder-decoder archs as on one device (``REFUSED``, the families
    that would refuse a mesh, is empty)."""
import os
import subprocess
import sys
import textwrap

import numpy as np

WORLD = 4
MESHES = {"1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2},
          "2x1x2": {"pod": 2, "data": 1, "model": 2}}
ATTN = dict(B=4, H=4, K=2, hd=8, pt=4, n_pages=4)
ATTN_CASES = {"1x4": 0, "2x2": 0, "1x4-window": 6}     # sliding window
LOGITS = dict(B=2, steps=8, pt=4, horizon=32)
# smoke widths at 2 layers (JAX compiles each mesh's step; time grows with
# depth)
LAYERS = {"num_layers": 2}
# jamba's smoke unit is 4 layers: mamba, MoE, attention, MoE
JAMBA = ("jamba-v0.1-52b", {"num_layers": 4})
LOGITS_CASES = {"qwen3-1x4": ("qwen3-8b", "1x4", {}),
                "qwen3-2x2": ("qwen3-8b", "2x2", {}),
                "qwen3-kv2-1x4": ("qwen3-8b", "1x4", {"num_kv_heads": 2}),
                "olmoe-2x2": ("olmoe-1b-7b", "2x2", {}),
                "jamba-1x4": (JAMBA[0], "1x4", JAMBA[1]),
                "jamba-2x2": (JAMBA[0], "2x2", JAMBA[1]),
                "internvl2-1x4": ("internvl2-2b", "1x4", {}),
                "xlstm-1x4": ("xlstm-1.3b", "1x4", {}),
                "xlstm-2x2": ("xlstm-1.3b", "2x2", {}),
                "whisper-2x2": ("whisper-tiny", "2x2", {}),
                # 6 heads, as published: 6 % 4 != 0 replicates them
                "whisper-h6-1x4": ("whisper-tiny", "1x4",
                                   {"num_heads": 6, "num_kv_heads": 6})}
# stub frames of the encdec cases
ENC_FRAMES = 24
SERVE = dict(batch=4, requests=6, max_new=4, horizon=32, page_tokens=8,
             prompt_len=3)
# name: (arch, mesh, backend, config overrides)
SERVE_CASES = {"1x4": ("qwen3-8b", "1x4", "perf", {}),
               "2x2": ("qwen3-8b", "2x2", "ref", {}),
               "jamba-2x2": (JAMBA[0], "2x2", "perf", JAMBA[1]),
               "xlstm-1x4": ("xlstm-1.3b", "1x4", "perf", {})}
# served over ranks on a mesh JAX does not serve here: name -> (mesh, the
# SERVE_CASES case whose JAX outputs it must give)
POD_SERVE_CASES = {"qwen3-2x1x2": ("2x1x2", "1x4")}
INIT_ARCH = "qwen3-8b"
# the families that refuse a mesh of ranks: none; the serving loop refuses
# encoder-decoder archs on any mesh, as on one device
REFUSED = ()
ENCDEC_ARCH = "whisper-tiny"
# threads of the JAX side, one case each
JAX_THREADS = 8
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def geometry(shape: dict, B: int):
    """(batch axes, channel axes) of JAX's grouped layout on ``shape``."""
    d_batch = shape["data"]
    if B % d_batch == 0 and d_batch > 1:
        return ("data",), ("model",)
    return (), tuple(shape)


def grouped_table(shape: dict, B: int, n_pages: int, pool: int):
    """A (B, n_pages) block table of the grouped layout: sequence b of
    batch group g puts logical page j in arena g * Dm + j % Dm, the
    arena's pages handed out in order."""
    ba, ca = geometry(shape, B)
    groups = int(np.prod([shape[a] for a in ba]))
    dm = int(np.prod([shape[a] for a in ca]))
    pps = pool // (groups * dm)
    used = [0] * (groups * dm)
    bt = np.zeros((B, n_pages), np.int32)
    for b in range(B):
        g = b // (B // groups)
        for j in range(n_pages):
            arena = g * dm + j % dm
            bt[b, j] = arena * pps + used[arena]
            used[arena] += 1
    return bt


def attn_inputs(name: str) -> dict:
    a = ATTN
    rng = np.random.default_rng(7 + len(name))
    shape = MESHES[name.split("-")[0]]
    P = a["B"] * a["n_pages"]
    pool = (P, a["pt"], a["K"], a["hd"])
    bt = grouped_table(shape, a["B"], a["n_pages"], P)
    pos = rng.integers(0, a["n_pages"] * a["pt"], a["B"]).astype(np.int32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(k_pool=f(*pool), v_pool=f(*pool), bt=bt, pos=pos,
                q=f(a["B"], 1, a["H"], a["hd"]),
                k_new=f(a["B"], 1, a["K"], a["hd"]),
                v_new=f(a["B"], 1, a["K"], a["hd"]))


def logits_inputs(name: str):
    """(arch, mesh name, config overrides, tokens (B, steps), block table,
    horizon)."""
    arch, mesh, over = LOGITS_CASES[name]
    L = LOGITS
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 512, (L["B"], L["steps"])).astype(np.int32)
    n_pages = L["horizon"] // L["pt"]
    bt = grouped_table(MESHES[mesh], L["B"], n_pages, L["B"] * n_pages)
    return arch, mesh, over, tokens, bt


def enc_frames(name: str):
    """The seeded stub frames (B, ENC_FRAMES, d) float32 of an encdec
    case, else None."""
    arch, _, over = LOGITS_CASES[name]
    cfg = torch_config(arch, over)
    if not cfg.is_encoder_decoder:
        return None
    rng = np.random.default_rng(13)
    return rng.standard_normal(
        (LOGITS["B"], ENC_FRAMES, cfg.d_model)).astype(np.float32)


def torch_config(arch, over):
    from repro_torch.configs import smoke_config
    return smoke_config(arch).replace(dtype="float32", **{**LAYERS, **over})


def params_path(tmp: str, arch: str, over: dict) -> str:
    tag = arch + "".join(f"-{k}{v}" for k, v in sorted(over.items()))
    return os.path.join(tmp, f"params-{tag}.npz")


def load_tree(path: str) -> dict:
    from repro_torch.models.layers import unflatten_tree
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _attn_rank(mm, name):
    import torch
    from repro_torch.core import paged_kv
    a = ATTN
    x = {k: torch.from_numpy(v) for k, v in attn_inputs(name).items()}
    ba, ca = geometry(mm.shape, a["B"])
    P = a["B"] * a["n_pages"]
    pps = P // mm.num_shards
    flat = mm.index(ba + ca)
    b_loc = a["B"] // mm.size(ba)
    rows = slice(mm.index(ba) * b_loc, (mm.index(ba) + 1) * b_loc)
    kp = x["k_pool"][flat * pps:(flat + 1) * pps].clone()
    vp = x["v_pool"][flat * pps:(flat + 1) * pps].clone()
    cfg = type("Cfg", (), {"sliding_window": ATTN_CASES[name]})
    kp, vp = paged_kv.append_sharded(kp, vp, x["bt"][rows], x["pos"][rows],
                                     x["k_new"][rows], x["v_new"][rows], mm,
                                     ba, ca, pps)
    o = paged_kv.decode_attention_sharded(x["q"][rows], kp, vp,
                                          x["bt"][rows], x["pos"][rows], cfg,
                                          mm, ba, ca, pps)
    return {"o": o.numpy(), "k_pool": kp.numpy(), "v_pool": vp.numpy(),
            "rows": (rows.start, rows.stop), "flat": flat}


def _logits_rank(mm, name, tmp):
    import copy

    import torch
    from repro_torch.configs import ServeConfig, ShapeConfig
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import _new_collectives
    from repro_torch.models import model
    arch, _, over, tokens, bt = logits_inputs(name)
    cfg = torch_config(arch, over)
    L = LOGITS
    full = model.params_from_numpy(cfg, load_tree(
        params_path(tmp, arch, over)), "cpu")
    params = model.shard_params(full, mm)
    scfg = ServeConfig(model=cfg, shape=ShapeConfig(
        "t", L["horizon"], L["B"], "decode"), kv_page_tokens=L["pt"])
    step, ctx = steps.build_serve_step(cfg, scfg, mesh=mm)
    rows = ctx.local_batch(L["B"])
    frames = enc_frames(name)
    kw = {} if frames is None else {
        "enc_frames": torch.from_numpy(frames[rows])}
    states = model.init_decode_states(params, cfg, rows.stop - rows.start,
                                      ctx, kv_dtype=torch.float32, **kw)
    tok = torch.from_numpy(tokens[rows])
    bt_t = torch.from_numpy(bt[rows])
    out, nts = [], []
    # the steps' own collectives, by kind, each kind's largest call kept
    outer = copy.deepcopy(mm.collectives)
    mm.collectives.update(_new_collectives())
    for i in range(L["steps"]):
        pos = torch.full((rows.stop - rows.start,), i, dtype=torch.int32)
        nt, lg, states = step(params, states, tok[:, i:i + 1], pos, bt_t)
        out.append(lg[:, 0].numpy())
        nts.append(nt.numpy())
    steps_coll = copy.deepcopy(mm.collectives)
    mm.collectives.update(outer)
    specs = {n: p.spec for n, p in params.named_parameters()}
    return {"logits": np.stack(out), "next": np.stack(nts),
            "rows": (rows.start, rows.stop),
            "states": [{k: v.numpy() for k, v in s.items()} for s in states],
            "collectives": steps_coll,
            "specs": specs,
            "shapes": {n: tuple(p.shape) for n, p in
                       params.named_parameters()}}


def _serve_rank(mm, name, tmp):
    from repro_torch.core import hashmap, paged_kv
    from repro_torch.launch import serve as tserve
    from repro_torch.models import model
    arch, _, backend, over = SERVE_CASES[name]
    cfg = torch_config(arch, over)
    tree = load_tree(params_path(tmp, arch, over))
    log = []
    cls = paged_kv.PageTableManager
    alloc, free = cls.alloc_seqs, cls.free_seqs

    def alloc_seqs(self, reqs):
        out = alloc(self, reqs)
        log.append(("alloc", [tuple(r) for r in reqs],
                    {s: np.asarray(v).tolist() for s, v in out.items()}))
        return out

    def free_seqs(self, seq_ids):
        log.append(("free", list(seq_ids)))
        return free(self, seq_ids)

    init = model.init_params_sharded
    cls.alloc_seqs, cls.free_seqs = alloc_seqs, free_seqs
    model.init_params_sharded = lambda c, seed, mesh, dev: \
        model.shard_params(model.params_from_numpy(c, tree, dev), mesh)
    try:
        done, mgr, steps = tserve.serve(cfg, mesh=mm, seed=0, verbose=False,
                                        backend=backend, **SERVE)
    finally:
        cls.alloc_seqs, cls.free_seqs = alloc, free
        model.init_params_sharded = init
    return {"out": {r["id"]: r["out"] for r in done}, "steps": steps,
            "log": log, "leaves": hashmap.to_numpy(mgr.hm),
            "free": [list(a) for a in mgr.free],
            "events": (mgr.grow_events, mgr.compact_events,
                       mgr.live_pages())}


def _init_rank(mm):
    from repro_torch.models import model
    cfg = torch_config(INIT_ARCH, {})
    params = model.init_params_sharded(cfg, 3, mm, "cpu")
    return {n: p.detach().numpy().copy() for n, p in
            params.named_parameters()}


def _refuse_rank(mm):
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve as tserve
    out = {}
    for arch in REFUSED + (ENCDEC_ARCH,):
        try:
            tserve.serve(smoke_config(arch), mesh=mm, verbose=False,
                         batch=2, requests=2, max_new=2, horizon=16,
                         page_tokens=8)
            out[arch] = "served"
        except (NotImplementedError, ValueError) as e:
            out[arch] = f"{type(e).__name__}: {e}"
    return out


def decode_world(world, tmp):
    """Every case on this rank, on both meshes of the world (every rank
    makes both meshes and runs every case in the same order)."""
    from repro_torch.launch.mesh import make_model_mesh
    meshes = {n: make_model_mesh(world, s) for n, s in MESHES.items()}
    out = {"coords": {n: m.coords for n, m in meshes.items()}}
    for name in ATTN_CASES:
        out[f"attn/{name}"] = _attn_rank(meshes[name.split("-")[0]], name)
    for name, (_, mesh, _) in LOGITS_CASES.items():
        out[f"logits/{name}"] = _logits_rank(meshes[mesh], name, tmp)
    for name, (_, mesh, _, _) in SERVE_CASES.items():
        out[f"serve/{name}"] = _serve_rank(meshes[mesh], name, tmp)
    for name, (mesh, case) in POD_SERVE_CASES.items():
        out[f"serve/{name}"] = _serve_rank(meshes[mesh], case, tmp)
    for name in MESHES:
        out[f"init/{name}"] = _init_rank(meshes[name])
    out["refuse"] = _refuse_rank(meshes["1x4"])
    out["collectives"] = {n: dict(m.collectives) for n, m in meshes.items()}
    return out


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

JAX_SIDE = """
import sys
sys.path.insert(0, {tests!r})
from concurrent.futures import ThreadPoolExecutor
import numpy as np, jax, jax.numpy as jnp
from repro.configs import ServeConfig, smoke_config
from repro.configs.base import ShapeConfig
from repro.core import paged_kv as jkv
from repro.core.compat import shard_map
from repro.distributed import steps as jsteps
from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh
from repro.models import model as jmodel
from repro.models.transformer import scan_unit_size
from jax.sharding import PartitionSpec as P
import decode_cases as dc
from test_torch_paged_kv import jitted_jax_page_table

THREADS = {threads}
out = {{}}
jmeshes = {{n: make_mesh(tuple(s.values()), tuple(s)) for n, s in
           dc.MESHES.items()}}

def jtree(arch, over):
    return jax.tree.map(jnp.asarray, dc.load_tree(
        dc.params_path({tmp!r}, arch, over)))

for name, window in dc.ATTN_CASES.items():
    mesh = jmeshes[name.split("-")[0]]
    x = dc.attn_inputs(name)
    ba, ca = dc.geometry(dict(mesh.shape), dc.ATTN["B"])
    pps = x["k_pool"].shape[0] // mesh.size
    cfg = smoke_config("llama3-8b").replace(sliding_window=window)

    def inner(k_pool, v_pool, q, k_new, v_new, bt, pos):
        k_pool, v_pool = jkv.append_sharded(k_pool, v_pool, bt, pos, k_new,
                                            v_new, ba, ca, pps)
        o = jkv.decode_attention_sharded(q, k_pool, v_pool, bt, pos, cfg,
                                         ba, ca, pps)
        return k_pool, v_pool, o
    pool_spec = P(tuple(ba) + tuple(ca))
    bspec = P(ba if ba else None)
    kp, vp, o = jax.jit(shard_map(
        inner, mesh=mesh,
        in_specs=(pool_spec, pool_spec, bspec, bspec, bspec, bspec, bspec),
        out_specs=(pool_spec, pool_spec, bspec), check_vma=False))(
        x["k_pool"], x["v_pool"], x["q"], x["k_new"], x["v_new"], x["bt"],
        x["pos"])
    out[f"attn/{{name}}/o"] = np.asarray(o)
    out[f"attn/{{name}}/k_pool"] = np.asarray(kp)
    out[f"attn/{{name}}/v_pool"] = np.asarray(vp)

def logits_case(name):
    arch, mname, over, tokens, bt = dc.logits_inputs(name)
    cfg = smoke_config(arch).replace(dtype="float32", **{{**dc.LAYERS,
                                                          **over}})
    L = dc.LOGITS
    scfg = ServeConfig(model=cfg, shape=ShapeConfig(
        "t", L["horizon"], L["B"], "decode"), kv_page_tokens=L["pt"])
    _, jitted, ctx, _ = jsteps.build_serve_step(cfg, scfg, jmeshes[mname])
    params = jtree(arch, over)
    frames = dc.enc_frames(name)
    kw = {{}} if frames is None else {{"enc_frames": jnp.asarray(frames)}}
    states = jmodel.init_decode_states(params, cfg, L["B"], ctx,
                                       kv_dtype=jnp.float32, **kw)
    fn = jitted(states)
    lg, nts = [], []
    for i in range(L["steps"]):
        nt, logits, states = fn(params, states, jnp.asarray(tokens[:, i:i + 1]),
                                jnp.full((L["B"],), i, jnp.int32),
                                jnp.asarray(bt))
        lg.append(np.asarray(logits[:, 0]))
        nts.append(np.asarray(nt))
    out[f"logits/{{name}}/logits"] = np.stack(lg)
    out[f"logits/{{name}}/next"] = np.stack(nts)
    if cfg.is_encoder_decoder:
        # one state a leaf, stacked by decoder layer
        for key, a in states.items():
            for layer, blk in enumerate(np.asarray(a)):
                out[f"logits/{{name}}/L{{layer}}/{{key}}"] = blk
        return
    unit = scan_unit_size(cfg)
    for j in range(unit):
        for key, a in states[f"j{{j}}"].items():
            for u, blk in enumerate(np.asarray(a)):
                out[f"logits/{{name}}/L{{u * unit + j}}/{{key}}"] = blk


def serve_case(name):
    arch, mname, backend, over = dc.SERVE_CASES[name]
    cfg = smoke_config(arch).replace(dtype="float32", **{{**dc.LAYERS,
                                                          **over}})
    done, mgr, steps = jserve.serve(cfg, jmeshes[mname], seed=0,
                                    verbose=False, backend=backend,
                                    **dc.SERVE)
    for r in done:
        out[f"serve/{{name}}/out{{r['id']}}"] = np.asarray(r["out"])
    out[f"serve/{{name}}/steps"] = np.asarray(steps)


# every case in a thread of its own, so their compiles overlap, the serves
# (the longest) first; a serve draws its case's parameters, any other
# config JAX's own
serve_params = {{smoke_config(arch).replace(
    dtype="float32", **{{**dc.LAYERS, **over}}): jtree(arch, over)
    for arch, _, _, over in dc.SERVE_CASES.values()}}
mp = jitted_jax_page_table()
init_params = jmodel.init_params
mp.setattr(jmodel, "init_params", lambda c, key: serve_params[c]
           if c in serve_params else init_params(c, key))
try:
    with ThreadPoolExecutor(THREADS) as ex:
        jobs = [ex.submit(serve_case, n) for n in dc.SERVE_CASES]
        jobs += [ex.submit(logits_case, n) for n in dc.LOGITS_CASES]
        for j in jobs:
            j.result()
finally:
    mp.undo()
np.savez({path!r}, **out)
print("JAX OK")
"""


def start_jax_side(tmp: str):
    """Start the JAX side, which reads the parameters under ``tmp`` and
    writes ``{tmp}/jax.npz``; ``finish_jax_side`` waits for it."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"),
                                         os.path.join(ROOT, "tests")])
    path = os.path.join(tmp, "jax.npz")
    code = JAX_SIDE.format(tests=os.path.join(ROOT, "tests"), tmp=tmp,
                           path=path, threads=JAX_THREADS)
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env), path


def finish_jax_side(proc) -> dict:
    proc, path = proc
    so, se = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
