"""The port's decode serving loop (``repro_torch.launch.serve.serve``)
against the JAX package's ``serve`` on the same model parameters (JAX's
init carried across by ``params_from_numpy``), float32: the same generated
tokens for every request, the same number of steps, the same page-table
call trace (every ``alloc_seqs`` with the pages it returned, every
``free_seqs``), the same grow and compact events and the page table's
leaves equal bit for bit at the end; for the dense archs and for
olmoe-1b-7b and jamba-v0.1-52b, whose served tokens depend on two things
JAX's ``serve`` does on purpose: idle slots take part in MoE routing (and
its capacity), and a reused slot's mamba states are not reset; and for
xlstm-1.3b (a reused slot keeps its mLSTM and sLSTM states too) and
internvl2-2b (decoding tokens only).  JAX decodes on its serving CLI's
(1, 1) mesh, through ``shard_map``; the port through its gather path.

Tokens are compared exactly: both sides are float32 and the logits agree
to about 1e-6 (``tests/test_torch_models.py``; <= 1.8e-6 for the moe and
hybrid families, ``tests/test_torch_families.py``), far inside the gaps
between the top two logits of these runs, which the test checks: > 1e-4
for the dense archs, > 2e-5 (ten times that agreement) for olmoe and
jamba, whose smallest gap is 9.2e-5.
Also: determinism, the CLI's decode mode, JAX's ``serve`` failing on
whisper where the port refuses it, and the ``serve_paged`` example."""
import jax
import numpy as np
import pytest

from repro.configs import smoke_config as j_smoke_config
from repro.core import paged_kv as jkv
from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh
from repro.models import model as jmodel

from repro_torch.configs import smoke_config
from repro_torch.core import hashmap
from repro_torch.core import paged_kv as tkv
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel

from test_torch_hashmap import jax_leaves
from test_torch_paged_kv import jitted_jax_page_table
import torch_threads

one_thread = torch_threads.one_thread

CPU = "cpu"

SCENARIOS = {
    "llama3-8b-ref": ("llama3-8b", "ref", dict(
        batch=4, requests=6, max_new=5, horizon=64, page_tokens=8,
        prompt_len=4)),
    "qwen3-8b-perf": ("qwen3-8b", "perf", dict(
        batch=3, requests=7, max_new=4, horizon=32, page_tokens=8,
        prompt_len=3)),
    # two-token pages and a short horizon: sequences hit the horizon, pages
    # recycle within a step, and idle slots append into recycled pages
    "llama3-8b-perf-churn": ("llama3-8b", "perf", dict(
        batch=4, requests=9, max_new=9, horizon=12, page_tokens=2,
        prompt_len=2)),
    # the moe and hybrid families: idle slots route with the live ones, and
    # a reused slot keeps its mamba states, as in JAX
    "olmoe-1b-7b-perf": ("olmoe-1b-7b", "perf", dict(
        batch=3, requests=7, max_new=4, horizon=32, page_tokens=8,
        prompt_len=3)),
    "jamba-v0.1-52b-perf": ("jamba-v0.1-52b", "perf", dict(
        batch=3, requests=7, max_new=5, horizon=32, page_tokens=8,
        prompt_len=3)),
    # the ssm and vlm families: a reused slot keeps its mLSTM and sLSTM
    # states; internvl2 decodes tokens only
    "xlstm-1.3b-perf": ("xlstm-1.3b", "perf", dict(
        batch=3, requests=7, max_new=5, horizon=32, page_tokens=8,
        prompt_len=3)),
    "internvl2-2b-perf": ("internvl2-2b", "perf", dict(
        batch=3, requests=7, max_new=4, horizon=32, page_tokens=8,
        prompt_len=3)),
}


MIN_GAP = {"olmoe-1b-7b-perf": 2e-5, "jamba-v0.1-52b-perf": 2e-5}


def _trace(monkeypatch, cls, log):
    alloc, free = cls.alloc_seqs, cls.free_seqs

    def alloc_seqs(self, reqs):
        out = alloc(self, reqs)
        log.append(("alloc", list(reqs),
                    {s: np.asarray(v).tolist() for s, v in out.items()}))
        return out

    def free_seqs(self, seq_ids):
        log.append(("free", list(seq_ids)))
        return free(self, seq_ids)

    monkeypatch.setattr(cls, "alloc_seqs", alloc_seqs)
    monkeypatch.setattr(cls, "free_seqs", free_seqs)


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def served(request):
    arch, backend, kw = SCENARIOS[request.param]
    jcfg = j_smoke_config(arch).replace(dtype="float32")
    cfg = smoke_config(arch).replace(dtype="float32")
    # JAX's init, eager: the scenarios share most leaf shapes, so their
    # draws share compiled primitives where one jitted init each would not;
    # JAX's serve is handed the same parameters (its seed 0 draws them from
    # PRNGKey(0))
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    jlog, tlog, gaps, dups = [], [], [], []
    mp = jitted_jax_page_table()
    try:
        mp.setattr(jmodel, "init_params", lambda c, key: jparams)
        _trace(mp, jkv.PageTableManager, jlog)
        jdone, jmgr, jsteps = jserve.serve(
            jcfg, make_mesh((1, 1), ("data", "model")), backend=backend,
            seed=0, verbose=False, **kw)
        _trace(mp, tkv.PageTableManager, tlog)
        mp.setattr(tmodel, "init_params", lambda c, seed, dev:
                   tmodel.params_from_numpy(c, tree, device=dev))
        step = tmodel.decode_step

        def decode_step(params, c, states, tokens, pos, bt, ctx):
            logits, states = step(params, c, states, tokens, pos, bt, ctx)
            top2 = logits[:, -1].topk(2, dim=-1).values
            gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
            return logits, states

        append = tkv.append

        def count_dups(k_pool, v_pool, bt, pos, k_new, v_new):
            pt = k_pool.shape[1]
            j = (pos // pt).long()
            keep = j < bt.shape[1]
            page = bt.gather(1, j.clamp(max=bt.shape[1] - 1)[:, None])[:, 0]
            idx = (page.long() * pt + pos.long() % pt)[keep]
            dups.append(int(idx.numel() - idx.unique().numel()))
            return append(k_pool, v_pool, bt, pos, k_new, v_new)

        mp.setattr(tmodel, "decode_step", decode_step)
        mp.setattr(tkv, "append", count_dups)
        tdone, tmgr, tsteps = tserve.serve(cfg, backend=backend, seed=0,
                                           verbose=False, device=CPU, **kw)
    finally:
        mp.undo()
    return dict(name=request.param, kw=kw, j=(jdone, jmgr, jsteps, jlog),
                t=(tdone, tmgr, tsteps, tlog), gaps=gaps, dups=dups)


def test_serve_outputs_and_steps_match_jax(served):
    jdone, _, jsteps, _ = served["j"]
    tdone, _, tsteps, _ = served["t"]
    assert tsteps == jsteps
    assert len(tdone) == len(jdone) == served["kw"]["requests"]
    for a, b in zip(tdone, jdone):
        assert (a["id"], a["prompt"], a["out"]) == (b["id"], b["prompt"],
                                                    b["out"])
    assert min(served["gaps"]) > MIN_GAP.get(served["name"], 1e-4)


def test_serve_page_table_trace_and_leaves_match_jax(served):
    _, jmgr, _, jlog = served["j"]
    _, tmgr, _, tlog = served["t"]
    assert tlog == jlog
    assert (tmgr.grow_events, tmgr.compact_events, tmgr.live_pages()) == \
        (jmgr.grow_events, jmgr.compact_events, jmgr.live_pages()) \
        == (tmgr.grow_events, tmgr.compact_events, 0)
    assert [list(a) for a in tmgr.free] == [list(a) for a in jmgr.free]
    got, want = hashmap.to_numpy(tmgr.hm), jax_leaves(jmgr.hm)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if served["name"].endswith("churn"):   # the case the append resolves
        assert sum(served["dups"]) > 0


def test_serve_is_deterministic():
    cfg = smoke_config("qwen3-8b")
    kw = dict(batch=2, requests=3, max_new=3, horizon=32, page_tokens=8,
              prompt_len=3, seed=5, verbose=False, device=CPU)
    a, _, sa = tserve.serve(cfg, **kw)
    b, _, sb = tserve.serve(cfg, **kw)
    assert sa == sb and [r["out"] for r in a] == [r["out"] for r in b]
    assert all(len(r["out"]) == 3 for r in a)
    assert all(0 <= tok < cfg.padded_vocab for r in a for tok in r["out"])


def test_serve_cli_decode_mode(capsys):
    tserve.main(["--mode", "decode", "--arch", "llama3-8b", "--smoke",
                 "--device", CPU, "--requests", "3", "--batch", "2",
                 "--max-new", "3", "--horizon", "32", "--page-tokens", "8"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert "live pages after drain: 0" in out


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "internvl2-2b"])
def test_serve_cli_decodes_the_ssm_and_vlm_families(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", CPU, "--requests",
                 "3", "--batch", "2", "--max-new", "3", "--horizon", "32",
                 "--page-tokens", "8"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert "live pages after drain: 0" in out


def test_serve_paged_example(capsys):
    from repro_torch import serve_paged
    done, mgr, steps = serve_paged.main(["--device", CPU])
    assert len(done) == 10 and all(len(r["out"]) == 12 for r in done)
    assert mgr.live_pages() == 0 and mgr.hm.config.backend == "perf"
    assert "page-table state after drain: live=0" in capsys.readouterr().out


def test_serve_refuses_encdec_as_jax_fails():
    """JAX's ``serve`` cannot serve whisper: it builds the decode states
    without ``enc_frames`` (``src/repro/launch/serve.py:57``) and the
    encdec branch calls ``.astype`` on None.  The port refuses the same
    arch with an error that names the limitation."""
    jcfg = j_smoke_config("whisper-tiny").replace(dtype="float32")
    with pytest.raises(AttributeError, match="astype"):
        jserve.serve(jcfg, make_mesh((1, 1), ("data", "model")), batch=2,
                     requests=2, max_new=2, horizon=16, page_tokens=8,
                     verbose=False)
    cfg = smoke_config("whisper-tiny").replace(dtype="float32")
    with pytest.raises(ValueError, match="src/repro/launch/serve.py:57"):
        tserve.serve(cfg, batch=2, requests=2, max_new=2, horizon=16,
                     page_tokens=8, verbose=False, device=CPU)
