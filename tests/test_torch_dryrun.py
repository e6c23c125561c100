"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), which lowers and compiles a cell where
the port traces it on fake tensors over a ``RecordingMesh``.

  * (a) ``cells()``, ``LONG_CONTEXT_ARCHS`` and ``report_name`` are JAX's;
  * (c) one JAX subprocess with ``REPRO_HOST_DEVICES=4`` and
    ``REPRO_MESH=2,2`` binds ``dryrun.get_config`` to the smoke configs
    (attention chunks of ``ATTN_CHUNK``, so the unrolled cost probe compiles
    in seconds) and runs ``lower_cell``/``analyze`` on qwen3-8b's
    ``train_4k`` and ``decode_32k`` ``unit1`` probes (one layer, no scan,
    so XLA counts every op once); the port traces the same cells:
      - the argument bytes: the train cell's equal JAX's; the decode
        cell's exceed them by the norm scales alone, which the port keeps
        in float32 (``RMSNorm``, ``q_scale``/``k_scale``) where JAX casts
        them to the bfloat16 inference ``param_dtype``;
      - the FLOPs: the port's count is ``FlopCounterMode``'s, matmuls
        only; XLA's cost analysis also counts every elementwise op and
        reduction.  In training those are a few percent (the norms, rope,
        the softmax), and the port's remat recomputes no unit's last
        matmul (below): port / JAX in ``TRAIN_BAND`` (0.925 measured).  A
        decode step's matmuls take one token a row, while the attention's
        elementwise ops run over the whole 32768-position horizon of every
        row and head: port / JAX in ``DECODE_BAND`` (0.249 measured);
  * the traced FLOPs of a dense smoke train step on one device against
    ``train_flops``: equal to 1e-9 once two differences are counted: the
    port's chunked attention computes every (q, k) pair of a chunk (the
    causal mask zeroes them; ``train_flops`` counts the causal ones), and
    PyTorch's non-reentrant checkpoint stops its recompute once it has
    every tensor the backward needs, so no unit's last matmul (the FFN's
    ``down``) is recomputed;
  * the sLSTM extrapolation: xlstm's smoke train and prefill steps (one
    unit: an sLSTM and an mLSTM) at 32 tokens traced whole equal the linear extrapolation from 8 and 16
    sLSTM steps, FLOPs and bytes exactly, the peak memory estimate within
    ``MEMORY_TOL`` (the prefill's is 3.0% low: its peak moves to another
    point of the step as the steps grow); at 64 (train) and 256 (prefill)
    tokens the extrapolated peak is at most the whole trace's, the lower
    bound ``dryrun._extrapolate`` states (``tools/slstm_peak_check.py``
    prints the ratios); a step limit that does not take raises;
  * (d) the CLI at published widths on ``REPRO_MESH=2,2``: h2o-danube-1.8b
    ``decode_32k`` ``full`` writes a record with ``n_pages >= 1``;
    ``train_4k``'s ``unit2`` FLOPs exceed ``unit1``'s by more than 5%
    (``tests/test_dryrun_small.py``'s check); a cell that raises writes
    ``ok: false`` and the CLI exits 1.
``RecordingMesh``'s counts against a real gloo mesh's are held in
``tests/test_torch_train_ranks.py`` and ``tests/test_torch_decode_ranks.py``,
whose spawned worlds they use.  The JAX dry-run module is imported only in
the subprocess: it sets ``XLA_FLAGS`` when imported."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs import LONG_CONTEXT_ARCHS as J_LONG
from repro.configs import cells as j_cells

from repro_torch.configs import LONG_CONTEXT_ARCHS, OptimConfig, \
    ShapeConfig, cells, smoke_config
from repro_torch.launch import dryrun
from repro_torch.models import model

import torch_threads

one_thread = torch_threads.one_thread

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ATTN_CHUNK = 1024
JAX_CELLS = (("qwen3-8b", "train_4k", "unit1"),
             ("qwen3-8b", "decode_32k", "unit1"))
TRAIN_BAND = (0.85, 1.0)
DECODE_BAND = (0.2, 0.3)
NAMES = (("qwen3-8b", "train_4k", "single", "full"),
         ("xlstm-1.3b", "long_500k", "multi", "unit2"))
CLI_ARCH = "h2o-danube-1.8b"
MEMORY_TOL = 0.05

JAX_SIDE = """
import json
from repro.configs import smoke_config
from repro.launch import dryrun
dryrun.get_config = lambda a: smoke_config(a).replace(
    attn_chunk={chunk})
mesh = dryrun._mesh_for("single")
out = {{"names": [dryrun.report_name(*n) for n in {names!r}]}}
for arch, shape, probe in {cells!r}:
    compiled, meta = dryrun.lower_cell(arch, shape, mesh, probe)
    out["/".join((arch, shape, probe))] = dryrun.analyze(compiled, meta)
with open({path!r}, "w") as f:
    json.dump(out, f)
"""


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **kw)


class Runs:
    """The subprocesses, started together; ``result(name)`` waits for
    one."""

    def __init__(self, tmp):
        self.tmp, self.procs, self.done = tmp, {}, {}
        path = os.path.join(tmp, "jax.json")
        code = JAX_SIDE.format(chunk=ATTN_CHUNK, names=NAMES,
                               cells=JAX_CELLS, path=path)
        self.procs["jax"] = (subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(REPRO_HOST_DEVICES="4", REPRO_MESH="2,2",
                     JAX_PLATFORMS="cpu")), path)
        for name, arch, shape, probe in (
                ("decode", CLI_ARCH, "decode_32k", "full"),
                ("unit1", CLI_ARCH, "train_4k", "unit1"),
                ("unit2", CLI_ARCH, "train_4k", "unit2"),
                ("raises", "no-such-arch", "decode_32k", "full")):
            out = os.path.join(tmp, name)
            self.procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", "single", "--probe", probe,
                 "--out", out], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=_env(REPRO_MESH="2,2", OMP_NUM_THREADS="1")),
                os.path.join(out, dryrun.report_name(arch, shape, "single",
                                                     probe)))

    def result(self, name):
        """(return code, stdout, stderr, the written JSON or None)."""
        if name not in self.done:
            proc, path = self.procs[name]
            so, se = proc.communicate(timeout=600)
            rec = None
            if os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
            self.done[name] = (proc.returncode, so, se, rec)
        return self.done[name]

    def kill(self):
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = Runs(str(tmp_path_factory.mktemp("dryrun")))
    yield r
    r.kill()


def test_cells_are_jax(runs):
    assert runs.procs                       # the subprocesses are running
    assert cells() == j_cells()
    assert len(cells()) == 33
    assert LONG_CONTEXT_ARCHS == J_LONG


def test_mesh_override(monkeypatch):
    monkeypatch.setenv("REPRO_MESH", "2,2")
    assert dryrun._mesh_for("single").shape == {"data": 2, "model": 2}
    assert dryrun._mesh_for("multi").shape == {"pod": 2, "data": 2,
                                               "model": 2}
    monkeypatch.delenv("REPRO_MESH")
    assert dryrun._mesh_for("multi").num_shards == 512


def test_train_flops_count_the_traced_step():
    cfg = smoke_config("qwen3-8b")
    B, S = 4, 64
    assert cfg.attn_chunk >= S and not cfg.sliding_window
    tr = dryrun.trace_train(cfg, OptimConfig(), ShapeConfig("t", S, B,
                                                             "train"))
    mm, attn, _, _ = dryrun.train_flops(cfg, B, S)
    T = B * S
    per_pair = 4 * 2 * 2 * B * cfg.num_heads * cfg.head_dim
    causal = sum(range(1, S + 1)) * cfg.num_layers
    every = S * S * cfg.num_layers
    assert attn == per_pair * causal
    meta = model.Model(cfg, "meta")
    down = sum(p.numel() for n, p in meta.named_parameters()
               if n.endswith("ffn.down"))
    want = mm - 2 * down * T + per_pair * every
    assert abs(tr.counts.flops - want) <= 1e-9 * want
    # and the stated band of the whole count against train_flops'
    assert 0.99 <= tr.counts.flops / (mm + attn) <= 1.01


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_slstm_extrapolation_is_exact(kind):
    cfg = smoke_config("xlstm-1.3b").replace(num_layers=2)  # one unit
    shape = ShapeConfig("t", 32, 2, kind)
    trace = dryrun.trace_train if kind == "train" else dryrun.trace_prefill
    whole = trace(cfg, OptimConfig(), shape).counts if kind == "train" \
        else trace(cfg, shape).counts
    parts = [(trace(cfg, OptimConfig(), shape, slstm=s) if kind == "train"
              else trace(cfg, shape, slstm=s)).counts for s in (8, 16)]
    got = dryrun._extrapolate(*parts, 8, 16, 32)
    assert cfg.slstm_every and whole.flops > parts[0].flops
    assert (got.flops, got.bytes) == (whole.flops, whole.bytes)
    # the peak is linear in the steps only while one point of the step
    # holds it: the estimate, not a count
    assert abs(got.temp - whole.temp) <= MEMORY_TOL * whole.temp


@pytest.mark.parametrize("kind,S", [("train", 64), ("prefill", 256)])
def test_slstm_peak_extrapolation_is_a_lower_bound(kind, S):
    cfg = smoke_config("xlstm-1.3b").replace(num_layers=2)  # one unit
    shape = ShapeConfig("t", S, 2, kind)

    def trace(limit):
        if kind == "train":
            return dryrun.trace_train(cfg, OptimConfig(), shape,
                                      slstm=limit).counts
        return dryrun.trace_prefill(cfg, shape, slstm=limit).counts
    whole = trace(None)
    got = dryrun._extrapolate(trace(8), trace(16), 8, 16, S)
    assert (got.flops, got.bytes) == (whole.flops, whole.bytes)
    assert got.temp <= whole.temp


def test_slstm_limit_that_does_not_take_raises(monkeypatch):
    cfg = smoke_config("xlstm-1.3b").replace(num_layers=2)
    shape = ShapeConfig("t", 32, 2, "prefill")
    # a loop that no longer calls the cell through the module
    cell = dryrun.xlstm._slstm_cell
    monkeypatch.setattr(dryrun.xlstm, "apply_slstm",
                        lambda p, cfg, x, ctx=None: x)
    with pytest.raises(RuntimeError, match="did not take"):
        dryrun.trace_prefill(cfg, shape, slstm=8)
    assert dryrun.xlstm._slstm_cell is cell


def test_report_names_are_jax(runs):
    rc, _, se, rec = runs.result("jax")
    assert rc == 0, se[-3000:]
    assert rec["names"] == [dryrun.report_name(*n) for n in NAMES]


def _port_cell(monkeypatch, arch, shape, probe):
    monkeypatch.setattr(dryrun, "get_config", lambda a: smoke_config(
        a).replace(attn_chunk=ATTN_CHUNK))
    monkeypatch.setenv("REPRO_MESH", "2,2")
    mesh = dryrun._mesh_for("single")
    traced, meta = dryrun.trace_cell(arch, shape, mesh, probe)
    cfg, _ = dryrun._cfg_for(arch, shape, probe)
    return dryrun.analyze(traced, meta), cfg, mesh


@pytest.mark.parametrize("cell", JAX_CELLS, ids="/".join)
def test_arguments_and_flops_against_jax(cell, runs, monkeypatch):
    rec, cfg, mesh = _port_cell(monkeypatch, *cell)
    rc, _, se, out = runs.result("jax")
    assert rc == 0, se[-3000:]
    want = out["/".join(cell)]
    assert rec["mesh"] == want["mesh"] and rec["num_layers"] == \
        want["num_layers"]
    # the norm scales: float32 in the port, param_dtype in JAX
    narrow = model.DTYPES[cfg.param_dtype].itemsize
    extra = sum(p.numel() * (p.element_size() - narrow) for p in
                model.rank_model_meta(cfg, mesh).parameters())
    assert (cfg.param_dtype == "float32") == (extra == 0)
    assert rec["argument_size_in_bytes"] - extra == \
        want["argument_size_in_bytes"]
    ratio = rec["flops_per_device"] / want["flops_per_device"]
    lo, hi = TRAIN_BAND if cell[1] == "train_4k" else DECODE_BAND
    assert lo <= ratio <= hi, ratio
    if cell[1] == "decode_32k":
        assert (rec["n_pages"], rec["pool_pages"]) == (want["n_pages"],
                                                       want["pool_pages"])


def test_cli_decode_cell(runs):
    rc, so, se, rec = runs.result("decode")
    assert rc == 0, f"{so}\n{se[-3000:]}"
    assert rec["ok"] and rec["n_pages"] >= 1
    assert rec["mesh"] == {"data": 2, "model": 2}
    assert rec["flops_per_device"] > 0 and rec["memory_estimate"]
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["peak_memory_in_bytes"] > rec["argument_size_in_bytes"]


def test_cli_probe_extrapolation_consistent(runs):
    """unit2 FLOPs > unit1 FLOPs (the per-layer delta is positive)."""
    r1, r2 = runs.result("unit1"), runs.result("unit2")
    for rc, so, se, _ in (r1, r2):
        assert rc == 0, f"{so}\n{se[-3000:]}"
    assert r1[3]["ok"] and r2[3]["ok"]
    assert (r1[3]["num_layers"], r2[3]["num_layers"]) == (1, 2)
    assert r2[3]["flops_per_device"] > r1[3]["flops_per_device"] * 1.05
    assert r1[3]["model_flops"] > 0


def test_cli_failing_cell_writes_its_error(runs):
    rc, so, _, rec = runs.result("raises")
    assert rc == 1
    assert rec["ok"] is False and "no-such-arch" in rec["error"]
    assert "failures=1" in so
