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
        matmul (``tests/test_torch_dryrun_trace.py``): port / JAX in
        ``TRAIN_BAND`` (0.925 measured).  A decode step's matmuls take one
        token a row, while the attention's elementwise ops run over the
        whole 32768-position horizon of every row and head: port / JAX in
        ``DECODE_BAND`` (0.249 measured);
  * (d) the CLI at published widths on ``REPRO_MESH=2,2``: h2o-danube-1.8b
    ``decode_32k`` ``full`` writes a record with ``n_pages >= 1``;
    ``train_4k``'s ``unit2`` FLOPs exceed ``unit1``'s by more than 5%
    (``tests/test_dryrun_small.py``'s check); a cell that raises writes
    ``ok: false`` and the CLI exits 1.
The JAX dry-run module is imported only in the subprocess: it sets
``XLA_FLAGS`` when imported."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs import LONG_CONTEXT_ARCHS as J_LONG
from repro.configs import cells as j_cells

from repro_torch.configs import LONG_CONTEXT_ARCHS, cells, smoke_config
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
