"""The port's dry-run (``repro_torch.launch.dryrun``) traced in process:

  * the ``REPRO_MESH`` override;
  * the traced FLOPs of a dense smoke train step on one device against
    ``train_flops``: equal to 1e-9 once two differences are counted: the
    port's chunked attention computes every (q, k) pair of a chunk (the
    causal mask zeroes them; ``train_flops`` counts the causal ones), and
    PyTorch's non-reentrant checkpoint stops its recompute once it has
    every tensor the backward needs, so no unit's last matmul (the FFN's
    ``down``) is recomputed;
  * the sLSTM extrapolation: xlstm's smoke train and prefill steps (one
    unit: an sLSTM and an mLSTM) at 32 tokens traced whole equal the linear
    extrapolation from 8 and 16 sLSTM steps, FLOPs and bytes exactly, the
    peak memory estimate within ``MEMORY_TOL`` (the prefill's is 3.0% low:
    its peak moves to another point of the step as the steps grow); at 64
    (train) and 256 (prefill) tokens the extrapolated peak is at most the
    whole trace's, the lower bound ``dryrun._extrapolate`` states
    (``tools/slstm_peak_check.py`` prints the ratios); a step limit that
    does not take raises.
``RecordingMesh``'s counts against a real gloo mesh's are held in
``tests/test_torch_train_ranks.py`` and ``tests/test_torch_decode_ranks.py``,
whose spawned worlds they use."""
import pytest

from repro_torch.configs import OptimConfig, ShapeConfig, smoke_config
from repro_torch.launch import dryrun
from repro_torch.models import model

import torch_threads

one_thread = torch_threads.one_thread

MEMORY_TOL = 0.05


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
