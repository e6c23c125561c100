"""The port's decode serving loop against the JAX package's ``serve`` for the
dense archs (llama3-8b on the ``ref`` and ``perf`` backends, the latter
under churn, and qwen3-8b); also determinism, the CLI's decode mode, JAX's
``serve`` failing on whisper where the port refuses it, and the
``serve_paged`` example. The cases are in ``tests/serve_decode_cases.py``."""
import pytest

from repro.configs import smoke_config as j_smoke_config
from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh

from repro_torch.configs import smoke_config
from repro_torch.launch import serve as tserve

import torch_threads
import serve_decode_cases
from serve_decode_cases import CPU

served = serve_decode_cases.served_fixture(
    "llama3-8b-perf-churn", "llama3-8b-ref", "qwen3-8b-perf")
test_serve_outputs_and_steps_match_jax = serve_decode_cases.test_serve_outputs_and_steps_match_jax
test_serve_page_table_trace_and_leaves_match_jax = serve_decode_cases.test_serve_page_table_trace_and_leaves_match_jax

one_thread = torch_threads.one_thread


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
