"""The port's decode serving loop against the JAX package's ``serve`` for
olmoe-1b-7b, jamba-v0.1-52b, xlstm-1.3b and internvl2-2b, and the CLI's
decode mode on the ssm and vlm families. The cases are in
``tests/serve_decode_cases.py``."""
import pytest

from repro_torch.launch import serve as tserve

import torch_threads
import serve_decode_cases
from serve_decode_cases import CPU

served = serve_decode_cases.served_fixture(
    "internvl2-2b-perf", "jamba-v0.1-52b-perf", "olmoe-1b-7b-perf",
    "xlstm-1.3b-perf")
test_serve_outputs_and_steps_match_jax = serve_decode_cases.test_serve_outputs_and_steps_match_jax
test_serve_page_table_trace_and_leaves_match_jax = serve_decode_cases.test_serve_page_table_trace_and_leaves_match_jax

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "internvl2-2b"])
def test_serve_cli_decodes_the_ssm_and_vlm_families(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", CPU, "--requests",
                 "3", "--batch", "2", "--max-new", "3", "--horizon", "32",
                 "--page-tokens", "8"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert "live pages after drain: 0" in out
