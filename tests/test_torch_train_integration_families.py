"""The port's train CLI, ``launch.train.main``, on every family beyond the
dense one, with ``--device cpu``."""
import numpy as np
import pytest

from repro_torch.launch import train as ttrain

import torch_threads

one_thread = torch_threads.one_thread


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b",
                                  "jamba-v0.1-52b"])
def test_train_cli_runs_the_moe_and_hybrid_families(arch, tmp_path, capsys):
    losses = ttrain.main(["--arch", arch, "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "32", "--ckpt-dir",
                          str(tmp_path), "--ckpt-every", "1",
                          "--inject-failure-at", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert sorted(losses) == [0, 1, 2]
    assert all(np.isfinite(v) for v in losses.values())
    assert "restarts=1" in out and "[restore] resumed from step 2" in out


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "whisper-tiny",
                                  "internvl2-2b"])
def test_train_cli_runs_the_ssm_encdec_and_vlm_families(arch, tmp_path,
                                                        capsys):
    """The CLI on the batches of each family (frames and decoder tokens;
    patch embeddings and -100 prefix labels), through a restart."""
    losses = ttrain.main(["--arch", arch, "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "32", "--ckpt-dir",
                          str(tmp_path), "--ckpt-every", "1",
                          "--inject-failure-at", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert sorted(losses) == [0, 1, 2]
    assert all(np.isfinite(v) for v in losses.values())
    assert "restarts=1" in out and "[restore] resumed from step 2" in out
