"""The three cases of ``tests/test_train_integration.py`` on the port's
training stack, on the CPU: the loss falls, a restart after an injected
failure replays the same steps bit for bit (losses, parameters and
moments), and bf16 gradient compression trains; and the entry points
``launch.train.main`` (every family) and ``train_lm`` run with ``--device
cpu``."""
import numpy as np
import pytest
import torch

from repro_torch import train_lm
from repro_torch.configs import OptimConfig, ShapeConfig, smoke_config
from repro_torch.launch import train as ttrain

import torch_threads

one_thread = torch_threads.one_thread

CPU = "cpu"


def test_loss_decreases(tmp_path):
    cfg = smoke_config("llama3-8b")
    oc = OptimConfig(lr=1e-3, warmup_steps=5, total_steps=25)
    _, _, losses, _, _ = ttrain.train(
        cfg, ShapeConfig("t", 128, 4, "train"), oc, num_steps=25,
        ckpt_dir=str(tmp_path), ckpt_every=0, verbose=False, device=CPU)
    first = np.mean([losses[s] for s in range(3)])
    last = np.mean([losses[s] for s in range(22, 25)])
    assert last < first - 0.3, (first, last)


def test_failure_restart_resumes_identically(tmp_path):
    cfg = smoke_config("qwen3-8b")
    shape = ShapeConfig("t", 64, 4, "train")
    oc = OptimConfig(lr=1e-3, warmup_steps=2, total_steps=16)
    p_ref, o_ref, losses_ref, _, _ = ttrain.train(
        cfg, shape, oc, num_steps=16, ckpt_dir=str(tmp_path / "a"),
        ckpt_every=4, verbose=False, device=CPU)
    p_ft, o_ft, losses_ft, _, pol = ttrain.train(
        cfg, shape, oc, num_steps=16, ckpt_dir=str(tmp_path / "b"),
        ckpt_every=4, inject=[10], verbose=False, device=CPU)
    assert pol.restarts == 1
    assert losses_ft == losses_ref          # the replayed steps, bit-equal
    for (n, a), (_, b) in zip(p_ref.named_parameters(),
                              p_ft.named_parameters()):
        assert torch.equal(a, b), n
    for n in o_ref["m"]:
        assert torch.equal(o_ref["m"][n], o_ft["m"][n]), n
        assert torch.equal(o_ref["v"][n], o_ft["v"][n]), n


def test_train_without_a_checkpoint_dir(tmp_path, monkeypatch):
    """``ckpt_dir=None`` trains the same steps and writes nothing."""
    monkeypatch.chdir(tmp_path)
    cfg = smoke_config("llama3-8b")
    shape = ShapeConfig("t", 64, 4, "train")
    oc = OptimConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    p_ref, _, losses_ref, _, _ = ttrain.train(
        cfg, shape, oc, num_steps=6, ckpt_dir=str(tmp_path / "a"),
        ckpt_every=2, verbose=False, device=CPU)
    p, _, losses, _, _ = ttrain.train(
        cfg, shape, oc, num_steps=6, ckpt_dir=None, ckpt_every=2,
        verbose=False, device=CPU)
    assert losses == losses_ref
    for (n, a), (_, b) in zip(p_ref.named_parameters(), p.named_parameters()):
        assert torch.equal(a, b), n
    assert sorted(q.name for q in tmp_path.iterdir()) == ["a"]


def test_grad_compression_trains(tmp_path):
    cfg = smoke_config("llama3-8b")
    oc = OptimConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    _, _, losses, _, _ = ttrain.train(
        cfg, ShapeConfig("t", 64, 4, "train"), oc, num_steps=12,
        ckpt_dir=str(tmp_path), ckpt_every=0, grad_compression="bf16",
        verbose=False, device=CPU)
    assert losses[11] < losses[0]


def test_train_cli_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--arch", "llama3-8b", "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "64", "--ckpt-dir", ck, "--ckpt-every", "2",
            "--inject-failure-at", "3", "--device", "cpu"]
    losses = ttrain.main(args)
    out = capsys.readouterr().out
    assert sorted(losses) == [0, 1, 2, 3]
    assert "restarts=1" in out and "[restore] resumed from step 2" in out
    assert ttrain.main(args) == {}        # the checkpoint holds step 4
    assert "no step to run" in capsys.readouterr().out


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


def test_train_lm_on_cpu(tmp_path, capsys):
    losses = train_lm.main(["--steps", "1", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert sorted(losses) == [0]
    assert all(np.isfinite(v) for v in losses.values())
    assert "M params" in out and "loss:" in out
