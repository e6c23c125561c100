"""The PyTorch port and ``chip_smoke.py`` stand apart from the JAX package:
importing every module of ``repro_torch`` loads no ``jax`` and nothing of
``repro``, no source imports either, and ``chip_smoke.py`` refuses to run
without a card or without the repo beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_sources_import_no_jax_and_no_repro():
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if _banned(n)]
    assert not bad, bad
    assert len(_sources()) > 10


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "want = {'repro_torch.core.rlu', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.distributed.sharding',\n"
        "        'repro_torch.channels_demo', 'repro_torch.configs.base',\n"
        "        'repro_torch.configs.qwen3_8b', 'repro_torch.models.layers',\n"
        "        'repro_torch.models.mlp', 'repro_torch.models.attention',\n"
        "        'repro_torch.models.transformer', 'repro_torch.models.model',\n"
        "        'repro_torch.core.paged_kv', 'repro_torch.core.pim_embedding',\n"
        "        'repro_torch.distributed.steps', 'repro_torch.serve_paged',\n"
        "        'repro_torch.optim.adamw', 'repro_torch.checkpoint.checkpointer',\n"
        "        'repro_torch.data.pipeline', 'repro_torch.distributed.compression',\n"
        "        'repro_torch.distributed.fault_tolerance',\n"
        "        'repro_torch.launch.train', 'repro_torch.train_lm',\n"
        "        'repro_torch.serving.engine', 'repro_torch.launch.serve',\n"
        "        'repro_torch.data.kv_synth',\n"
        "        'repro_torch.configs.hashmem_paper'}\n"
        "assert want <= set(mods), want - set(mods)\n"
        "from repro_torch.launch import mesh\n"
        "from repro_torch.core import rlu\n"
        "from repro_torch.serving import engine\n"
        "from repro_torch.data import kv_synth\n"
        "from repro_torch.configs import hashmem_paper\n"
        "need = [(mesh, 'RankMesh'), (mesh, 'make_rank_mesh'),\n"
        "        (mesh, 'spawn_ranks'), (mesh, 'sub_mesh'),\n"
        "        (rlu, '_exchange'), (rlu, '_send_back'),\n"
        "        (engine, '_RankShards'), (kv_synth, 'churn_workload'),\n"
        "        (kv_synth, 'zipfian_workload'),\n"
        "        (kv_synth, 'dictionary_words'),\n"
        "        (hashmem_paper, 'WORKLOAD'),\n"
        "        (hashmem_paper, 'DDR4_TIMING')]\n"
        "missing = [n for m, n in need if not hasattr(m, n)]\n"
        "assert not missing, missing\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 16


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_without_card_fails_without_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr
