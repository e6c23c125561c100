"""The port's quickstart (``python -m repro_torch.quickstart``) runs to the
end on the CPU and leaves the table the JAX package's
``examples/quickstart.py`` leaves: the same live entries and tombstones."""
import os
import subprocess
import sys
from pathlib import Path

from repro_torch import quickstart

ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_runs_on_cpu(capsys):
    st = quickstart.main(device="cpu")
    out = capsys.readouterr().out
    for backend in ("ref", "perf", "area"):
        assert f"probe[{backend:9s}]: 10000 keys, all found" in out
    assert "probe[bitserial]: all found" in out
    assert st["live_entries"] == 100_000 - 1000 + 500
    assert st["tombstones"] == 1000


def test_quickstart_module_entry_point():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.quickstart",
                           "--device", "cpu"], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "after delete+insert: live=99500 tombstones=1000" in proc.stdout
