"""The tier-1 run's queue.  pytest-xdist's ``--dist loadfile`` hands whole
test files to the workers, most tests first and ties in name order, and the
run ends when its longest file, ``tests/test_serving_sharded.py``, does.
So no port file may hold more tests than that file, or it queues ahead of
it and the run ends later.  The exceptions are ``AHEAD``: the rank worlds,
each of which spawns one world of rank processes in a module fixture that
every test of the file reads, and port files fast enough that their place
in the queue does not matter.  ``python tools/tier1_replay.py RUN.xml
--layout COLLECTED.txt`` predicts the run of a new layout."""
import collections
import os

import pytest

SHARDED = "test_serving_sharded.py"

# Each file's tests' seconds summed, from the driver's command
# (``-n 6 --dist loadfile``) on this layout: 1098 s in all on 8 cores.
AHEAD = {
    "test_torch_train_ranks.py",        # rank worlds of 4 and 8; 148.5 s
    "test_torch_decode_ranks.py",       # a rank world of 4; 101.0 s
    "test_torch_serving_ranks.py",      # rank worlds of 4 and 2; 68.4 s
    "test_torch_serving_engine.py",     # 11.4 s
    "test_torch_hashing.py",            # 2.3 s
    "test_torch_serving_mesh.py",       # 13.3 s
    "test_torch_bitserial_edges.py",    # 13.5 s
    "test_torch_optim.py",              # 10.6 s
    "test_torch_kv_synth.py",           # 0.9 s
    "test_torch_data_pipeline.py",      # 0.1 s
}


def test_no_port_file_queues_ahead_of_the_sharded_file(request):
    counts = collections.Counter(
        os.path.basename(item.nodeid.split("::")[0])
        for item in request.session.items)
    if SHARDED not in counts:
        pytest.skip(f"{SHARDED} was not collected")
    ahead = {f: n for f, n in counts.items()
             if f.startswith("test_torch_") and n > counts[SHARDED]
             and f not in AHEAD}
    assert not ahead, (
        f"{ahead} hold more tests than {SHARDED} ({counts[SHARDED]}), so "
        "they queue ahead of it: split them, or name a fast file in AHEAD")
