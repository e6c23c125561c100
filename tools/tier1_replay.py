#!/usr/bin/env python
"""Read a tier-1 run's junit XML: the seconds each test file took (summed
over its tests), beside a second run's where one is given, and a replay of
how pytest-xdist's ``--dist loadfile`` schedules those files on the
workers, with the time each worker ends.

    python tools/tier1_replay.py RUN.xml [OTHER.xml] [--workers 6] [-v]
        [--layout COLLECTED.txt] [--stamps STAMPS.log]

The replay follows ``xdist.scheduler.LoadScopeScheduling``: files are
queued by their number of tests, most first (ties in name order); each
worker takes one file, then another while it has at most two tests left
to run, so a file can wait behind the last tests of the one before it.
It takes each test's junit time as its duration on that worker, so it
shows order and queueing, not contention: a file shared with a busier
machine runs longer than the replay says.

``--layout`` predicts a layout before it is run: it takes the output of
``pytest --collect-only -q`` on the new tree, moves each test of RUN.xml
to the file that now holds a test of its name and parametrisation id, and
replays that queue.

The module is also a pytest plugin that stamps a run's clock: with
``tools`` on ``PYTHONPATH``, ``-p tier1_replay`` and ``TIER1_STAMPS=FILE``
in the environment, the controller writes one line per test start and
end (seconds since the session began, worker, event, node id).
``--stamps FILE`` then prints when each file started and ended.
"""
from __future__ import annotations

import argparse
import collections
import heapq
import os
import time
import xml.etree.ElementTree as ET


def timed_tests(path: str) -> list:
    """[(test file, test name with its parametrisation id, seconds)], in
    run order."""
    return [(tc.get("classname", "").split(".")[-1], tc.get("name", ""),
             float(tc.get("time", 0)))
            for tc in ET.parse(path).getroot().iter("testcase")]


def file_times(path: str) -> dict:
    """{test file: [seconds of each test, in run order]}."""
    out: dict = collections.OrderedDict()
    for f, _, t in timed_tests(path):
        out.setdefault(f, []).append(t)
    return out


def collected(path: str) -> dict:
    """{test name with its id: [files]} from ``pytest --collect-only -q``."""
    out: dict = {}
    for line in open(path):
        path_, sep, name = line.strip().partition("::")
        if sep and path_.endswith(".py"):
            f = path_.rsplit("/", 1)[-1][:-3]
            out.setdefault(name, []).append(f)
    return out


def relayout(tests: list, layout: dict) -> dict:
    """{new test file: [seconds]}: each timed test moved to the file that
    holds its name in ``layout``. A name held by several files goes to the
    file it came from if that still holds it, else to the one whose name
    extends its old file's name. Collected tests with no time count 0 s."""
    out: dict = collections.OrderedDict()
    placed = collections.Counter()
    for old, name, t in tests:
        files = layout.get(name, [])
        if old in files:
            new = old
        else:
            near = [f for f in files if f.startswith(old + "_")]
            if len(near) != 1 and len(files) != 1:
                raise SystemExit(f"{old}::{name}: held by {files or 'none'}")
            new = near[0] if len(near) == 1 else files[0]
        out.setdefault(new, []).append(t)
        placed[name, new] += 1
    for name, files in layout.items():
        for f in files:
            if placed[name, f]:
                placed[name, f] -= 1
            else:
                out.setdefault(f, []).append(0.0)
    return out


def file_spans(path: str) -> dict:
    """{test file: (first start, last end, worker)} from a stamps log."""
    out: dict = {}
    for line in open(path):
        t, worker, event, nodeid = line.split(maxsplit=3)
        f = nodeid.split("::")[0].rsplit("/", 1)[-1][:-3]
        s0, s1, w = out.get(f, (float("inf"), 0.0, worker))
        t = float(t)
        out[f] = (min(s0, t) if event == "start" else s0,
                  max(s1, t) if event == "end" else s1,
                  worker if worker != "-" else w)
    return out


class _Stamps:
    def __init__(self, path):
        self.t0 = time.monotonic()
        self.out = open(path, "w", buffering=1)

    def _write(self, worker, event, nodeid):
        self.out.write(f"{time.monotonic() - self.t0:.3f} {worker} "
                       f"{event} {nodeid}\n")

    def pytest_runtest_logstart(self, nodeid, location):
        self._write("-", "start", nodeid)

    def pytest_runtest_logreport(self, report):
        if report.when == "teardown":
            node = getattr(report, "node", None)
            worker = getattr(node, "gateway", None)
            self._write(getattr(worker, "id", "-"), "end", report.nodeid)


def pytest_configure(config):
    path = os.environ.get("TIER1_STAMPS")
    if path and not hasattr(config, "workerinput"):
        config.pluginmanager.register(_Stamps(path), "tier1_stamps")


def replay(times: dict, workers: int) -> list:
    """Each worker's [(start, end, file)] under ``--dist loadfile``."""
    queue = collections.deque(sorted(sorted(times),
                                     key=lambda f: -len(times[f])))
    pending = [collections.deque() for _ in range(workers)]
    spans: list = [[] for _ in range(workers)]

    def take(w):
        f = queue.popleft()
        pending[w].extend((f, d) for d in times[f])

    for w in range(workers):
        if queue:
            take(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            take(w)
    clock = [(0.0, w) for w in range(workers)]
    running = [False] * workers
    while clock:
        t, w = heapq.heappop(clock)
        if running[w] and queue and len(pending[w]) <= 2:
            take(w)
        running[w] = bool(pending[w])
        if pending[w]:
            f, d = pending[w].popleft()
            if spans[w] and spans[w][-1][2] == f:
                spans[w][-1] = (spans[w][-1][0], t + d, f)
            else:
                spans[w].append((t, t + d, f))
            heapq.heappush(clock, (t + d, w))
    return spans


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run", nargs="?")
    ap.add_argument("other", nargs="?")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("-v", action="store_true", help="each worker's files")
    ap.add_argument("--layout", metavar="COLLECTED",
                    help="replay RUN's tests in this collection's files")
    ap.add_argument("--stamps", metavar="LOG",
                    help="each file's measured start and end")
    args = ap.parse_args(argv)
    if args.stamps:
        spans = file_spans(args.stamps)
        for f, (s0, s1, w) in sorted(spans.items(), key=lambda i: i[1]):
            print(f"{f:40s} {w:5s} {s0:8.1f}-{s1:8.1f} {s1 - s0:7.1f}")
        print(f"the last test ended at "
              f"{max(s1 for _, s1, _ in spans.values()):.1f} s")
    if not args.run:
        return
    if args.layout and args.other:
        ap.error("--layout replaces OTHER")
    a = file_times(args.run)
    b = (relayout(timed_tests(args.run), collected(args.layout))
         if args.layout else file_times(args.other) if args.other else {})
    for f in sorted(a, key=lambda f: -sum(a[f])):
        line = f"{f:40s} {len(a[f]):4d} {sum(a[f]):8.1f}"
        if b:
            line += f"   {len(b.get(f, [])):4d} {sum(b.get(f, [])):8.1f}"
        print(line)
    for f in sorted(set(b) - set(a)):
        print(f"{f:40s}    -        -   {len(b[f]):4d} {sum(b[f]):8.1f}")
    print(f"{'sum':40s} {sum(map(len, a.values())):4d} "
          f"{sum(map(sum, a.values())):8.1f}" + (
              f"   {sum(map(len, b.values())):4d} "
              f"{sum(map(sum, b.values())):8.1f}" if b else ""))
    for label, times in (("run", a), ("layout" if args.layout else "other", b)):
        if not times:
            continue
        spans = replay(times, args.workers)
        ends = [s[-1][1] if s else 0.0 for s in spans]
        slowest = max(times, key=lambda f: sum(times[f]))
        start = min(s0 for s in spans for s0, _, f in s if f == slowest)
        print(f"{label}: the replay ends at {max(ends):.1f} s on "
              f"{args.workers} workers; its longest file, {slowest} "
              f"({sum(times[slowest]):.1f} s), starts at {start:.1f} s")
        if args.v:
            for w, s in enumerate(spans):
                print(f"  gw{w}: ends {ends[w]:.1f} s")
                for s0, s1, f in s:
                    print(f"    {s0:8.1f}-{s1:8.1f} {s1 - s0:7.1f} {f}")


if __name__ == "__main__":
    main()
