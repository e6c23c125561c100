#!/usr/bin/env python
"""Read a tier-1 run's junit XML: the seconds each test file took (summed
over its tests), beside a second run's where one is given, and a replay of
how pytest-xdist's ``--dist loadfile`` schedules those files on the
workers, with the time each worker ends.

    python tools/tier1_replay.py RUN.xml [OTHER.xml] [--workers 6] [-v]

The replay follows ``xdist.scheduler.LoadScopeScheduling``: files are
queued by their number of tests, most first (ties in name order); each
worker takes one file, then another while it has at most two tests left
to run, so a file can wait behind the last tests of the one before it.
It takes each test's junit time as its duration on that worker, so it
shows order and queueing, not contention: a file shared with a busier
machine runs longer than the replay says.
"""
from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def file_times(path: str) -> dict:
    """{test file: [seconds of each test, in run order]}."""
    out: dict = collections.OrderedDict()
    for tc in ET.parse(path).getroot().iter("testcase"):
        name = tc.get("classname", "").split(".")[-1]
        out.setdefault(name, []).append(float(tc.get("time", 0)))
    return out


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
    ap.add_argument("run")
    ap.add_argument("other", nargs="?")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("-v", action="store_true", help="each worker's files")
    args = ap.parse_args(argv)
    a = file_times(args.run)
    b = file_times(args.other) if args.other else {}
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
    for label, times in (("run", a), ("other", b)):
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
