"""Tick-level tracing for the serving engine: structured spans on a bounded
ring buffer, exported as Chrome/Perfetto trace-event JSON.

The :class:`Tracer` is zero-dependency and host-side: every record is a
plain tuple appended to a ``collections.deque(maxlen=capacity)``, so memory
is O(1) in run length and a dropped-oldest counter keeps the loss visible.
Four record families cover the engine's timeline:

  * **duration spans** — ``with tracer.span("gather", tid=lane): ...`` or
    the split form ``tok = tracer.begin("tick"); ...; tracer.end(tok)`` for
    spans that cross function boundaries (a pipelined tick is *begun* at
    issue and *ended* at drain, possibly several engine ticks later).
    ``tid`` is the track: the engine maps pipeline lanes to tracks so
    depth>=2 tick spans render side by side and a stall shows as a gap;
  * **counters** — ``tracer.counter("occupancy", v)``: per-tick counter
    tracks (occupancy, route-cap fill, rows activated, routed all_to_all
    element volume);
  * **instants** — ``tracer.instant("kill", rid=...)``: point events for
    request aborts and write-claim fence hits;
  * **async request lifecycle** — ``async_begin/async_end("queue", id=rid)``:
    submit→admit→complete slices (``request`` wrapping ``queue`` then
    ``service``) keyed by request id, so overlapping requests don't fight
    over one track.

``export(path)`` (or ``to_events()``) emits the Chrome trace-event JSON
array format: span records become balanced ``B``/``E`` pairs replayed
through a per-track nesting sweep (timestamps monotonic per track, children
clamped inside parents), counters become ``C`` events, instants ``i``, and
request slices ``b``/``e`` async pairs — openable directly in Perfetto
(https://ui.perfetto.dev) or chrome://tracing, and machine-checkable with
``tools/trace_report.py``.

A disabled tracer (``Tracer(enabled=False)``, the engine's default via
``NULL_TRACER``) keeps every record method a single attribute check, so the
untraced hot path pays one branch per call site.

A copy of the JAX package's ``serving/tracing.py`` (standard library
only), with the same span vocabulary and export format, so
``tools/trace_report.py`` reads the port's traces unchanged.  The port has
no serving benchmark yet (ROADMAP Queue 1 item 14), so the enabled cost is
not gated here.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager

# the documented span vocabulary (tools/trace_report.py groups by these);
# "route" and "fused_tick" belong to the mesh backend, not ported yet
SPAN_NAMES = (
    "tick",            # one engine tick, issue -> drain (lane track)
    "gather",          # per-slot op gather + claim/fence bookkeeping
    "route",           # two-pass routing capacity measurement (fused mesh)
    "probe", "delete", "insert",   # per-phase device-call dispatch
    "fused_tick",      # whole-tick megakernel dispatch (ONE shard_map)
    "writeback",       # drain: host materialization + result scatter
    "pipeline_stall",  # write-claim fence flush (depth>=2)
    "admit",           # completion sweep + slot refill
    "sample",          # throttled chain/rows-activated telemetry
    "grow",            # drain-time PR_ERROR repair, resize="rebuild"
    "split",           # same repair point, resize="extendible": per-group
                       # split/doubling — inline, NO pipeline flush
    "compact", "preload",
)
INSTANT_NAMES = ("kill", "write_fence", "deferred_write", "profiler_start",
                 "profiler_stop")
COUNTER_NAMES = ("occupancy", "tick_ops", "route_cap_fill", "routed_elems",
                 "rows_activated")
REQUEST_SLICES = ("request", "queue", "service")

_PID = 1                       # single-process engine: one trace pid

# record kinds in the ring (field layout per kind)
_SPAN, _COUNTER, _INSTANT, _ABEGIN, _AEND = 0, 1, 2, 3, 4


class Tracer:
    """Bounded-ring span recorder with Chrome trace-event export.

    ``capacity`` bounds the ring (oldest records dropped, counted in
    ``self.dropped``); ``enabled=False`` turns every method into a cheap
    no-op (the shared :data:`NULL_TRACER` is exactly that).
    """

    def __init__(self, capacity: int = 1 << 16, enabled: bool = True):
        self.enabled = enabled
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._recorded = 0
        self._t0 = time.perf_counter()

    # -- clock -------------------------------------------------------------
    def now_us(self) -> float:
        """Microseconds since tracer creation (the trace timebase)."""
        return (time.perf_counter() - self._t0) * 1e6

    @property
    def dropped(self) -> int:
        return max(0, self._recorded - len(self._ring))

    def __len__(self) -> int:
        return len(self._ring)

    def _emit(self, rec: tuple):
        self._ring.append(rec)
        self._recorded += 1

    # -- spans -------------------------------------------------------------
    def begin(self, name: str, tid: int = 0, **args):
        """Open a span; returns a token for :meth:`end`.  Use for spans
        that outlive the current scope (the engine's tick span stays open
        across pipelined ticks until drain)."""
        if not self.enabled:
            return None
        return (name, tid, self.now_us(), args)

    def end(self, token):
        """Close a span opened by :meth:`begin` (None tokens no-op)."""
        if token is None or not self.enabled:
            return
        name, tid, ts, args = token
        self._emit((_SPAN, name, tid, ts, self.now_us() - ts, args))

    @contextmanager
    def span(self, name: str, tid: int = 0, **args):
        tok = self.begin(name, tid, **args) if self.enabled else None
        try:
            yield
        finally:
            self.end(tok)

    # -- counters / instants ----------------------------------------------
    def counter(self, name: str, value, tid: int = 0):
        if not self.enabled:
            return
        self._emit((_COUNTER, name, tid, self.now_us(), float(value), None))

    def instant(self, name: str, tid: int = 0, **args):
        if not self.enabled:
            return
        self._emit((_INSTANT, name, tid, self.now_us(), 0.0, args))

    # -- async request lifecycle ------------------------------------------
    def async_begin(self, name: str, id: int, **args):
        if not self.enabled:
            return
        self._emit((_ABEGIN, name, id, self.now_us(), 0.0, args))

    def async_end(self, name: str, id: int, **args):
        if not self.enabled:
            return
        self._emit((_AEND, name, id, self.now_us(), 0.0, args))

    # -- export ------------------------------------------------------------
    def to_events(self) -> list:
        """Chrome trace-event dicts from the current ring contents.

        Span records are replayed per track through a nesting sweep —
        sorted by (start, -duration), a child whose interval extends past
        its parent (float jitter) is clamped inside — so the emitted
        ``B``/``E`` stream is balanced and timestamp-monotonic per track by
        construction, even after ring drops removed arbitrary records.
        Async ``b`` records are emitted with their matching ``e`` (an
        unmatched half — its partner aged out of the ring, or the request
        never completed — is dropped rather than exported unbalanced).
        """
        spans: dict = {}
        others: list = []
        abegins: dict = {}
        apairs: list = []
        for rec in self._ring:
            kind = rec[0]
            if kind == _SPAN:
                spans.setdefault(rec[2], []).append(rec)
            elif kind == _COUNTER:
                others.append({"name": rec[1], "ph": "C", "pid": _PID,
                               "tid": rec[2], "ts": rec[3],
                               "args": {"value": rec[4]}})
            elif kind == _INSTANT:
                others.append({"name": rec[1], "ph": "i", "s": "t",
                               "pid": _PID, "tid": rec[2], "ts": rec[3],
                               "args": rec[5] or {}})
            elif kind == _ABEGIN:
                abegins[(rec[1], rec[2])] = rec
            else:
                b = abegins.pop((rec[1], rec[2]), None)
                if b is not None:
                    apairs.append((b, rec))
        events: list = []
        for tid, recs in spans.items():
            events.extend(self._sweep_track(tid, recs))
        for b, e in apairs:
            base = {"cat": "request", "name": b[1], "id": b[2], "pid": _PID}
            events.append({**base, "ph": "b", "ts": b[3], "args": b[5] or {}})
            events.append({**base, "ph": "e", "ts": e[3], "args": e[5] or {}})
        events.extend(others)
        events.sort(key=lambda ev: ev["ts"])       # stable: keeps B/E order
        if not events:
            return []
        meta = [{"name": "process_name", "ph": "M", "pid": _PID,
                 "args": {"name": "ServingEngine"}}]
        for tid in sorted(spans):
            meta.append({"name": "thread_name", "ph": "M", "pid": _PID,
                         "tid": tid, "args": {"name": f"lane {tid}"}})
        return meta + events

    @staticmethod
    def _sweep_track(tid: int, recs: list) -> list:
        """One track's span records -> balanced, monotonic B/E events."""
        recs = sorted(recs, key=lambda r: (r[3], -r[4]))
        out: list = []
        stack: list = []                 # (name, end_ts)
        for _, name, _, ts, dur, args in recs:
            while stack and stack[-1][1] <= ts:
                n, e = stack.pop()
                out.append({"name": n, "ph": "E", "pid": _PID, "tid": tid,
                            "ts": e})
            end = ts + dur
            if stack and end > stack[-1][1]:
                end = stack[-1][1]       # clamp float jitter inside parent
            out.append({"name": name, "ph": "B", "pid": _PID, "tid": tid,
                        "ts": ts, "args": args or {}})
            stack.append((name, end))
        while stack:
            n, e = stack.pop()
            out.append({"name": n, "ph": "E", "pid": _PID, "tid": tid,
                        "ts": e})
        return out

    def export(self, path: str, **metadata) -> int:
        """Write the trace-event JSON file; returns the event count."""
        events = self.to_events()
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"recorded": self._recorded,
                             "dropped": self.dropped, **metadata}}
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)


#: shared disabled tracer — the engine's default, so call sites never
#: branch on None (every record method is one ``self.enabled`` check)
NULL_TRACER = Tracer(capacity=1, enabled=False)
