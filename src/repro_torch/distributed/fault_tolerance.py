"""Fault tolerance: failure injection, restart policy, straggler mitigation
(the JAX package's ``distributed/fault_tolerance.py``, pure Python, copied).

On a real multi-pod job the failure signal is a lost heartbeat / kernel launch
error; here failures are injected deterministically so the restart path is
exercised end-to-end in tests (launch/train.py --inject-failure-at).

Straggler mitigation: per-step deadline tracking.  Steps slower than
``factor``x the running median are flagged; the driver's response at scale is
to reissue the step on the backup ('pod') replica — here the reissue is
simulated (the step function is deterministic, so the backup result equals
the original) and counted, which tests the detection logic.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List


class InjectedFailure(RuntimeError):
    """Simulated node failure."""


@dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


@dataclass
class StragglerMonitor:
    factor: float = 3.0
    warmup: int = 5
    times: List[float] = field(default_factory=list)
    flagged: List[int] = field(default_factory=list)
    backup_runs: int = 0

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if the step was flagged as a straggler."""
        self.times.append(seconds)
        if len(self.times) <= self.warmup:
            return False
        med = sorted(self.times[:-1])[len(self.times[:-1]) // 2]
        if seconds > self.factor * max(med, 1e-9):
            self.flagged.append(step)
            self.backup_runs += 1          # backup replica reissues the step
            return True
        return False


@dataclass
class RestartPolicy:
    max_restarts: int = 3
    restarts: int = 0
    backoff_s: float = 0.0

    def on_failure(self, err: Exception) -> bool:
        """True -> restart; False -> give up."""
        self.restarts += 1
        if self.restarts > self.max_restarts:
            return False
        if self.backoff_s:
            time.sleep(self.backoff_s)
        return True
