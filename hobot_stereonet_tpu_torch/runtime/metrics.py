"""Structured runtime metrics (a copy of ``hobot_stereonet_tpu/runtime/metrics.py``,
which imports no JAX).

Replaces the reference's ``rt_stat`` fps/latency log line
(``stereonet_node.cpp:1071-1085``: input fps, output fps, preprocess ms,
infer ms) with a thread-safe counter set that renders to one structured
dict/JSON — consumable by logs, the CLI, and tests.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, Optional


class RateCounter:
    """Sliding-window event rate (events/sec over the last ``window`` s)."""

    def __init__(self, window: float = 5.0):
        self.window = window
        self._events: deque = deque()
        self._lock = threading.Lock()
        self.total = 0

    def tick(self, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            for _ in range(n):
                self._events.append(now)
            self.total += n
            self._trim(now)

    def rate(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._trim(now)
            if not self._events:
                return 0.0
            span = max(now - self._events[0], 1e-9)
            return len(self._events) / span

    def _trim(self, now: float) -> None:
        cutoff = now - self.window
        while self._events and self._events[0] < cutoff:
            self._events.popleft()


class LatencyStat:
    """Running mean/min/max + p50/p95/p99 over the last N samples
    (milliseconds).  The percentiles are the product observable a
    deployment picks an operating point on (the reference logs per-frame
    preprocess/infer latency on every stat tick,
    ``stereonet_node.cpp:1071-1085``; tails matter more than means for a
    live camera)."""

    def __init__(self, capacity: int = 1024):
        self._samples: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds * 1e3)

    @staticmethod
    def _percentile(sorted_s, q: float) -> float:
        # Nearest-rank on the retained window; exact enough for an
        # observability counter without pulling in numpy.
        idx = min(len(sorted_s) - 1, max(0, round(q * (len(sorted_s) - 1))))
        return sorted_s[int(idx)]

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if not self._samples:
                return {"mean_ms": 0.0, "min_ms": 0.0, "max_ms": 0.0,
                        "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0, "n": 0}
            s = sorted(self._samples)
        return {
            "mean_ms": sum(s) / len(s),
            "min_ms": s[0],
            "max_ms": s[-1],
            "p50_ms": self._percentile(s, 0.50),
            "p95_ms": self._percentile(s, 0.95),
            "p99_ms": self._percentile(s, 0.99),
            "n": len(s),
        }


class ValueStat:
    """Running mean/min/max over the last N unitless samples (e.g. the
    per-dispatch batch size)."""

    def __init__(self, capacity: int = 200):
        self._samples: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.total = 0.0
        self.n = 0

    def record(self, value: float) -> None:
        with self._lock:
            self._samples.append(value)
            self.total += value
            self.n += 1

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if not self._samples:
                return {"mean": 0.0, "min": 0.0, "max": 0.0, "n": 0}
            s = list(self._samples)
        return {"mean": sum(s) / len(s), "min": min(s), "max": max(s), "n": len(s)}


class EngineMetrics:
    """The full counter set for the streaming engine.

    ``preprocess_latency``/``network_latency`` mirror the reference's
    per-stage ``rt_stat`` split (preprocess ms vs infer ms,
    ``stereonet_node.cpp:1078-1084``); they are populated only in the
    engine's stage-timing diagnostic mode, since splitting stages of one
    fused async pipeline requires a device sync per stage."""

    def __init__(self):
        self.input_fps = RateCounter()
        self.output_fps = RateCounter()
        self.dropped = 0
        self.invalid = 0
        self.nan_dropped = 0
        self.e2e_latency = LatencyStat()
        self.infer_latency = LatencyStat()
        self.preprocess_latency = LatencyStat()
        self.network_latency = LatencyStat()
        self.dispatch_batch = ValueStat()
        self._lock = threading.Lock()

    def drop(self) -> None:
        with self._lock:
            self.dropped += 1

    def reject(self) -> None:
        with self._lock:
            self.invalid += 1

    def nan_drop(self) -> None:
        with self._lock:
            self.nan_dropped += 1

    def snapshot(self) -> Dict:
        out = {
            "input_fps": round(self.input_fps.rate(), 2),
            "output_fps": round(self.output_fps.rate(), 2),
            "frames_in": self.input_fps.total,
            "frames_out": self.output_fps.total,
            "dropped": self.dropped,
            "invalid": self.invalid,
            "nan_dropped": self.nan_dropped,
            "e2e_latency": self.e2e_latency.summary(),
            "infer_latency": self.infer_latency.summary(),
            "dispatch_batch": self.dispatch_batch.summary(),
        }
        if self.preprocess_latency.summary()["n"]:
            out["preprocess_latency"] = self.preprocess_latency.summary()
            out["network_latency"] = self.network_latency.summary()
        return out

    def json(self) -> str:
        return json.dumps(self.snapshot())
