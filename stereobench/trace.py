"""The device trace of a steady slice of the window (``torch.profiler``).

The slice is traced with the CPU and CUDA activities: the CUDA runtime calls
of every thread (kernel launches, copies, synchronizations) and the operators
of the thread that traces.  :meth:`Tracer.read` reduces the trace to device
intervals (kernels, copies, sets) and host operations, in seconds of the
profiler's clock; the busy time is the union of the device intervals (the
arithmetic of ``chip_smoke.py::profile_summary``) and the slice is the span
from the first recorded event to the last.
"""

from __future__ import annotations

import collections
import dataclasses
import time

from .stats import union_seconds

# A span the tracer records at the slice's end; the trace runs on until the
# program's threads have stopped.
END_MARK = "stereobench::slice_end"


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    # Recording every thread's operators (``profile_all_threads``) crashed the
    # process in 2 of 25 traced runs on the card.
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclasses.dataclass
class Slice:
    device: list          # (name, start_s, end_s)
    host: list            # (name, thread, start_s, end_s)
    span_s: float
    busy_s: float
    launch_thread: object

    def idle_share(self):
        """Share of the slice in which no operation ran on the device (%), or
        None for a slice with no device activity."""
        if self.span_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.span_s)

    def device_time(self, match) -> float:
        """Seconds of device activity whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n))

    def launches(self, match) -> int:
        """Device operations in the slice whose name ``match`` accepts."""
        return sum(1 for n, _, _ in self.device if match(n))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time, and the idle gaps of the
        device by what the launching thread of the host was doing then."""
        by_name = collections.Counter()
        for n, s, e in self.device:
            by_name[n] += e - s
        gaps = collections.Counter()
        busy = _merge([(s, e) for _, s, e in self.device])
        host = [h for h in self.host if h[1] == self.launch_thread]
        spans = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
        for (e0, s1), name in zip(spans, _doing(host, [(a + b) / 2 for a, b in spans])):
            gaps[name] += s1 - e0
        return {"device_ops": [[n, t] for n, t in by_name.most_common(top)],
                "idle_gaps": [[n, t] for n, t in gaps.most_common(top)]}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _doing(host, times) -> list:
    """For each of the sorted ``times``: 'outermost > innermost' of the host
    operations of one thread around it (a thread's operations nest)."""
    host = sorted(host, key=lambda h: (h[2], -h[3]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][2] <= t:
            while stack and stack[-1][3] <= host[i][2]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][3] <= t:
            stack.pop()
        around = [h for h in stack if h[3] > t]
        if not around:
            out.append("host: no operation recorded")
        elif len(around) == 1:
            out.append(around[0][0])
        else:
            out.append(f"{around[0][0]} > {around[-1][0]}")
    return out


def _kineto_events(result):
    """(name, is_device, thread, start_s, end_s) of every recorded event."""
    out = []
    for e in result.events():
        try:
            start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        except AttributeError:
            start, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
        if dur <= 0:
            continue
        on_device = str(e.device_type()).endswith("CUDA")
        out.append((e.name(), on_device, e.start_thread_id(), start, start + dur))
    return out


class Tracer:
    """Traces one slice of the window when ``enabled``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = self.result = None
        self.t0 = self.t1 = None

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that its own first
        start does not fall into the slice."""
        if not self.enabled:
            return
        import torch

        p = _profiler()
        p.start()
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        p.stop()

    def start(self) -> None:
        if self.enabled:
            self.prof = _profiler()
            self.prof.start()
            self.t0 = time.monotonic()

    def run_slice(self, t_end: float, seconds: float) -> None:
        """Trace from ``seconds`` before ``t_end`` (host clock); at ``t_end`` mark
        the slice's end in the trace.  The trace runs on until :meth:`stop`."""
        if not self.enabled:
            return
        time.sleep(max(0.0, t_end - seconds - time.monotonic()))
        self.start()
        time.sleep(max(0.0, t_end - time.monotonic()))
        import torch

        with torch.profiler.record_function(END_MARK):
            self.t1 = time.monotonic()

    def stop(self) -> None:
        """End the trace once the program's threads have stopped."""
        if self.prof is not None:
            self.prof.stop()
            self.result = self.prof.profiler.kineto_results
            self.prof = None

    def frames_in(self, done_times) -> int:
        """Results handed over inside the traced slice."""
        if self.t0 is None:
            return 0
        return sum(1 for t in done_times if self.t0 <= t < self.t1)

    def read(self) -> Slice:
        events = _kineto_events(self.result)
        end = min((s for n, d, _, s, _ in events if n == END_MARK and not d), default=None)
        if end is not None:                 # the slice ends at its mark
            events = [(n, d, th, s, min(e, end)) for n, d, th, s, e in events if s < end]
        device = [(n, s, e) for n, d, _, s, e in events if d]
        host = [(n, th, s, e) for n, d, th, s, e in events if not d]
        launches = collections.Counter(th for n, th, _, _ in host if "LaunchKernel" in n)
        span = (max(e for *_, e in events) - min(s for *_, s, _ in events)) if events else 0.0
        return Slice(device=device, host=host, span_s=span,
                     busy_s=union_seconds([(s, e) for _, s, e in device]),
                     launch_thread=launches.most_common(1)[0][0] if launches else None)
