"""Feed/dispatch/fetch scaffolding of the streaming engine.

A copy of ``hobot_stereonet_tpu/runtime/serving.py`` (which imports no
JAX) with two changes.  Every wait has a deadline: ``drain`` raises
``TimeoutError`` when the pipeline does not go idle in time, and the
workers' queue hand-offs give up when the engine stops, so a fault on the
device or in a worker ends a run with an error instead of a hang.  And a
frame counts as in progress from ``feed`` until the fetch side emits or
drops it, so ``drain`` cannot see the pipeline idle while a worker holds a
frame it has just taken from a queue.

The machine: a bounded feed queue, a dispatch thread that micro-batches
frames into device calls, a bounded in-flight queue (the depth of work on
the device), and a fetch thread that completes results.  Any exception in
a worker is recorded and re-raised from ``drain()`` and ``results()``.

Subclasses implement ``_dispatch_loop_inner`` / ``_fetch_loop_inner`` and
set the geometry fields in ``__init__`` via :meth:`_init_serving`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

from .metrics import EngineMetrics

_POLL_S = 0.1


class ServingLoop:
    """Feed/dispatch/fetch scaffolding of the serving engine."""

    _thread_prefix = "serving"

    def _init_serving(
        self,
        *,
        expected_len: int,
        height: int,
        width: int,
        feed_queue_depth: int,
        inflight: int,
        drop_on_full: bool,
    ) -> None:
        self.metrics = EngineMetrics()
        self._expected_len = expected_len
        self._geom_h = height
        self._geom_w = width
        self._drop_on_full = drop_on_full
        self._feed_q: "queue.Queue" = queue.Queue(maxsize=feed_queue_depth)
        self._inflight_q: "queue.Queue" = queue.Queue(maxsize=max(inflight, 1))
        self._result_q: "queue.Queue" = queue.Queue()
        # Frames accepted by feed() and not yet emitted or dropped by the
        # fetch side; the pipeline is idle when this is 0.
        self._in_progress = 0
        self._in_progress_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list = []
        # First exception raised by a worker thread (dispatch/fetch).
        self._worker_error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def warmup(self) -> None:  # pragma: no cover - subclasses override
        pass

    def start(self, warmup: bool = True) -> "ServingLoop":
        if warmup:
            self.warmup()
        self._stop.clear()
        self._worker_error = None
        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name=f"{self._thread_prefix}-dispatch"),
            threading.Thread(target=self._fetch_loop, daemon=True,
                             name=f"{self._thread_prefix}-fetch"),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the workers; raises ``TimeoutError`` if one does not end."""
        self._stop.set()
        alive = []
        for t in self._threads:
            t.join(timeout=timeout)
            if t.is_alive():
                alive.append(t.name)
        self._threads = []
        if alive:
            raise TimeoutError(f"worker threads did not stop: {alive}")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------------
    # Producer side
    # ------------------------------------------------------------------

    def feed(self, frame) -> bool:
        """Enqueue a frame.  Returns False if rejected (bad geometry) or
        dropped (queue full with drop_on_full)."""
        import numpy as np

        buf = frame.sbs_nv12
        if (
            buf.dtype != np.uint8
            or buf.size != self._expected_len
            or frame.full_width != 2 * self._geom_w
            or frame.height != self._geom_h
        ):
            self.metrics.reject()
            return False
        self.metrics.input_fps.tick()
        self._count_in_progress(1)
        try:
            self._feed_q.put_nowait(frame)
            return True
        except queue.Full:
            if self._drop_on_full:
                self._count_in_progress(-1)
                self.metrics.drop()
                return False
        try:
            self._put(self._feed_q, frame)
        except BaseException:
            self._count_in_progress(-1)
            raise
        return True

    # ------------------------------------------------------------------
    # Consumer side
    # ------------------------------------------------------------------

    def poll(self, timeout: Optional[float] = None):
        try:
            return self._result_q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _count_in_progress(self, n: int) -> None:
        with self._in_progress_lock:
            self._in_progress += n

    def _idle(self) -> bool:
        with self._in_progress_lock:
            return self._in_progress == 0

    def _check_workers(self) -> None:
        if self._worker_error is not None:
            raise RuntimeError(
                "engine worker thread died; pipeline cannot complete"
            ) from self._worker_error

    def results(self, timeout: float = 5.0) -> Iterator:
        """Drain results until the pipeline is idle for ``timeout`` seconds
        or the engine is stopped.  Raises if a worker thread died."""
        while True:
            res = self.poll(timeout=timeout)
            if res is None:
                self._check_workers()
                if self._stop.is_set() or self._idle():
                    return
                continue
            yield res

    def drain(self, timeout: float = 300.0) -> None:
        """Block until everything fed so far has been dispatched and
        fetched.  Raises if a worker thread died, and ``TimeoutError`` if
        the pipeline is not idle after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        while not self._idle():
            self._check_workers()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"pipeline not idle after {timeout:.0f} s: "
                    f"{self._feed_q.qsize()} queued, "
                    f"{self._inflight_q.qsize()} in flight")
            time.sleep(0.005)
        self._check_workers()

    # ------------------------------------------------------------------
    # Convenience
    # ------------------------------------------------------------------

    def run_stream(self, source, max_frames: int = 0,
                   timeout: float = 300.0) -> list:
        """Feed a stream source to completion, return all results."""
        out = []
        with self:
            n = 0
            for frame in source:
                self.feed(frame)
                n += 1
                if max_frames and n >= max_frames:
                    break
                while True:
                    r = self.poll(timeout=0)
                    if r is None:
                        break
                    out.append(r)
            self.drain(timeout=timeout)
            while True:
                r = self.poll(timeout=0.2)
                if r is None:
                    break
                out.append(r)
        return out

    # ------------------------------------------------------------------
    # Workers
    # ------------------------------------------------------------------

    def _put(self, q: "queue.Queue", item) -> None:
        """Blocking put that gives up when the engine stops."""
        while True:
            try:
                q.put(item, timeout=_POLL_S)
                return
            except queue.Full:
                if self._stop.is_set():
                    raise RuntimeError("engine stopped while a queue was full")

    def _dispatch_loop(self) -> None:
        try:
            self._dispatch_loop_inner()
        except BaseException as e:  # noqa: BLE001 — must reach drain()
            self._worker_error = e
            self._stop.set()

    def _fetch_loop(self) -> None:
        try:
            self._fetch_loop_inner()
        except BaseException as e:  # noqa: BLE001 — must reach drain()
            self._worker_error = e
            self._stop.set()

    def _dispatch_loop_inner(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _fetch_loop_inner(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError
