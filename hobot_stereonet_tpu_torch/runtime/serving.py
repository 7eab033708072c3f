"""Feed/dispatch/fetch scaffolding of the streaming engine.

Counterpart of ``hobot_stereonet_tpu/runtime/serving.py`` (which imports
no JAX), which leaves the dispatch and fetch loops to each engine; here
both engines share them.  Two more changes.  Every wait has a deadline: ``drain`` raises
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

Subclasses set the geometry and the options in ``__init__`` via
:meth:`_init_serving` and implement one hook, ``_submit(frames) -> (outs,
event)``: stage and enqueue one micro-batch, ``outs`` being (disparity,
depth | None, confidence | None, non-finite flags [B]) with B >= the
frames, valid once ``event`` (a CUDA event, or None) has completed.  With
``fetch_results`` the first three are host arrays or tensors; without, they
stay on the device and each result holds a :class:`DeviceBatchView` of its
row.  The flags are on the host either way.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from ..data.stream import sbs_nv12_to_left_rgb
from .metrics import EngineMetrics

_POLL_S = 0.1
# Longest a fetch waits for one batch to finish on the device.
DEVICE_DEADLINE_S = 120.0


def nonfinite_flags(disp: torch.Tensor) -> torch.Tensor:
    """Per-frame flags, 1.0 where a frame's disparity holds NaN or Inf."""
    return (~torch.isfinite(disp)).flatten(1).any(dim=1).float()


class DeviceBatchView:
    """One frame's row of a result batch that stays on the device.

    ``device_array()`` is the row as a view (no launch).  It makes the
    caller's current stream wait for the batch's event and records the
    batch on that stream, so the caching allocator does not hand the
    memory to a later batch while the caller's work still reads it.
    ``np.asarray(view)`` copies the row to the host.
    """

    __slots__ = ("_batch", "_i", "_event")

    def __init__(self, batch: torch.Tensor, i: int, event=None):
        self._batch = batch
        self._i = i
        self._event = event

    @property
    def shape(self):
        return tuple(self._batch.shape[1:])

    @property
    def dtype(self):
        return self._batch.dtype

    def device_array(self) -> torch.Tensor:
        if self._batch.device.type == "cuda":
            stream = torch.cuda.current_stream(self._batch.device)
            if self._event is not None:
                stream.wait_event(self._event)
            self._batch.record_stream(stream)
        return self._batch[self._i]

    def __array__(self, dtype=None, copy=None):
        out = self.device_array().cpu().numpy()
        return out.astype(dtype) if dtype is not None else out


@dataclass
class StereoResult:
    """One served frame, as the engines (``StereoEngine``, ``ArtifactEngine``)
    emit it."""
    index: int
    timestamp: float
    disparity: "np.ndarray | DeviceBatchView"  # [H, W] float32 px
    depth_m: "Optional[np.ndarray | DeviceBatchView]" = None   # [H, W] float32 m
    gt_disparity: Optional[np.ndarray] = None
    e2e_latency_s: float = 0.0
    confidence: "Optional[np.ndarray | DeviceBatchView]" = None  # [H/8, W/8] in [0, 1]
    left_rgb: Optional[np.ndarray] = None     # [H, W, 3] uint8, with keep_left


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
        max_batch: int,
        nan_guard: bool = True,
        fetch_results: bool = True,
        keep_left: bool = False,
    ) -> None:
        self.metrics = EngineMetrics()
        self._max_batch = max_batch
        self._nan_guard = nan_guard
        self._fetch_results = fetch_results
        self._keep_left = keep_left
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

    @staticmethod
    def _wait(event, deadline_s: float = DEVICE_DEADLINE_S) -> None:
        """Wait for a CUDA event (None: nothing to wait for), polling, with a
        deadline."""
        if event is None:
            return
        t_end = time.monotonic() + deadline_s
        while not event.query():
            if time.monotonic() > t_end:
                raise TimeoutError(f"device batch not done after {deadline_s:.0f} s")
            time.sleep(0.0005)

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

    def _submit(self, frames: list):  # pragma: no cover - abstract
        raise NotImplementedError

    def _dispatch_loop_inner(self) -> None:
        while not self._stop.is_set():
            try:
                frames = [self._feed_q.get(timeout=0.1)]
            except queue.Empty:
                continue
            # Adaptive micro-batch: take everything already queued, up to
            # max_batch, without waiting for more.
            while len(frames) < self._max_batch:
                try:
                    frames.append(self._feed_q.get_nowait())
                except queue.Empty:
                    break
            t0 = time.monotonic()
            outs, event = self._submit(frames)
            self._put(self._inflight_q, (frames, outs, event, t0))
            self.metrics.dispatch_batch.record(len(frames))

    def _fetch_loop_inner(self) -> None:
        fetch = self._fetch_results
        while not self._stop.is_set():
            try:
                frames, outs, event, t0 = self._inflight_q.get(timeout=0.1)
            except queue.Empty:
                continue
            self._wait(event)
            maps = [o.numpy() if fetch and isinstance(o, torch.Tensor) else o
                    for o in outs[:3]]
            flags = np.asarray(outs[3])
            now = time.monotonic()
            self.metrics.infer_latency.record(now - t0)
            emitted = 0
            for i, frame in enumerate(frames):
                if self._nan_guard and flags[i] > 0:
                    self.metrics.nan_drop()
                    continue
                d_i, z_i, c_i = (None if o is None else o[i] if fetch
                                 else DeviceBatchView(o, i, event) for o in maps)
                left_rgb = None
                if self._keep_left:
                    left_rgb = sbs_nv12_to_left_rgb(
                        np.asarray(frame.sbs_nv12), frame.height, frame.full_width)
                self.metrics.e2e_latency.record(now - frame.timestamp)
                self._result_q.put(StereoResult(
                    index=frame.index,
                    timestamp=frame.timestamp,
                    disparity=d_i,
                    depth_m=z_i,
                    gt_disparity=frame.gt_disparity,
                    e2e_latency_s=now - frame.timestamp,
                    confidence=c_i,
                    left_rgb=left_rgb,
                ))
                emitted += 1
            if emitted:
                self.metrics.output_fps.tick(emitted)
            self._count_in_progress(-len(frames))
