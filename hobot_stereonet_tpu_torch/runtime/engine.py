"""Streaming stereo engine of the port.

Counterpart of ``hobot_stereonet_tpu/runtime/engine.py``: the same
feed/poll/results/drain surface (``serving.ServingLoop``), the same
adaptive micro-batching into padded batch buckets, the same results.

  feed(frame) -> [feed queue] -> dispatch: take <= max_batch queued frames,
                                 pad to a bucket, one pipeline call on the
                                 engine's CUDA stream, record an event
              -> [in-flight queue, depth = cfg.engine.inflight]
              -> fetch: wait for the event (with a deadline), split the
                 batch into results -> [result queue]

The pipeline per batch is the NV12 ingest kernel, ``FastStereoNet``, depth
and the per-frame non-finite flags.  In place of the reference's jit
dispatch, the dispatch thread enqueues the work and the device-to-host
copies on a CUDA stream of its own and records an event; the fetch thread
polls the event.  On the CPU (``device="cpu"``) the same pipeline runs
synchronously in the dispatch thread.

Served here: the flagship contract (FastStereoNet, convex upsampling,
YUV input) on one device, with ``compute_depth``, ``emit_confidence`` and
``nan_guard``.  The device frame ring, ``device_microbatch``, mesh
serving, int8, the RGB input and stage timing wait for later work.
"""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from ..config import Config, resolve_device
from ..models import FastStereoNet
from ..models.layers import cast_convs
from ..ops import preprocess as pp
from ..ops.disparity import disparity_to_depth_m
from .serving import ServingLoop
from .weights import from_flax_params, random_flax_params

# Longest a fetch waits for one batch to finish on the device.
DEVICE_DEADLINE_S = 120.0


@dataclass
class Frame:
    """One side-by-side NV12 camera frame (``hobot_stereonet_tpu.data.stream.Frame``)."""

    timestamp: float
    sbs_nv12: np.ndarray  # flat uint8, side-by-side NV12
    height: int
    full_width: int
    gt_disparity: Optional[np.ndarray] = None
    index: int = 0


@dataclass
class StereoResult:
    index: int
    timestamp: float
    disparity: np.ndarray                     # [H, W] float32 px
    depth_m: Optional[np.ndarray] = None      # [H, W] float32 m
    gt_disparity: Optional[np.ndarray] = None
    e2e_latency_s: float = 0.0
    confidence: Optional[np.ndarray] = None   # [H/8, W/8] in [0, 1]


def nonfinite_flags(disp: torch.Tensor) -> torch.Tensor:
    """Per-frame flags, 1.0 where a frame's disparity holds NaN or Inf."""
    return (~torch.isfinite(disp)).flatten(1).any(dim=1).float()


def _check_supported(cfg: Config) -> None:
    e = cfg.engine
    unsupported = {
        "engine.stage_timing": e.stage_timing,
        "engine.fetch_results=False": not e.fetch_results,
        "engine.device_microbatch": e.device_microbatch,
        "mesh serving": int(cfg.mesh.get("data", 1)) * int(cfg.mesh.get("tile", 1)) > 1,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not served by the port yet: {bad}")


class StereoEngine(ServingLoop):
    """Feed-many streaming engine on one device.

    Usage::

        eng = StereoEngine(cfg)            # seeded random weights on cuda:0
        eng.start()
        for frame in source: eng.feed(frame)
        eng.drain()
        for res in eng.results(): ...
        eng.stop()

    ``params`` is a flax parameter tree of the JAX package (nested numpy
    arrays, as orbax loads it); ``None`` means random weights from seed 0,
    made by :func:`~.weights.random_flax_params`.
    """

    _thread_prefix = "engine"

    def __init__(self, cfg: Config = Config(), params: Optional[Mapping] = None,
                 compute_depth: bool = True, emit_confidence: bool = False,
                 device: "str | torch.device | None" = None):
        _check_supported(cfg)
        self.device = resolve_device(device, "StereoEngine")
        self.cfg = cfg
        H, W = cfg.camera.height, cfg.camera.width
        self._init_serving(
            expected_len=H * (2 * W) * 3 // 2,
            height=H,
            width=W,
            feed_queue_depth=cfg.engine.feed_queue_depth,
            inflight=cfg.engine.inflight,
            drop_on_full=cfg.engine.drop_on_full,
        )
        if params is None:
            params = random_flax_params(cfg.model, seed=0)
        model = FastStereoNet(cfg.model, device=self.device)
        model.load_state_dict(from_flax_params(params, cfg.model))
        self.model = cast_convs(model, cfg.model.compute_dtype).eval()
        self._compute_depth = compute_depth
        self._emit_confidence = emit_confidence
        self._buckets = cfg.engine.batch_buckets
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # The weights were placed on the default stream.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    # ------------------------------------------------------------------
    # Pipeline
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def pipeline(self, sbs_batch: torch.Tensor):
        """[B, L] uint8 frames on the engine's device ->
        (disparity [B,H,W], depth | None, confidence | None, flags [B])."""
        H, W = self.cfg.camera.height, self.cfg.camera.width
        x = pp.nv12_ingest(sbs_batch, H, 2 * W, self.cfg.preprocess)
        left, right = pp.split_model_input(x)
        out = self.model(left, right)
        disp = out["disparity"]
        depth = disparity_to_depth_m(disp, self.cfg.camera) if self._compute_depth else None
        conf = out["confidence"] if self._emit_confidence else None
        return disp, depth, conf, nonfinite_flags(disp)

    def _bucket(self, n: int) -> int:
        return next(b for b in self._buckets if b >= n)

    def _assemble_batch(self, frames) -> np.ndarray:
        """[bucket, L] uint8 host batch, padded by repeating the last frame
        (pad rows are computed, then discarded)."""
        bufs = [np.asarray(f.sbs_nv12) for f in frames]
        bufs += [bufs[-1]] * (self._bucket(len(bufs)) - len(bufs))
        return np.stack(bufs)

    def _launch(self, host_batch: np.ndarray):
        """Enqueue one batch; returns (host outputs, completion event | None).

        On CUDA everything is enqueued on the engine's stream: the
        host-to-device copy, the pipeline, and non-blocking copies of the
        outputs into pinned host memory.  The outputs are valid once the
        returned event has completed.
        """
        batch = torch.from_numpy(host_batch)
        if self._stream is None:
            return [o.numpy() if o is not None else None
                    for o in self.pipeline(batch.to(self.device))], None
        with torch.cuda.stream(self._stream):
            dev = batch.pin_memory().to(self.device, non_blocking=True)
            outs = self.pipeline(dev)
            host = [o.to("cpu", non_blocking=True) if o is not None else None
                    for o in outs]
            event = torch.cuda.Event()
            event.record(self._stream)
        return host, event

    @staticmethod
    def _wait(event, deadline_s: float = DEVICE_DEADLINE_S) -> None:
        if event is None:
            return
        t_end = time.monotonic() + deadline_s
        while not event.query():
            if time.monotonic() > t_end:
                raise TimeoutError(f"device batch not done after {deadline_s:.0f} s")
            time.sleep(0.0005)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def warmup(self, buckets=None) -> None:
        """Run the pipeline once per bucket (default: the smallest and the
        largest), so that the first frames' latencies show steady state."""
        if buckets is None:
            buckets = sorted({self._buckets[0], self._buckets[-1]})
        for b in buckets:
            _, event = self._launch(np.zeros((b, self._expected_len), np.uint8))
            self._wait(event)

    # ------------------------------------------------------------------
    # Workers
    # ------------------------------------------------------------------

    def _dispatch_loop_inner(self) -> None:
        max_batch = self.cfg.engine.max_batch
        while not self._stop.is_set():
            try:
                frames = [self._feed_q.get(timeout=0.1)]
            except queue.Empty:
                continue
            # Adaptive micro-batch: take everything already queued, up to
            # max_batch, without waiting for more.
            while len(frames) < max_batch:
                try:
                    frames.append(self._feed_q.get_nowait())
                except queue.Empty:
                    break
            t0 = time.monotonic()
            outs, event = self._launch(self._assemble_batch(frames))
            self._put(self._inflight_q, (frames, outs, event, t0))
            self.metrics.dispatch_batch.record(len(frames))

    def _fetch_loop_inner(self) -> None:
        nan_guard = self.cfg.engine.nan_guard
        while not self._stop.is_set():
            try:
                frames, outs, event, t0 = self._inflight_q.get(timeout=0.1)
            except queue.Empty:
                continue
            self._wait(event)
            disp, depth, conf, flags = (
                o.numpy() if isinstance(o, torch.Tensor) else o for o in outs)
            now = time.monotonic()
            self.metrics.infer_latency.record(now - t0)
            emitted = 0
            for i, frame in enumerate(frames):
                if nan_guard and flags[i] > 0:
                    self.metrics.nan_drop()
                    continue
                self.metrics.e2e_latency.record(now - frame.timestamp)
                self._result_q.put(StereoResult(
                    index=frame.index,
                    timestamp=frame.timestamp,
                    disparity=disp[i],
                    depth_m=depth[i] if depth is not None else None,
                    gt_disparity=frame.gt_disparity,
                    e2e_latency_s=now - frame.timestamp,
                    confidence=conf[i] if conf is not None else None,
                ))
                emitted += 1
            if emitted:
                self.metrics.output_fps.tick(emitted)
            self._count_in_progress(-len(frames))
