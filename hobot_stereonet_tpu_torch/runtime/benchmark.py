"""Through-the-engine throughput measurement.

Counterpart of ``hobot_stereonet_tpu/runtime/benchmark.py``: the same
arguments and the same returned dict.  The method:

  * frames are pre-staged on the device (``data.stream.DeviceFrameRing``),
    so a batch is one gather on the device and no host copy;
  * results stay on the device (``fetch_results=False``); completion is
    the batch's CUDA event, and only the [B] non-finite flags come back;
  * the feed queue is filled before the workers start, so every dispatch
    is a full bucket (steady state), and warmup runs exactly that bucket
    through the ring.

Frames dropped by the non-finite guard are reported, not asserted away.
"""

from __future__ import annotations

import time
from typing import Mapping, Optional


def measure_engine_fps(
    model=None,
    params: Optional[Mapping] = None,
    model_cfg=None,
    *,
    preprocess_cfg=None,
    batch: int = 128,
    n_batches: int = 12,
    int8: bool = False,
    static_quant=None,
    stage_timing: bool = False,
    device_microbatch: int = 0,
    inflight: int = 4,
    ring_size: int = 4,
    height: int = 720,
    width: int = 1280,
    verbose_to=None,
    device=None,
) -> dict:
    """Stereo frames/s through :class:`~.engine.StereoEngine` at the given
    dispatch batch, as a plain dict.

    ``params`` is a flax parameter tree (``None``: seeded random weights;
    throughput does not depend on them).  ``model`` is the engine's
    (``"fast"``, the default, ``"classic"``, or a built port network),
    built from ``model_cfg``.  ``preprocess_cfg``
    defaults to the YUV input, the flagship's (the reference defaults to
    RGB).  ``int8=True`` serves w8a8 with dynamic scales, ``static_quant``
    (a calibration dict or ``calib.json`` path) with calibrated ones.  The
    engine runs on ``device`` (default ``cuda:0``).
    """
    from ..config import CameraConfig, Config, EngineConfig, PreprocessConfig, StereoNetConfig
    from ..data.stream import DeviceFrameRing
    from .engine import StereoEngine

    n_frames = batch * n_batches
    cfg = Config(
        camera=CameraConfig(height=height, width=width),
        model=model_cfg if model_cfg is not None else StereoNetConfig(),
        preprocess=(preprocess_cfg if preprocess_cfg is not None
                    else PreprocessConfig(color_space="yuv")),
        engine=EngineConfig(
            max_batch=batch,
            batch_buckets=(1, batch),
            feed_queue_depth=n_frames,
            drop_on_full=False,
            inflight=inflight,
            fetch_results=False,
            stage_timing=stage_timing,
            device_microbatch=device_microbatch,
        ),
    )
    eng = StereoEngine(cfg, params=params, compute_depth=False, int8=int8,
                       static_quant=static_quant, device=device, model=model or "fast")
    ring = DeviceFrameRing(height=height, width=width, ring_size=ring_size, device=eng.device)

    t_w = time.perf_counter()
    eng.warmup(buckets=[batch], ring=ring)
    warmup_s = time.perf_counter() - t_w
    if verbose_to is not None:
        print(f"warmup: {warmup_s:.1f}s", file=verbose_to)

    for f in ring.frames(n_frames):
        eng.feed(f)
    t0 = time.perf_counter()
    eng.start(warmup=False)
    eng.drain()
    dt = time.perf_counter() - t0
    eng.stop()

    snap = eng.metrics.snapshot()
    nan_dropped = snap.get("nan_dropped", 0)
    out = {
        "fps": round(snap["frames_out"] / dt, 2) if dt > 0 else 0.0,
        "frames_in": n_frames,
        "frames_out": snap["frames_out"],
        "nan_dropped": nan_dropped,
        "batch": batch,
        "dispatch_batch_mean": round(snap["dispatch_batch"]["mean"], 1),
        "infer_latency_ms": round(snap["infer_latency"]["mean_ms"], 1),
        "warmup_s": round(warmup_s, 1),
        "int8": bool(int8),
        "geometry": f"{width}x{height}",
    }
    if stage_timing and "preprocess_latency" in snap:
        out["preprocess_ms"] = round(snap["preprocess_latency"]["mean_ms"], 2)
        out["network_ms"] = round(snap["network_latency"]["mean_ms"], 2)
    if verbose_to is not None:
        print(
            f"engine: {out['frames_out']} frames"
            + (f" ({nan_dropped} NaN-dropped)" if nan_dropped else "")
            + f", mean dispatch batch {out['dispatch_batch_mean']}, "
            f"infer latency {out['infer_latency_ms']} ms/batch",
            file=verbose_to,
        )
    return out


def fps_in_turns(engines: Mapping[str, object], frames, n_frames: int, rounds: int = 3,
                 timeout: float = 300.0) -> dict:
    """Frames/s of several serving engines on the same host frames, in turns.

    ``engines`` maps names to started-never or stopped engines
    (:class:`~.engine.StereoEngine`, :class:`~.artifact.ArtifactEngine`),
    warmed up and built with ``drop_on_full=False``; ``frames`` is an
    [N, L] uint8 array of side-by-side NV12 frames at their geometry.  Each
    round runs every engine once over ``n_frames`` frames (cycling through
    ``frames``), in the given order on even rounds and reversed on odd
    ones, so that a slow spell of the shared host falls on each engine.  A
    run starts the engine's workers, feeds as fast as the engine takes
    frames (a feed waits while the queue is full), discards results as they
    come and stops after the drain; its frames/s is ``n_frames`` over the
    time from the start to the drain.  Returns ``{name: [frames/s of each
    round]}``; raises if a run lost a frame.
    """
    from ..data.stream import Frame

    names = list(engines)
    out = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            eng = engines[name]
            h, w = eng._geom_h, eng._geom_w
            got = 0
            t0 = time.perf_counter()
            eng.start(warmup=False)
            try:
                for i in range(n_frames):
                    eng.feed(Frame(time.monotonic(), frames[i % len(frames)], h, 2 * w, index=i))
                    while eng.poll(timeout=0) is not None:
                        got += 1
                eng.drain(timeout=timeout)
                dt = time.perf_counter() - t0
                while eng.poll(timeout=0) is not None:
                    got += 1
            finally:
                eng.stop()
            if got != n_frames:
                raise AssertionError(f"{name}: {got} results of {n_frames} frames")
            out[name].append(n_frames / dt)
    return out
