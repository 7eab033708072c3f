#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds:

  1. device: the card's name and power limit; TF32 off for the comparisons;
  2. build: the CUDA kernels, from ``hobot_stereonet_tpu_torch/csrc`` (nvcc);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes with a batch of 8, and their times;
  4. reference: the flagship network in float32 on the card (through the
     kernels) against the same weights on the CPU (plain versions), on a
     small input;
  5. engine: ``StereoEngine`` with the flagship config
     (``checkpoints/flagship/config.json``: FastStereoNet, bf16, YUV input,
     1280x720, buckets 1..32, 4 batches in flight) and seeded random
     weights serves 32 synthetic frames; the kernels' launch counts are
     reset just before and read just after.  The frames are queued before
     the workers start, so dispatch serves them as one bucket of 32; the
     streamed results must then equal, bit for bit and frame by frame, one
     synchronous pipeline call on the same 32 frames.

Before the last line it prints one JSON object with each kernel's launches,
error, times and bound; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; a watchdog
dumps every thread's stack and exits if the run hangs.  Imports torch,
numpy and the port only.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

WATCHDOG_S = 480
faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

ROOT = Path(__file__).resolve().parent
T0 = time.monotonic()

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
B = 8                           # batch of the kernel phase
H, W = 720, 1280                # camera
N_FRAMES = 32                   # frames the engine serves
SPIN_CYCLES = 20_000_000        # about 10 ms of device time at H100 clocks


def phase(msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.1f} s] {msg}", flush=True)


def median_ms(fn, flush, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` launches, L2 flushed before each.

    A spin on the device precedes each start event, so that the host has
    enqueued the whole launch before the device reaches it: the interval
    holds device work only, not the host's time to submit it.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (ROOT / "hobot_stereonet_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from hobot_stereonet_tpu_torch.config import Config
    from hobot_stereonet_tpu_torch.models import FastStereoNet
    from hobot_stereonet_tpu_torch.ops import preprocess as pp
    from hobot_stereonet_tpu_torch.ops.kernels import build
    from hobot_stereonet_tpu_torch.ops.kernels import correlation as kc
    from hobot_stereonet_tpu_torch.ops.kernels import preprocess_kernel as kp
    from hobot_stereonet_tpu_torch.runtime.engine import Frame, StereoEngine
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params, random_flax_params

    # 1. device ---------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True).stdout.strip()
    card = smi.splitlines()[0]
    phase(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")

    # 2. build ------------------------------------------------------------------
    t = time.monotonic()
    build.library()
    phase(f"build: kernels ready in {time.monotonic() - t:.2f} s")

    # 3. kernels vs plain -------------------------------------------------------
    rng = np.random.default_rng(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    cfg = Config.from_json(str(ROOT / "checkpoints" / "flagship" / "config.json"))
    k = cfg.model.cost_resolution_divisor
    h, w = H // k, W // k
    c, d = cfg.model.feature_channels, cfg.model.num_disparities_coarse
    rows = []

    frames = torch.from_numpy(rng.integers(0, 256, (B, 3 * H * W), dtype=np.uint8)).to(dev)
    got = kp.nv12_sbs_preprocess(frames, H, W)
    want = kp.nv12_sbs_preprocess_plain(frames, H, W)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"nv12_ingest differs from its plain version: max |err| {err}")
    rows.append(dict(
        name=kp.NAME, route="cuda", source="hobot_stereonet_tpu_torch/csrc/nv12_ingest.cu",
        replaces="hobot_stereonet_tpu/ops/pallas/preprocess_kernel.py:74",
        tolerance="exact", max_abs_err=err,
        ms=median_ms(lambda: kp.nv12_sbs_preprocess(frames, H, W), flush),
        plain_ms=median_ms(lambda: kp.nv12_sbs_preprocess_plain(frames, H, W), flush),
        bound=bound(B * 3 * H * W + B * H * W * 6 * 2, 2.0 * B * H * W * 6),
        library_ms=None))

    fl = torch.from_numpy(rng.standard_normal((B, h, w, c), np.float32)).bfloat16().to(dev)
    fr = torch.from_numpy(rng.standard_normal((B, h, w, c), np.float32)).bfloat16().to(dev)
    got = kc.correlation_volume(fl, fr, d).float()
    want = kc.correlation_volume_plain(fl, fr, d).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel_ok = bool(((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-5).all())
    margin = torch.stack([got[:, :, :i, i].abs().max() if i else got.new_zeros(())
                          for i in range(d)]).max().item()
    if not rel_ok or margin != 0.0:
        raise AssertionError(f"correlation differs from its plain version: max |err| {err}, "
                             f"within 1 bf16 ulp + 1e-5: {rel_ok}, margin max {margin}")
    pairs = sum(w - i for i in range(d))            # (x, d) pairs with x >= d, per row
    rows.append(dict(
        name=kc.CORRELATION, route="cuda", source="hobot_stereonet_tpu_torch/csrc/correlation.cu",
        replaces="hobot_stereonet_tpu/ops/pallas/correlation.py:66",
        tolerance="1 bf16 ulp (relative 2**-7) + 1e-5; margin exactly 0", max_abs_err=err,
        ms=median_ms(lambda: kc.correlation_volume(fl, fr, d), flush),
        plain_ms=median_ms(lambda: kc.correlation_volume_plain(fl, fr, d), flush),
        bound=bound(2 * B * h * w * c * 2 + B * h * w * d * 2, 2.0 * B * h * pairs * c),
        library_ms=None))

    logits = torch.from_numpy(3.0 * rng.standard_normal((B, h, w, d), np.float32)
                              ).bfloat16().to(dev)
    got_d, got_c = kc.soft_argmin_confidence(logits, float(k))
    want_d, want_c = kc.soft_argmin_confidence_plain(logits, float(k))
    torch.cuda.synchronize()
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_c, want_c, rtol=1e-5, atol=1e-6)
    err = max((got_d - want_d).abs().max().item(), (got_c - want_c).abs().max().item())
    rows.append(dict(
        name=kc.SOFT_ARGMIN, route="cuda", source="hobot_stereonet_tpu_torch/csrc/soft_argmin.cu",
        replaces="hobot_stereonet_tpu/ops/pallas/correlation.py:124",
        tolerance="f32 rounding (rtol 1e-5, atol 1e-4 px / 1e-6)", max_abs_err=err,
        ms=median_ms(lambda: kc.soft_argmin_confidence(logits, float(k)), flush),
        plain_ms=median_ms(lambda: kc.soft_argmin_confidence_plain(logits, float(k)), flush),
        bound=bound(B * h * w * d * 2 + 2 * B * h * w * 4, 5.0 * B * h * w * d),
        library_ms=None))
    for r in rows:
        phase(f"kernel {r['name']}: max |err| {r['max_abs_err']:.3g} ({r['tolerance']}), "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), B={B}; {card}")
    del frames, fl, fr, logits, got, want, got_d, got_c, want_d, want_c, flush

    # 4. reference: float32 network on the card vs the CPU ----------------------
    params = random_flax_params(cfg.model, seed=0)
    f32 = dataclasses.replace(cfg.model, compute_dtype=torch.float32)

    def net(device):
        m = FastStereoNet(f32, device=device)
        m.load_state_dict(from_flax_params(params, f32))
        return m.eval()

    sh, sw = 64, 128
    small = torch.from_numpy(rng.integers(0, 256, (2, 3 * sh * sw), dtype=np.uint8))
    with torch.inference_mode():
        outs = []
        for device in (dev, torch.device("cpu")):
            x = pp.nv12_ingest(small.to(device), sh, 2 * sw, cfg.preprocess).float()
            o = net(device)(*pp.split_model_input(x))
            outs.append((o["disparity"].cpu(), o["confidence"].cpu()))
    (gd, gc), (cd, cc) = outs
    disp_err = (gd - cd).abs().max().item()
    conf_err = (gc - cc).abs().max().item()
    if not (disp_err <= 1e-3 and conf_err <= 1e-4 and torch.isfinite(gd).all()):
        raise AssertionError(f"network on the card vs CPU: disparity max |err| {disp_err} px "
                             f"(limit 1e-3), confidence {conf_err} (limit 1e-4)")
    phase(f"reference: float32 network on the card vs CPU at {sh}x{sw}: disparity max "
          f"|err| {disp_err:.3g} px (limit 1e-3), confidence {conf_err:.3g} (limit 1e-4)")

    # 5. engine -----------------------------------------------------------------
    t = time.monotonic()
    eng = StereoEngine(cfg, emit_confidence=True)
    eng.warmup(buckets=cfg.engine.batch_buckets)
    phase(f"engine: built and warmed buckets {cfg.engine.batch_buckets} "
          f"in {time.monotonic() - t:.1f} s")
    fl_len = 3 * H * W
    feed = rng.integers(0, 256, (N_FRAMES, fl_len), dtype=np.uint8)
    build.reset_launch_counts()
    t = time.monotonic()
    accepted = sum(eng.feed(Frame(time.monotonic(), feed[i], H, 2 * W, index=i))
                   for i in range(N_FRAMES))
    eng.start(warmup=False)
    eng.drain(timeout=240.0)
    wall = time.monotonic() - t
    results = list(eng.results(timeout=1.0))
    eng.stop()
    launches = dict(build.launch_counts)
    torch.cuda.synchronize()

    if accepted != N_FRAMES or len(results) != accepted:
        raise AssertionError(f"fed {N_FRAMES}, accepted {accepted}, results {len(results)}")
    if sorted(r.index for r in results) != list(range(N_FRAMES)):
        raise AssertionError("results do not cover every frame once")
    if eng.metrics.nan_dropped:
        raise AssertionError(f"{eng.metrics.nan_dropped} frames flagged non-finite")
    for r in results:
        if r.disparity.shape != (H, W) or r.disparity.dtype != np.float32:
            raise AssertionError(f"disparity {r.disparity.shape} {r.disparity.dtype}")
        if not (np.isfinite(r.disparity).all() and (r.disparity >= 0).all()):
            raise AssertionError(f"frame {r.index}: disparity not finite and >= 0")
        if not np.isfinite(r.depth_m).all():
            raise AssertionError(f"frame {r.index}: depth not finite")
        if r.confidence.shape != (h, w) or not (
                (r.confidence >= 0).all() and (r.confidence <= 1).all()):
            raise AssertionError(f"frame {r.index}: confidence outside [0, 1]")
    missing = [r["name"] for r in rows if launches.get(r["name"], 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}; {launches}")
    batches = eng.metrics.dispatch_batch.summary()
    if eng.metrics.dispatch_batch.n != 1:
        raise AssertionError(f"expected one dispatch of {N_FRAMES} frames, got {batches}")
    # The stream's copies, events and row split against one synchronous call.
    ref = [o.cpu().numpy() for o in eng.pipeline(torch.from_numpy(feed).to(dev))[:3]]
    for r in results:
        for name, got, want in zip(("disparity", "depth_m", "confidence"),
                                   (r.disparity, r.depth_m, r.confidence), ref):
            if not np.array_equal(got, want[r.index]):
                diff = np.abs(got - want[r.index]).max()
                raise AssertionError(f"frame {r.index}: streamed {name} differs from the "
                                     f"synchronous pipeline (max |err| {diff})")
    phase(f"engine: streamed disparity, depth and confidence of all {len(results)} frames "
          "equal the synchronous pipeline's bit for bit")
    phase(f"engine: {len(results)} frames of {W}x{H} in {wall:.3f} s = "
          f"{len(results) / wall:.2f} frames/s (smoke number, not a benchmark; "
          f"batches {batches}); launches {launches}; {card}")

    print(json.dumps({"kernels": [dict(
        name=r["name"], route=r["route"], source=r["source"], replaces=r["replaces"],
        launches=launches[r["name"]], max_abs_err=r["max_abs_err"], ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound"][0], bound_by=r["bound"][1],
        library_ms=r["library_ms"]) for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
