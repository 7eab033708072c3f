#!/usr/bin/env python3
"""Host time of the port's plain GroupNorm (``group_norm_plain``) on the CPU.

    python3 scripts/torch_group_norm_cpu_time.py [--threads N]

Times one call at every GroupNorm shape of the flagship FastStereoNet and
the CLASSIC StereoNet at batch 1, for a 256x512 and a 1280x720 frame, in
float32 and bf16, and sums each network's forward (each shape times its
GroupNorms a forward).  It also times the float32 square sums taken one
once-rounded add a position, the form the vectorized runs replace, at one
shape.  Prints one JSON object a line.  Imports torch, numpy and the port.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hobot_stereonet_tpu_torch.models.layers import GN_EPS, num_groups  # noqa: E402
from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg  # noqa: E402

# (samples a frame, channels, spatial divisor, depth or None):
# {network: GroupNorms of that shape a forward}
SHAPES = (
    (2, 32, 2, None, {"fast": 1, "classic": 1}),
    (2, 32, 4, None, {"fast": 1, "classic": 1}),
    (2, 32, 8, None, {"fast": 13, "classic": 13}),
    (1, 64, 8, None, {"fast": 10}),
    (1, 32, 8, 24, {"classic": 4}),
    (1, 32, 4, None, {"classic": 13}),
    (1, 16, 2, None, {"classic": 9}),
    (1, 12, 1, None, {"classic": 7}),
)
FRAMES = {"256x512": (256, 512), "720p": (720, 1280)}


def seconds(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    return best


def square_sums_step_by_step(a: np.ndarray) -> np.ndarray:
    y = np.square(a.astype(np.float64))
    s = np.zeros((a.shape[0], a.shape[2]))
    for p in range(a.shape[1]):
        s = kg.add_f32(y[:, p], s).astype(np.float64)
    return s.astype(np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=torch.get_num_threads())
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    rng = np.random.default_rng(0)
    for frame, (h, w) in FRAMES.items():
        totals: dict = {}
        for mult, c, div, depth, per_forward in SHAPES:
            spatial = (h // div, w // div) if depth is None else (depth, h // div, w // div)
            fmt = torch.channels_last_3d if depth else torch.channels_last
            x = torch.from_numpy((3 * rng.standard_normal((mult, c) + spatial) + 5)
                                 .astype(np.float32))
            weight, bias = torch.ones(c), torch.zeros(c)
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype).contiguous(memory_format=fmt)
                s = seconds(lambda: kg.group_norm_plain(xd, num_groups(c), weight, bias, GN_EPS),
                            1 if frame == "720p" else 3)
                name = str(dtype).removeprefix("torch.")
                print(json.dumps(dict(frame=frame, shape=[mult, c, *spatial], dtype=name,
                                      seconds=s, threads=args.threads)), flush=True)
                for net, k in per_forward.items():
                    totals[(net, name)] = totals.get((net, name), 0.0) + k * s
        for (net, name), s in sorted(totals.items()):
            print(json.dumps(dict(frame=frame, network=net, dtype=name,
                                  seconds_a_forward=s, threads=args.threads)), flush=True)
    a = (3 * rng.standard_normal((2, 32768, 32)) + 5).astype(np.float32)
    fast = seconds(lambda: kg._fma_square_sums(a), 3)
    slow = seconds(lambda: square_sums_step_by_step(a), 1)
    print(json.dumps(dict(square_sums=list(a.shape), vectorized_seconds=fast,
                          step_by_step_seconds=slow)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
