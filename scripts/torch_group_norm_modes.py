#!/usr/bin/env python3
"""The GroupNorm kernel's two modes of statistics, side by side, on one card.

    python3 scripts/torch_group_norm_modes.py

For each (channels, spatial size) the two networks run at 720p and
batches 1, 8, 16 and 32 (bf16; float32 at 8 and 32), launches the kernel
with its statistics by the exact scan and by the walk in order
(``ops/kernels/group_norm.py``, ``_launch(..., sequential=False/True)``),
checks that the two give the same output, mean and rstd bit for bit, and
times each (median of 10-30 launches, L2 flushed, as ``chip_smoke.py``'s
``median_ms``), through the plain entry and the fused one (conv bias,
skip, LeakyReLU).  ``walks_in_order`` chooses between the modes from
N * C; this is the measurement behind its threshold.  Prints the card's
name and power limit, then one JSON object a line per shape, dtype and
batch.  About 2 minutes with the build; needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from hobot_stereonet_tpu_torch.models.layers import GN_EPS, num_groups  # noqa: E402
from hobot_stereonet_tpu_torch.ops.kernels import build  # noqa: E402
from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg  # noqa: E402

# (samples a frame, C, spatial): the GroupNorm inputs of both networks at 720p.
SHAPES = [(2, 32, (360, 640)), (2, 32, (180, 320)), (2, 32, (90, 160)), (1, 64, (90, 160)),
          (1, 32, (24, 90, 160)), (1, 32, (180, 320)), (1, 16, (360, 640)),
          (1, 12, (720, 1280))]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    build.library()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for mult, c, spatial in SHAPES:
        g = num_groups(c)
        w = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.rand(c, device=dev, generator=gen) - 0.5
        cb = torch.rand(c, device=dev, generator=gen) * 4 - 2
        fmt = torch.channels_last_3d if len(spatial) == 3 else torch.channels_last
        for dtype in (torch.bfloat16, torch.float32):
            for b in (1, 8, 16, 32) if dtype == torch.bfloat16 else (8, 32):
                n = mult * b
                x = (torch.randn((n, c) + spatial, device=dev, generator=gen) * 3 + 1).to(dtype)
                x = x.contiguous(memory_format=fmt)
                sk = torch.randn((n, c) + spatial, device=dev, generator=gen).to(dtype)
                sk = sk.contiguous(memory_format=fmt)
                entries = {"plain": (None, None, False), "fused": (cb, sk, True)}
                same = True
                for extra in entries.values():
                    outs = [kg._launch(x, g, w, bias, GN_EPS, *extra, sequential=m)[:3]
                            for m in (False, True)]
                    same &= all(torch.equal(u, v) for u, v in zip(*outs))
                iters = 10 if x.numel() > 2e8 else 30
                ms = {f"{name} {mode}": chip_smoke.median_ms(
                          lambda: kg._launch(x, g, w, bias, GN_EPS, *extra, sequential=seq),
                          flush, iters=iters)
                      for name, extra in entries.items()
                      for mode, seq in (("scan", False), ("walk", True))}
                print(json.dumps(dict(shape=[n, c, *spatial], dtype=str(dtype)[6:], batch=b,
                                      chains=n * c, chosen="walk" if kg.walks_in_order(n, c)
                                      else "scan", bit_equal=same, ms=ms)), flush=True)
                if not same:
                    return 1
                del x, sk
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
