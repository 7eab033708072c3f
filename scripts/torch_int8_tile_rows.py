#!/usr/bin/env python3
"""The int8 conv kernel's tile height at CLASSIC's dilated and 3-D convs, on one card.

    python3 scripts/torch_int8_tile_rows.py

A dilated conv reads a halo 2 * dilation pixels wider than its tile in
each direction, and a 3-D conv three input planes for each output plane;
a taller tile (8 rows, two wgmma tiles a warp) reads and quantizes that
halo once for twice the outputs, at twice the accumulator registers.
For each such conv shape of CLASSIC at 720p in a chunk of 8 frames (bf16,
at the channels the kernel runs it at), this launches the kernel with
tiles of 4 and of 8 rows (``plan(..., rows=)``, ``int8_conv._launch``),
checks each against ``int8_conv_plain`` bit for bit (static scheme), and
times each (median of 10 launches, L2 flushed, as ``chip_smoke.py``'s
``median_ms``) beside the conv's int8 bound.  ``tile_rows`` in
``ops/kernels/int8_conv.py`` takes the faster height.  Prints the card's
name and power limit, each int8 kernel's registers, spills and IGMMA /
UTMALDG counts from the build, then one JSON object a line per shape.
About 2 minutes with the build; needs one CUDA card.
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
from hobot_stereonet_tpu_torch.ops.kernels import build  # noqa: E402
from hobot_stereonet_tpu_torch.ops.kernels import int8_conv as k8  # noqa: E402

# (label, N, Cin, Cout, depth (0: 2-D), H, W, dilation): CLASSIC's dilated and
# 3-D convs at 720p in a chunk of 8, at the channels the kernel runs them at.
SHAPES = [
    ("3-D 32 -> 32", 8, 32, 32, 24, 90, 160, 1),
    ("3-D 32 -> 1 (8)", 8, 32, 8, 24, 90, 160, 1),
    ("refine/4 dilation 2", 8, 32, 32, 0, 180, 320, 2),
    ("refine/4 dilation 4", 8, 32, 32, 0, 180, 320, 4),
    ("refine/4 dilation 8", 8, 32, 32, 0, 180, 320, 8),
    ("refine/2 dilation 2", 8, 16, 16, 0, 360, 640, 2),
    ("refine/2 dilation 4", 8, 16, 16, 0, 360, 640, 4),
    ("refine/2 dilation 8", 8, 16, 16, 0, 360, 640, 8),
    ("refine/1 12 (16) dilation 2", 8, 16, 16, 0, 720, 1280, 2),
    ("refine/1 12 (16) dilation 4", 8, 16, 16, 0, 720, 1280, 4),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    build.library()
    report = chip_smoke.kernel_report(build.BUILD_DIR / build.LIB_NAME,
                                      (build.BUILD_DIR / "build.log").read_text())
    for fn, info in sorted(report.items()):
        if fn.startswith("int8_conv"):
            print(json.dumps(dict(kernel=fn, registers=info.get("registers"),
                                  spill_bytes=info.get("spill_bytes"),
                                  igmma=info.get("sass", {}).get("IGMMA"),
                                  utmaldg=info.get("sass", {}).get("UTMALDG"))), flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    sx = torch.tensor([0.05], device=dev)
    qs = torch.tensor([1.0], device=dev) / sx
    ok = True
    for label, n, cin, cout, depth, h, w, dil in SHAPES:
        spatial = ((depth,) if depth else ()) + (h, w)
        kernel = (3,) * len(spatial)
        x = (torch.randn((n,) + spatial + (cin,), device=dev, generator=gen) * 2).bfloat16()
        x = x.movedim(-1, 1)
        q_w = torch.randint(-127, 128, (cout, cin) + kernel, device=dev, generator=gen,
                            dtype=torch.int32).to(torch.int8)
        s_k = torch.rand(cout, device=dev, generator=gen) * 1e-2 + 1e-4
        bias = torch.randn(cout, device=dev, generator=gen)
        packed = k8.pack_weight(q_w)
        want = k8.int8_conv_plain(x, q_w, s_k, bias, sx, qs, stride=1, dilation=dil,
                                  divide=False, out_dtype=torch.bfloat16)
        n_out = want.numel()
        bound = chip_smoke.bound(x.numel() * 2 + q_w.numel() + 2 * n_out,
                                 2.0 * n_out * q_w[0].numel(), chip_smoke.INT8_OPS)
        rows = {}
        for th in (4, 8):
            p = k8.plan(n, cin, h, w, cout, 3, 1, torch.bfloat16, torch.bfloat16, dil, depth, th)
            args = p.args()

            def run():
                return k8._launch(x, packed, s_k, bias, sx, qs, False, torch.bfloat16, args)

            same = torch.equal(run(), want)
            ok &= same
            rows[th] = dict(bit_equal=same, ms=chip_smoke.median_ms(run, flush, iters=10),
                            stages=p.stages, smem=p.smem, tiles=p.tiles)
        default = k8.tile_rows(False, k8.output_slices(cout)[0], dil, depth)
        print(json.dumps(dict(shape=label, input=[n, cin, *spatial], cout=cout, dilation=dil,
                              default_rows=default, bound_ms=bound[0], bound_by=bound[1],
                              rows=rows)), flush=True)
        del x, want
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
