#!/usr/bin/env python3
"""The D-leading soft-argmin and the correlation backward, timed on one card.

    python3 scripts/torch_cost_kernels_ab.py [--tree DIR] [--sweep]

Times both kernels through their public wrappers (median of 30 launches,
L2 flushed, as ``chip_smoke.py``'s ``median_ms``) at the shapes the main
path gives them, beside their byte bounds: the D-leading soft-argmin on a
bf16 cost [B, 24, 90, 160] at B = 8 and 32 (CLASSIC serving, 720p) and
[8, 24, 16, 32] (CLASSIC training, crops of 128x256), and a float32 one at
B = 8; the correlation
backward in bf16 at [8, 90, 160, 32], [32, 90, 160, 32] and [8, 16, 32, 32]
with D = 24.  Each result is checked against its plain version first (the
bounds of ``chip_smoke.py``).

``--tree DIR`` imports the package from DIR, another checkout (say, a
parent commit unpacked with ``git archive``), and builds its kernels there:
run it and this tree in turns in one call to compare two versions on one
card.  ``--sweep`` (this tree only) also times the D-leading soft-argmin's
vector route on other plans than the one ``csrc/soft_argmin.cu`` fixes
(2 pixels a thread, 128 threads a block): it builds that file alone once a
plan, P = 2, 4 or 8 pixels a thread (float32 at most 4) x 64, 128 or 256
threads, through its ``HST_DLEAD_PIXELS`` and ``HST_DLEAD_THREADS`` macros,
into ``build/dlead_sweep/``, and calls each library's
``hst_soft_argmin_dlead`` directly; and it times the scalar route.  Each
default time is also taken after a flush that reads (``ms_read_flush``):
the writing flush leaves dirty L2 lines that the kernel's reads write back.

Prints the card's name and power limit, then one JSON object a line.  About
a minute with the build; needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COST_SHAPES = ((8, 24, 90, 160, "bf16"), (32, 24, 90, 160, "bf16"), (8, 24, 16, 32, "bf16"),
               (8, 24, 90, 160, "f32"))
BWD_SHAPES = ((8, 90, 160, 32, 24), (32, 90, 160, 32, 24), (8, 16, 32, 32, 24))
SWEEP = tuple((p, t) for p in (2, 4, 8) for t in (64, 128, 256))


def sweep_entries(build) -> dict:
    """{(P, threads): hst_soft_argmin_dlead of soft_argmin.cu built with that
    vector plan}, the builds run at once."""
    out = ROOT / "build" / "dlead_sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = build.CSRC_DIR / "soft_argmin.cu"
    libs = {pt: out / f"libdlead_p{pt[0]}_t{pt[1]}.so" for pt in SWEEP}
    cmds = [[build._nvcc(), *build.NVCC_FLAGS, "-shared", f"-DHST_DLEAD_PIXELS={p}",
             f"-DHST_DLEAD_THREADS={t}", "-o", str(lib), str(src)]
            for (p, t), lib in libs.items()]
    for cmd, rc, log in build._run(cmds):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log[-4000:]}")
    entries = {}
    for pt, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).hst_soft_argmin_dlead
        fn.argtypes = list(build._SIGNATURES["hst_soft_argmin_dlead"])
        fn.restype = ctypes.c_int
        entries[pt] = fn
    return entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT, help="checkout to import the package from")
    ap.add_argument("--sweep", action="store_true", help="time other D-leading vector plans")
    args = ap.parse_args()
    if args.sweep and args.tree.resolve() != ROOT:
        ap.error("--sweep times this tree's kernels only")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(args.tree.resolve()))

    import torch

    import chip_smoke
    from hobot_stereonet_tpu_torch.ops.kernels import build
    from hobot_stereonet_tpu_torch.ops.kernels import correlation as kc

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    build.library()
    entries = sweep_entries(build) if args.sweep else {}
    tree = str(args.tree.resolve())
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    for b, d, h, w, dt in COST_SHAPES:
        cost = 3 * torch.randn((b, d, h, w), device=dev, generator=gen)
        cost = cost.bfloat16() if dt == "bf16" else cost
        want = kc.soft_argmin_cost_plain(cost, 8.0)
        size = cost.element_size()
        bound = chip_smoke.bound(cost.numel() * size + 2 * b * h * w * 4, 5.0 * cost.numel())
        plans = {"default": lambda: kc.soft_argmin_cost(cost, 8.0)}
        if entries:
            plans["scalar"] = lambda: kc._soft_argmin_cost_launch(cost, 8.0, "scalar")
            for (p, t), fn in entries.items():
                if p * size <= 16:
                    plans[f"P{p} x {t}"] = lambda fn=fn: sweep_launch(build, fn, cost, 8.0)
        times = {}
        for label, run in plans.items():
            got = run()
            torch.cuda.synchronize()
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
            times[label] = chip_smoke.median_ms(run, flush)
        # The default plan after a flush that reads (clean L2 lines): without the
        # write-back of the dirty lines a writing flush leaves.
        clean = chip_smoke.median_ms(lambda: kc.soft_argmin_cost(cost, 8.0), flush,
                                     read_flush=True)
        print(json.dumps(dict(tree=tree, kernel="soft_argmin_cost", cost=[b, d, h, w], dtype=dt,
                              bound_ms=bound[0], ms=times, ms_read_flush=clean)), flush=True)
        del cost, want

    for b, h, w, c, d in BWD_SHAPES:
        fl, fr = (torch.randn((b, h, w, c), device=dev, generator=gen).bfloat16()
                  for _ in range(2))
        dcorr = torch.randn((b, h, w, d), device=dev, generator=gen).bfloat16()
        got = kc.correlation_volume_backward(dcorr, fl, fr)
        again = kc.correlation_volume_backward(dcorr, fl, fr)
        want = kc.correlation_volume_backward_plain(dcorr, fl, fr)
        torch.cuda.synchronize()
        detail = [chip_smoke.check_backward("correlation_bwd", g, p) for g, p in zip(got, want)]
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        bound = chip_smoke.bound(b * h * w * (d + 4 * c) * 2, 4.0 * b * h * w * d * c,
                                 chip_smoke.BF16_FLOPS)
        ms = chip_smoke.median_ms(lambda: kc.correlation_volume_backward(dcorr, fl, fr), flush)
        clean = chip_smoke.median_ms(lambda: kc.correlation_volume_backward(dcorr, fl, fr), flush,
                                     read_flush=True)
        print(json.dumps(dict(tree=tree, kernel="correlation_bwd", shape=[b, h, w, c, d],
                              bound_ms=bound[0], ms=ms, ms_read_flush=clean,
                              two_calls_bit_equal=same,
                              against_plain=detail)), flush=True)
        del fl, fr, dcorr, got, again, want
    return 0


def sweep_launch(build, fn, cost, scale):
    """The vector route of one sweep library on ``cost``."""
    import torch

    b, d, h, w = cost.shape
    disp = torch.empty((b, h, w), dtype=torch.float32, device=cost.device)
    conf = torch.empty_like(disp)
    build.check("soft_argmin_cost sweep", fn(
        cost.data_ptr(), disp.data_ptr(), conf.data_ptr(), b, d, h * w, float(scale),
        int(cost.dtype == torch.bfloat16), 1, build.stream_handle(cost)))
    return disp, conf


if __name__ == "__main__":
    sys.exit(main())
