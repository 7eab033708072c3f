#!/usr/bin/env python3
"""The D-leading soft-argmin, the correlation backward and both soft-argmin
backward kernels, timed on one card.

    python3 scripts/torch_cost_kernels_ab.py [--tree DIR] [--sweep]
        [--outputs FILE] [--against FILE] [--only-backward]

Times them through their public wrappers (median of 30 launches,
L2 flushed, as ``chip_smoke.py``'s ``median_ms``) at the shapes the main
path gives them, beside their byte bounds: the D-leading soft-argmin on a
bf16 cost [B, 24, 90, 160] at B = 8 and 32 (CLASSIC serving, 720p) and
[8, 24, 16, 32] (CLASSIC training, crops of 128x256), and a float32 one at
B = 8; the correlation
backward in bf16 at [8, 90, 160, 32], [32, 90, 160, 32] and [8, 16, 32, 32]
with D = 24.  Each result is checked against its plain version first (the
bounds of ``chip_smoke.py``).

The soft-argmin backward kernels (``hst_soft_argmin_backward`` on bf16
logits [B, h, w, 24], ``hst_soft_argmin_dlead_backward`` on a bf16 cost
[B, 24, h, w]) at [8, 90, 160], [32, 90, 160] and the training shape [8, 16,
32], and the sharded training step's tiles [2, 16, 32] and [4, 8, 32]: with
both cotangents and with ``gd`` only (the training step's launch), beside
their byte bound, with the route and plan each took; for ``gd`` only also
ATen's softmax backward (``torch._softmax_backward_data``) on the same
shape in float32, a yardstick and not the same function.  Their outputs, in
bf16 and float32, with and without ``gc``, on seeded inputs with ties and
near ties in the max, are hashed: ``--outputs FILE`` writes the digests, ``--against FILE``
fails unless each equals the digest in FILE (bit for bit).

``--tree DIR`` imports the package from DIR, another checkout (say, a
parent commit unpacked with ``git archive``), and builds its kernels there:
run it and this tree in turns in one call to compare two versions on one
card (the parent with ``--outputs``, this tree with ``--against``).
``--sweep`` (this tree only) also times the D-leading soft-argmin's
vector route on other plans than the one ``csrc/soft_argmin.cu`` fixes
(2 pixels a thread, 128 threads a block): it builds that file alone once a
plan, P = 2, 4 or 8 pixels a thread (float32 at most 4) x 64, 128 or 256
threads, through its ``HST_DLEAD_PIXELS`` and ``HST_DLEAD_THREADS`` macros,
into ``build/dlead_sweep/``, and calls each library's
``hst_soft_argmin_dlead`` directly; and it times the scalar route.  For the
soft-argmin backward kernels ``--sweep`` times every staged plan of L lanes a
pixel and T pixels a tile that fits (``soft_argmin_backward_plan(...,
lanes=, pixels=)``), and the scalar route.  The D-leading soft-argmin's
and the correlation backward's default times are also taken after a flush
that reads (``ms_read_flush``):
the writing flush leaves dirty L2 lines that the kernel's reads write back.

``--only-backward`` times the soft-argmin backward kernels alone.

Prints the card's name and power limit, then one JSON object a line.  About
a minute with the build, a few more with ``--sweep``; needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COST_SHAPES = ((8, 24, 90, 160, "bf16"), (32, 24, 90, 160, "bf16"), (8, 24, 16, 32, "bf16"),
               (8, 24, 90, 160, "f32"))
BWD_SHAPES = ((8, 90, 160, 32, 24), (32, 90, 160, 32, 24), (8, 16, 32, 32, 24))
# The soft-argmin backward kernels: (B, h, w) at serving, training and the
# sharded step's tiles; D = 24.
SA_BWD_SHAPES = ((8, 90, 160), (32, 90, 160), (8, 16, 32), (2, 16, 32), (4, 8, 32))
SA_BWD_D = 24
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
    ap.add_argument("--outputs", type=Path, help="write the backward outputs' digests here")
    ap.add_argument("--against", type=Path, help="fail unless the digests equal these")
    ap.add_argument("--only-backward", action="store_true",
                    help="the soft-argmin backward kernels alone")
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

    soft_argmin_backward(args, kc, build, chip_smoke, dev, flush, tree)
    if args.only_backward:
        return 0

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


def sa_bwd_inputs(b, h, w, dtype, dev, seed):
    """Seeded logits [b, h, w, 24] (ties in the max at every third pixel, near
    ties at every seventh), the matching cost [b, 24, h, w] and the cotangents
    gd, gc [b, h, w] f32."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = 3 * torch.randn((b, h, w, SA_BWD_D), device=dev, generator=gen)
    flat = logits.view(-1, SA_BWD_D)
    top = flat[::3].amax(-1) + 1.0
    flat[::3, 2] = top
    flat[::3, 17] = top
    # Near ties (float32): a max of 1 and candidates one and two steps below it.
    near = flat[1::7]
    near -= near.amax(-1, keepdim=True) + 2.0
    near[:, 5], near[:, 9], near[:, 20] = 1.0, 1.0 - 2.0 ** -24, 1.0 - 2.0 ** -23
    logits = logits.to(dtype)
    cost = (-logits).permute(0, 3, 1, 2).contiguous()
    gd, gc = (torch.randn((b, h, w), device=dev, generator=gen) for _ in range(2))
    return logits, cost, gd, gc


def soft_argmin_backward(args, kc, build, chip_smoke, dev, flush, tree) -> None:
    """Both soft-argmin backward kernels: digests of every output (bf16 and
    float32, with and without gc), then bf16 times by shape and cotangents."""
    import torch

    kernels = ((kc.SOFT_ARGMIN_BWD, kc.soft_argmin_confidence_backward, 0),
               (kc.SOFT_ARGMIN_COST_BWD, kc.soft_argmin_cost_backward, 1))
    digests = {}
    for i, (b, h, w) in enumerate(SA_BWD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            inputs = sa_bwd_inputs(b, h, w, dtype, dev, 100 + i)
            gd, gc = inputs[2:]
            for name, fn, which in kernels:
                for cot, g in (("gd", None), ("gd+gc", gc)):
                    out = fn(inputs[which], gd, g, 8.0)
                    again = fn(inputs[which], gd, g, 8.0)
                    torch.cuda.synchronize()
                    if not torch.equal(out.view(torch.uint8), again.view(torch.uint8)):
                        raise AssertionError(f"{name} {b}x{h}x{w} {dtype} {cot}: two calls differ")
                    key = f"{name} {b}x{h}x{w} {str(dtype).removeprefix('torch.')} {cot}"
                    digests[key] = hashlib.sha256(out.cpu().view(torch.uint8).numpy()
                                                  .tobytes()).hexdigest()
    if args.outputs:
        args.outputs.parent.mkdir(parents=True, exist_ok=True)
        args.outputs.write_text(json.dumps(digests, indent=1))
    if args.against:
        want = json.loads(args.against.read_text())
        differ = sorted(k for k in digests if want.get(k) != digests[k])
        print(json.dumps(dict(tree=tree, kernel="soft_argmin_bwd digests", cases=len(digests),
                              against=str(args.against), bit_equal=not differ, differ=differ)),
              flush=True)
        if differ or set(want) != set(digests):
            raise AssertionError(f"outputs differ from {args.against}: {differ}")

    for i, (b, h, w) in enumerate(SA_BWD_SHAPES):
        logits, cost, gd, gc = sa_bwd_inputs(b, h, w, torch.bfloat16, dev, 100 + i)
        n = b * h * w
        yard = None
        for name, fn, which in kernels:
            x = (logits, cost)[which]
            layout = ("channel_last", "d_leading")[which]
            for cot, g in (("gd", None), ("gd+gc", gc)):
                # A tree from before the plans (one thread a pixel) has none.
                plan = kc.soft_argmin_backward_plan(
                    layout, b, SA_BWD_D, h * w, x.data_ptr(), x.element_size(), g is not None
                ) if hasattr(kc, "soft_argmin_backward_plan") else None
                nbytes = n * (2 * SA_BWD_D * x.element_size() + (8 if g is not None else 4))
                times = {"default": chip_smoke.median_ms(lambda: fn(x, gd, g, 8.0), flush)}
                if args.sweep:
                    plans = {"scalar": plan._replace(
                        route="scalar", lanes=1, threads=256, pixels=256, smem=0,
                        grid=(-(-(n if which == 0 else h * w) // 256), 1 if which == 0 else b))}
                    for lanes in kc.BWD_LANES:
                        for t in kc.BWD_TILES:
                            try:
                                plans[f"L{lanes} T{t}"] = kc.soft_argmin_backward_plan(
                                    layout, b, SA_BWD_D, h * w, x.data_ptr(), x.element_size(),
                                    g is not None, lanes=lanes, pixels=t)
                            except ValueError:
                                pass
                    want = fn(x, gd, g, 8.0)
                    for label, p in plans.items():
                        got = kc._soft_argmin_backward_launch(
                            name, x, gd, g, 8.0, (b, h, w), (b, SA_BWD_D, h * w), plan=p)
                        torch.cuda.synchronize()
                        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                            raise AssertionError(f"{name} {label}: differs from the default plan")
                        times[label] = chip_smoke.median_ms(
                            lambda p=p: kc._soft_argmin_backward_launch(
                                name, x, gd, g, 8.0, (b, h, w), (b, SA_BWD_D, h * w), plan=p),
                            flush)
                if cot == "gd" and yard is None:
                    # ATen's softmax backward in float32 on [n, 24]: the yardstick.
                    p32 = torch.softmax(logits.float().view(n, SA_BWD_D), -1)
                    grad = (gd.view(n, 1) * 8.0) * torch.arange(SA_BWD_D, device=dev)
                    yard = chip_smoke.median_ms(
                        lambda: torch._softmax_backward_data(grad, p32, -1, torch.float32), flush)
                print(json.dumps(dict(
                    tree=tree, kernel=name, shape=[b, h, w, SA_BWD_D], dtype="bf16",
                    cotangents=cot, plan=plan and plan._asdict(),
                    bound_ms=chip_smoke.bound(nbytes, 10.0 * n * SA_BWD_D)[0], ms=times,
                    **({"aten_softmax_backward_f32_ms": yard} if cot == "gd" else {}))),
                    flush=True)
        del logits, cost, gd, gc


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
