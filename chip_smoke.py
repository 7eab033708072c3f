#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds:

  1. device: the card's name and power limit.  TF32 stays at PyTorch's
     defaults: the package turns it off wherever a network computes in
     float32 on the card (``utils/precision.py``), which phases 6 and 12
     check from inside the forward and the backward;
  2. build: the CUDA kernels, from ``hobot_stereonet_tpu_torch/csrc`` (one
     nvcc per source, all at once); each kernel's registers and spills
     (``-Xptxas -v``) and its instruction mix from ``cuobjdump -sass``: the
     bf16 correlation must hold HMMA (tensor-core) instructions, both int8
     conv kernels IGMMA (warpgroup int8 MMA, wgmma) and each instantiation
     of the Cin % 8 == 0 one (the three with 8-row tiles, which the dilated
     convs run, included) IGMMA and UTMALDG (TMA loads), the one-pass
     soft-argmin 128-bit loads, the
     ingest 128-bit stores, the GroupNorm's scan SHFL (warp shuffles) and
     its walk UBLKCP (bulk copies);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes with a batch of 8 and of 32 (the flagship's
     largest bucket), and their times beside their bounds; then the
     GroupNorm kernel against its plain version, bit for bit, at every
     (channels, spatial size) the two networks run at 720p (found by hooks
     on a forward of each), at batches 1, 8 and 32 in bf16 and in float32
     (checked, not timed: no serving path runs it), through its plain entry
     and its fused one (conv bias, skip and LeakyReLU; conv bias alone; the
     int8 blocks' form, skip and no bias), the plain entry and the first
     fused form also in the mode the launch does not choose (scan or walk in
     order, from N * C; checked, not timed): each bf16 time beside its byte
     bound, ATen's ``F.group_norm`` on
     the same input with the float32 casts (the library call, never called
     by the port) and the unfused sequence the blocks ran before (bias add,
     the plain entry, residual add, LeakyReLU); the float32 cases run in
     phase 13, beside its commands, their batches of 1 and 8 the first
     samples of the batch of 32;
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
     synchronous pipeline call on the same 32 frames;
  6. trained weights: the flagship's weights from
     ``hobot_stereonet_tpu_torch/reference`` (numpy ``.npz`` files) on
     the two 256x512 held-out scenes in float32 (max |error| <= 1e-3 px
     against the stored JAX output) and in bf16, and on the 720p frame in
     bf16 (median, p99.99 and max |error|, pixels over 1 px, held to the
     bounds the CPU tests hold the port to); a float32 ``StereoEngine``
     forward reads TF32 off inside its network, the bf16 one on;
  7. held-out accuracy: ``evaluate_dataset`` over the 120 held-out scenes
     in bf16 on the card; the mean EPE must lie in 0.8689 +- 0.0754 px
     (``accuracy_stats.json``), printed with D1 and the paired per-scene
     difference from the stored JAX EPEs;
  8. engine, benchmark surface: ``measure_engine_fps`` at 1280x720 with
     the flagship config and weights, frames from a ``DeviceFrameRing`` and
     ``fetch_results=False``, at batch 1 and 32, with and without
     ``stage_timing``; ring-fed results against a synchronous pipeline call,
     ``device_microbatch=8`` against the whole batch of 32, and a frame in a
     batch of 1 against the same frame in the batch of 32;
  9. profile: one steady ring-fed batch of 1 and of 32 under
     ``device_trace`` (``torch.profiler``): the device-busy share of the
     traced window, the ten largest device ops, and the elementwise
     launches that stood around each GroupNorm before its fusion (no
     LeakyReLU ``where`` may run; phases 10 and 11 check their profiles
     the same way);
 10. int8 and RGB (w8a8 serving, ``ops/quant.py``): the int8 conv kernel
     against its plain version (bit for bit) at each distinct conv shape of
     the flagship at 720p and at the tower's first conv with the float32
     input of the RGB ingest, batches 8 and 32, in both schemes, timed
     beside its bound (and its share of it) and cuDNN's bf16 conv of the
     same shape (for scale; not the same function), with the 28 convs' sum
     against cuDNN's; the host time of one ``int8_conv`` call at batch 1;
     the ingest's RGB and RGB + quantize modes in phase 3;
     the held-out EPE of the int8 network in the dynamic and the static
     scheme (``checkpoints/flagship/calib.json``) paired against the stored
     JAX int8 EPEs (|mean difference| <= 0.01 px, and inside 0.8689 +-
     0.0754 px); an int8 frame alone equal to the same frame in a batch of
     32, bit for bit, in both schemes; the bf16 engine's frame alone
     against in the batch of 32 as shipped and under deterministic cuDNN
     (with the batch-32 frames/s of each); ``StereoEngine(Config())`` (RGB)
     and the int8 engines serving 32 frames at 720p; ``measure_engine_fps``
     at batches 1 and 32 in int8 and int8 static; a ``torch.profiler``
     summary of one int8 batch of 32;
 11. the CLASSIC StereoNet (``model="classic"``, the trained weights of
     ``checkpoints/frontier_CLASSIC`` from ``reference/classic_params.npz``,
     bf16, RGB input): the D-leading soft-argmin kernel against its plain
     version at B = 8 and 32 on the [B, 24, 90, 160] bf16 cost, timed beside
     its bound; float32 on the card against the CPU and against the stored
     JAX output on the two 256x512 scenes; bf16 against the stored JAX
     outputs on the scenes and the 720p frame; the held-out EPE over the 120
     scenes (0.9374 +- 0.0775 px), paired against the stored JAX EPEs;
     ``StereoEngine(model="classic")`` with ``device_microbatch=8`` serving 32
     frames at 720p (streamed == synchronous, the kernel launched once per
     chunk), microbatched against the whole batch; ``measure_engine_fps`` at
     batches 1 and 32 with and without ``stage_timing`` (and batch 32 with
     one batch in flight), with the caching allocator's retries and peak
     memory; a ``torch.profiler`` summary of one ring-fed batch of 1 and of
     32; each conv's time at a chunk of 8, the 3-D conv in NCDHW against
     ``channels_last_3d``, and a 12-channel conv against the same padded to
     16 channels.
 11b. CLASSIC in int8 (``ops/quant.py``): all of its 53 convs take the int8
     kernel (eleven zero padded; the 3-D and the dilated ones too), none
     the library route; each conv shape at a chunk of 8 at 720p through the
     kernel (``Int8Conv.on_card``) against the plain version, bit for bit
     in both schemes, timed beside its int8 bound, the plain version and
     cuDNN's bf16 conv of the shape; at each 3-D and dilated shape also the
     library route of ``ops/int8_gemm.py`` (im2col, ``torch._int_mm`` and
     the ``int8_epilogue`` kernel: the yardstick, exact and timed as
     ``library_ms``) and its epilogue kernel against its plain version,
     timed beside its byte bound; both schemes (dynamic, and
     ``reference/classic_calib.json``) on the two stored scenes and the 720p
     frame against JAX's int8 outputs (``classic_int8_outputs.npz``, to the
     CPU tests' bounds); the held-out EPE over the 120 scenes paired against
     the stored JAX int8 EPEs (|mean difference| <= 0.01 px); the int8
     engines (``device_microbatch=8``) serving 32 frames at 720p, streamed
     == synchronous, with the kernels' launches (53 ``int8_conv`` a chunk,
     no ``int8_epilogue``) and the library route's calls (none) counted,
     and the int8 convs' calls by shape (hooks, held to those counts);
     ``measure_engine_fps`` at batches 1 and 32.

 12. training (``runtime/training.py``, ``train_loop.py``): the three backward
     kernels (``hst_correlation_backward``, ``hst_soft_argmin_backward``,
     ``hst_soft_argmin_dlead_backward``) against their plain versions in
     float32 (1e-5 of the largest magnitude) and bf16 (>= 99.9 % within one
     bf16 step, all within two), at the serving shapes (B = 8 and 32 at
     90x160) and the training one (B = 8 at 16x32), two calls bit-equal,
     timed beside their bounds; the soft-argmin ones with both cotangents
     and with ``gd`` only (the training step's launch), each on its staged
     route (``soft_argmin_backward_plan``; 16-byte cp.async in and 16-byte
     stores out in every instantiation's SASS, checked at the build), and
     so are the training loops' launches; one ``make_train_step`` of each
     network from its committed weights on the stored batch
     (``reference/*_train_step.npz``) against JAX's loss, gradient norm and
     gradients, in float32 and bf16
     (``reference.TRAIN_F32_*``, ``reference.bf16_grad_check``), with TF32
     read off in the float32 step's forward and backward;
     ``train_synthetic`` of the flagship from ``init_params``: 30 steps,
     batch 8, crops of 128x256, bf16, YUV (the mean loss of the last 5 steps
     below the first 5's), with the forward and backward kernels launched,
     its steps/s, the device step's own steps/s and one profiled step; the
     saved checkpoint served by ``StereoEngine`` on 8 frames at 720p; 10
     steps of CLASSIC (RGB), which launch the D-leading backward.
 13. the command line: ``python3 -m hobot_stereonet_tpu_torch.cli`` in
     processes of their own, several at once, each exiting 0 with its JSON
     line: ``infer --input-bin`` and ``infer`` on raw ``.nv12`` frames at
     720p, each against the same engine call in this process; ``eval
     --dataset layered --frames 8 --check-determinism`` of the flagship in
     bf16, with ``--int8-calib``, and of CLASSIC ``--int8``; ``calibrate`` of
     CLASSIC, then ``eval --int8-calib`` of that file; ``bench
     --streaming`` (alone, after the others); ``stream --frames 64 --unpaced
     --ring`` (started first: its frames render on the host for about a
     second each), whose frames must ride the natively built host ring
     (``build/hostio``); ``dump`` twice and ``compare`` where
     :data:`CARD_HAS_PIL`.  Beside them run phase 3's float32 GroupNorm
     checks, phase 15's ``slam`` commands, phase 14's artifact loaders and
     ``stream --artifact`` and ``infer --artifact`` on its bf16 artifact.
 14. the compiled artifact (``runtime/artifact.py``): the CLI's ``export`` of
     the flagship (its config and committed weights, 1280x720, buckets 1 and
     8, platform cuda) in bf16 and in int8 static (``calib.json``), two
     processes beside the build, waited for before phase 3 times
     anything; each artifact loaded in a fresh process that cannot import
     the networks' code (beside phase 13's commands), where every entry
     (nv12 and rgb, each bucket) launches a call the flagship's kernels
     (ingest 1, correlation 1, soft-argmin 1, GroupNorm 25, int8 conv 28 in
     int8; rgb: no ingest), one launch for each ``hst::`` operator of its
     graph, and ``ArtifactEngine`` serves 32 frames; each entry equals
     ``StereoEngine`` here bit for bit; ``ArtifactEngine`` against
     ``StereoEngine`` in bf16 at batch 1 and 8 on host frames, alone on the
     card: 2 rounds of 192 (batch 1) or 384 (batch 8) frames an engine, the
     two in turns, each round's frames/s
     (``scripts/torch_artifact_overhead.py`` runs 5 rounds of 512 and 1024,
     bf16 and int8 static);
 15. SLAM (``slam/``): the CLI's ``slam`` at its defaults (network disparity,
     the flagship's weights), with ``--gt-disparity`` (ATE under 0.05 m), with
     ``--loop-closure --confidence-gate 0.5``, and ``--odometry-root`` over an
     EuRoC-layout sequence the script writes: exit 0, never lost, an ATE
     each; ``StereoSLAM`` (tracking, windowed BA, loop closure) on the card
     against the CPU on the CPU tests' run (every frame's camera centre
     within 1e-4 m, the BA costs within 1e-4 relative); TF32 read off
     at each of the geometry's solves on the card with TF32 on outside.
 16. scale-out on one card (``parallel/``): ``initialize`` forms a
     single-rank NCCL group; a (1, 1) mesh ``StereoEngine`` of the flagship
     at 720p (bf16 and int8 static, a batch of 8) equals ``StereoEngine`` bit
     for bit with the same launches, synchronously and streamed; the split
     GroupNorm entries (``group_norm_stats``, ``group_norm_apply``) at every
     census shape at batch 8: stats then apply over the whole tensor
     bit-equal to the fused launch; on the two row tiles that tile = 2
     gives, each tile's sums and its output from the combined statistics
     bit-equal to their plain versions, the combined statistics within
     sqrt(n) ulps of the whole's, both entries timed at the tile shapes
     beside their byte bounds at batches 8 and 32; two gloo ranks on cuda:0
     (``scripts/torch_two_ranks_one_card.py``, started at the phase's
     start): tile = 2 engines of the flagship and CLASSIC on the stored
     720p scene within the CPU tests' bf16 bounds of the one-card engines,
     launching the split entries (counted by tile shape: the kernels
     line's launches) and no fused GroupNorm, and the distributed BA
     against one rank, then ``make_sharded_train_step`` of both networks on
     a (2, 1) and a (1, 2) mesh, float32 and bf16, two steps each: the
     first held to the stored JAX step (``reference.TRAIN_F32_*``,
     ``bf16_grad_check``), the ranks' parameters, moments and metrics
     bit-equal after each step, rank 0's launches counted (the kernels
     line's ``sharded_step_launches``); meanwhile the flagship's sharded
     step on the (1, 1) NCCL mesh equals ``make_train_step`` bit for bit
     (loss, EPE, norm, every gradient, the updated parameters; float32 and
     bf16; cuDNN deterministic) with the same launches; once the ranks are
     done, the two steps in turns (steps/s, stream and device time) and
     both bf16 engines' frames/s in turns at batch 8.

Phases 5, 7, 8, 10, 11, 11b, 12 and 16 reset the kernels' launch counts just before they
drive their path and fail if a kernel of it was not launched (the GroupNorm
on every network's path, as many times a forward as the network has
GroupNorms).  The held-out scenes are rendered on a host thread from the
start, beside phases 2-6.

Before the last line it prints one JSON object with each kernel's launches,
error, times and bound at each batch (a GroupNorm row's launches: the calls
at its very shape in the serving runs of phases 5 and 11, counted by hooks
on the engines' networks and held to the wrapper's count; a split GroupNorm
entry's: rank 0's launches at its very tile shape in phase 16's tile = 2
dispatches of both networks, counted the same way; the epilogue kernel's:
0, on no serving path), and, under ``library``, the int8 library route
(not a kernel; the yardstick) with its calls on the engines; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; a watchdog
dumps every thread's stack and exits if the run hangs.  Imports torch,
numpy and the port only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# The hang guard: the run's limit is 1200 s, the kernels' build included; a
# minute is left for the process to end.
WATCHDOG_S = 1140
faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

ROOT = Path(__file__).resolve().parent
T0 = time.monotonic()

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12             # H100 SXM bf16 on the tensor cores, dense
INT8_OPS = 1979e12              # H100 SXM int8 on the tensor cores, dense
BATCHES = (8, 32)               # batches of the kernel phase
H, W = 720, 1280                # camera
N_FRAMES = 32                   # frames the engine serves
BENCH_BATCHES = {1: 24, 32: 4}  # batches measure_engine_fps runs, per dispatch batch
# bf16 network against the stored JAX output, as the CPU tests hold it
# (tests/test_torch_reference.py): median |error| <= 0.03 px, at most
# 0.05 % of pixels over 1 px, none over 8 px (one coarse candidate).
BF16_MEDIAN_PX, BF16_OVER_1PX, BF16_MAX_PX = 0.03, 5e-4, 8.0
# device_microbatch=8 against the whole batch of 32 on the card: measured
# max |diff| 1.907e-6 px, 99.8625 % bit-equal with ATen's GroupNorm
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, PR 6 review round).
MICROBATCH_MAX_PX = 1e-4
SPIN_CYCLES = 20_000_000        # about 10 ms of device time at H100 clocks
# Ingest modes: (name, rgb, quantize).
INGEST_MODES = (("yuv", False, False), ("rgb", True, False), ("rgb+quantize", True, True))
# int8 held-out EPE against the stored JAX int8 EPEs of the same scheme:
# the paired mean difference, in px.
INT8_PAIRED_MEAN_PX = 0.01
# the kernels of the bf16 path
BF16_PATH = ("nv12_ingest", "group_norm", "correlation", "soft_argmin")
TRAIN_PATH = ("group_norm", "correlation", "correlation_bwd", "soft_argmin", "soft_argmin_bwd")
CLASSIC_PATH = ("nv12_ingest", "group_norm", "soft_argmin_cost")
CLASSIC_TRAIN_PATH = ("group_norm", "soft_argmin_cost", "soft_argmin_cost_bwd")
# Phase 16: the batch a mesh engine serves, the engines' rounds in turns (frames
# a round), and the tiled path's kernels (two gloo ranks on the card).
SCALE_BATCH = 8
SCALE_ROUNDS, SCALE_FRAMES = 2, 192
TILE_PATH = ("nv12_ingest", "group_norm_stats", "group_norm_apply", "correlation", "soft_argmin",
             "soft_argmin_cost")
# The sharded train step's kernels on the two ranks' meshes, and its steps a
# round on the (1, 1) mesh, timed in turns with make_train_step.
TILE_TRAIN_PATH = ("group_norm", "group_norm_stats", "group_norm_apply", "correlation",
                   "correlation_bwd", "soft_argmin", "soft_argmin_bwd", "soft_argmin_cost",
                   "soft_argmin_cost_bwd")
SHARDED_STEPS = 10
GN_BATCHES = (1, 8, 32)         # batches of the GroupNorm phase
# Backward kernels: (B, h, w) at the serving shapes and the training one
# (crops of 128x256 at 1/8).
BWD_SHAPES = ((8, H // 8, W // 8), (32, H // 8, W // 8), (8, 16, 32))
TRAIN_STEPS, CLASSIC_TRAIN_STEPS, TRAIN_BATCH, TRAIN_CROP = 30, 10, 8, (128, 256)
INT8_PATH = BF16_PATH + ("int8_conv",)
CLASSIC_INT8_PATH = CLASSIC_PATH + ("int8_conv",)
# CLASSIC's 53 int8 convs by route: the kernel (every one: 2-D, dilated and
# 3-D; Cout 1 and 12 and Cin 12 zero padded), the library route (none; it
# stays as the yardstick of phase 11b and launches no int8_epilogue on the
# engines' paths).
CLASSIC_INT8_ROUTES = (53, 0)
# CLASSIC int8 on the card against JAX's int8 output (the CPU tests' bounds,
# tests/test_torch_classic_int8.py: JAX's own int8 CLASSIC moves that far when
# 1 % or 10 % of its input moves by one ulp, up to 19.6 px at a pixel).
CLASSIC_INT8_MEDIAN_PX, CLASSIC_INT8_OVER_1PX, CLASSIC_INT8_MAX_PX = 0.15, 0.015, 16.0
# Whether the card's Python has PIL (it has, on the H100 machine this script
# targets; fixed here rather than by a caught import): the commands that read
# or write PNG files run only then.
CARD_HAS_PIL = True
# A command's disparity statistics against the same engine call in this process.
CLI_ENGINE_PX = 1e-3
# The artifact phase: buckets, frames served, and each entry's launches a call
# by kernel (the flagship: 25 GroupNorms, 28 convs in int8; the rgb entries
# have no ingest kernel).
ARTIFACT_BUCKETS = (1, 8)
ARTIFACT_FRAMES = 32
# ArtifactEngine against StereoEngine: frames an engine serves in a round, by
# batch, and the rounds (32-frame runs spread about twofold from run to run).
ARTIFACT_FPS_FRAMES, ARTIFACT_FPS_ROUNDS = {1: 192, 8: 384}, 2
ARTIFACT_LAUNCHES = {"nv12_ingest": 1, "correlation": 1, "soft_argmin": 1, "group_norm": 25}
ARTIFACT_INT8_CONVS = 28
# hst:: custom operators by the kernel each launches.
OP_KERNELS = {"nv12_sbs_preprocess": "nv12_ingest", "correlation_volume": "correlation",
              "soft_argmin_confidence": "soft_argmin", "soft_argmin_cost": "soft_argmin_cost",
              "group_norm_fused": "group_norm", "int8_conv": "int8_conv",
              "int8_epilogue": "int8_epilogue"}
# SLAM: the CPU tests' bound on the ATE on ground-truth disparity
# (tests/test_torch_slam_e2e.py), 0.05 m.  The card against the CPU on the same
# run: each frame's camera centre within 1e-4 m and each BA cost within 1e-4
# relative.  Both run the same float32 algorithm; only the rounding of the
# devices' reductions and solves differs (the two ATEs were 4e-9 m apart on an
# NVIDIA H100 80GB HBM3, PERF.md, PR 15), far below a centimetre-scale ATE.
SLAM_ATE_M, SLAM_CENTRE_TO_CPU_M, SLAM_COST_TO_CPU = 0.05, 1e-4, 1e-4


def phase(msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.1f} s] {msg}", flush=True)


def median_ms(fn, flush, iters: int = 30, warmup: int = 3, read_flush: bool = False) -> float:
    """Median device time of ``fn`` over ``iters`` launches, L2 flushed before each.

    A spin on the device precedes each start event, so that the host has
    enqueued the whole launch before the device reaches it: the interval
    holds device work only, not the host's time to submit it.  The flush
    writes ``flush`` (L2 then holds dirty lines that the kernel's reads
    must first write back), or with ``read_flush`` reads it (clean lines).
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if read_flush:
            flush.view(torch.float32).sum()
        else:
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


def bound(bytes_moved: float, flops: float, flops_per_s: float = F32_FLOPS):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


SASS_OPS = ("HMMA", "IMMA", "IGMMA", "UTMALDG", "UBLKCP", "LDSM", "LDGSTS", "LDG", "LDS", "STG",
            "STS", "MUFU.EX2", "SHFL")


def kernel_report(lib: Path, log: str) -> dict:
    """Per kernel function: ptxas's registers and spills, and SASS op counts.

    ``log`` is the build's ``-Xptxas -v`` output; the SASS comes from
    ``cuobjdump -sass`` of the built library.  Keys are the functions' names
    with a template argument, if any (e.g. ``correlation_bf16_kernel``,
    ``soft_argmin_generic_kernel<f>``).
    """
    from hobot_stereonet_tpu_torch.ops.kernels import build

    def template_args(rest: str) -> str:
        # I <arg>* E: a literal L<type><value>E, a name <length><chars>, or
        # a builtin type's letter.
        if not rest.startswith("I"):
            return ""
        i, args = 1, []
        while i < len(rest) and rest[i] != "E":
            m = re.match(r"L[a-z]+(\d+)E|(\d+)|([a-z])", rest[i:])
            if m is None:
                break
            if m.group(2):
                n, j = int(m.group(2)), i + len(m.group(2))
                args.append(rest[j:j + n].removeprefix("__nv_"))
                i = j + n
            else:
                args.append(m.group(1) or m.group(3))
                i += m.end()
        return f"<{','.join(args)}>"

    def short(mangled: str) -> str:
        # Itanium mangling: a name is its length, then its characters.  An
        # anonymous namespace adds a hashed prefix, so try every digit run;
        # a run inside the hash can read as a longer name that also ends in
        # "_kernel", so the shortest such name is the function's.
        found = []
        for m in re.finditer(r"(?=(\d+))", mangled):
            start = m.start() + len(m.group(1))
            ident = mangled[start:start + int(m.group(1))]
            if ident.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", ident):
                found.append((len(ident), ident, start))
        if not found:
            return mangled
        _, ident, start = min(found)
        return ident + template_args(mangled[start + len(ident):])

    report: dict = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = short(m.group(1))
            report.setdefault(name, {})
        elif name and re.search(r"Used \d+ registers", line):
            report[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        elif name and "spill stores" in line:
            report[name]["spill_bytes"] = sum(map(int, re.findall(r"(\d+) bytes spill", line)))
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short(m.group(1))
            report.setdefault(name, {})["sass"] = dict.fromkeys(SASS_OPS, 0)
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            op = m.group(1)
            counts = report[name]["sass"]
            for key in SASS_OPS:
                if op == key or op.startswith(key + "."):
                    counts[key] += 1
            if op.startswith(("LDG", "LDS", "STG", "STS")):
                for width in ("64", "128"):
                    if width in op.split(".")[1:]:
                        key = f"{op.split('.')[0]}.{width}"
                        counts[key] = counts.get(key, 0) + 1
    return report


def kernel_phase(b, rng, flush, dev, h, w, c, d, scale, card) -> list:
    """Each kernel against its plain version at batch ``b``; their times and bounds."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch.ops.kernels import correlation as kc
    from hobot_stereonet_tpu_torch.ops.kernels import preprocess_kernel as kp

    rows = []
    frames = torch.from_numpy(rng.integers(0, 256, (b, 3 * H * W), dtype=np.uint8)).to(dev)
    for mode, rgb, quantize in INGEST_MODES:
        kw = dict(rgb=rgb, quantize=quantize)
        got = kp.nv12_sbs_preprocess(frames, H, W, **kw)
        want = kp.nv12_sbs_preprocess_plain(frames, H, W, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"nv12_ingest ({mode}) differs from its plain version: "
                                 f"max |err| {err}")
        rows.append(dict(
            name=kp.NAME, mode=mode, route="cuda",
            source="hobot_stereonet_tpu_torch/csrc/nv12_ingest.cu",
            replaces="hobot_stereonet_tpu/ops/pallas/preprocess_kernel.py:74", batch=b,
            tolerance="exact", max_abs_err=err,
            ms=median_ms(lambda: kp.nv12_sbs_preprocess(frames, H, W, **kw), flush),
            ms_read_flush=median_ms(lambda: kp.nv12_sbs_preprocess(frames, H, W, **kw), flush,
                                    read_flush=True),
            plain_ms=median_ms(lambda: kp.nv12_sbs_preprocess_plain(frames, H, W, **kw), flush,
                               iters=10),
            bound=bound(b * 3 * H * W + b * H * W * 6 * got.element_size(),
                        (8.0 if rgb else 2.0) * b * H * W * 6),
            library_ms=None))
        del got, want
    del frames

    fl = torch.from_numpy(rng.standard_normal((b, h, w, c), np.float32)).bfloat16().to(dev)
    fr = torch.from_numpy(rng.standard_normal((b, h, w, c), np.float32)).bfloat16().to(dev)
    got = kc.correlation_volume(fl, fr, d)
    want = kc.correlation_volume_plain(fl, fr, d)
    lo, hi = kc.correlation_gram_band(fl, fr, d)
    torch.cuda.synchronize()
    equal = (got == want).float().mean().item()
    ulps = kc.bf16_ulp_distance(got, want)
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    in_band = bool(((got >= lo.float() - 1e-5) & (got <= hi.float() + 1e-5)).all())
    margin = torch.stack([got[:, :, :i, i].abs().max() if i else got.new_zeros(())
                          for i in range(d)]).max().item()
    detail = (f"bit-equal {equal:.6f}, max {ulps.max().item()} ulp, "
              f"{int((ulps > 1).sum().item())} values beyond 1 ulp, max |err| {err}, "
              f"margin max {margin}")
    if equal < 0.999 or not in_band or margin != 0.0:
        raise AssertionError(f"correlation differs from its plain version at B={b}: {detail}; "
                             f"within its Gram band + 1e-5: {in_band}")
    pairs = sum(w - i for i in range(d))            # (x, d) pairs with x >= d, per row
    rows.append(dict(
        name=kc.CORRELATION, route="cuda", source="hobot_stereonet_tpu_torch/csrc/correlation.cu",
        replaces="hobot_stereonet_tpu/ops/pallas/correlation.py:66", batch=b,
        tolerance=f">= 99.9% bit-equal, within the Gram band (one bf16 step of the Gram "
                  f"value) + 1e-5, margin exactly 0; {detail}", max_abs_err=err,
        ms=median_ms(lambda: kc.correlation_volume(fl, fr, d), flush),
        ms_read_flush=median_ms(lambda: kc.correlation_volume(fl, fr, d), flush,
                                read_flush=True),
        plain_ms=median_ms(lambda: kc.correlation_volume_plain(fl, fr, d), flush),
        bound=bound(2 * b * h * w * c * 2 + b * h * w * d * 2, 2.0 * b * h * pairs * c,
                    BF16_FLOPS),
        library_ms=None))
    del fl, fr, got, want, ulps, lo, hi

    logits = torch.from_numpy(3.0 * rng.standard_normal((b, h, w, d), np.float32)
                              ).bfloat16().to(dev)
    if not kc.uses_vector_kernel(logits):
        raise AssertionError("the main path's logits do not take the one-pass kernel")
    got_d, got_c = kc.soft_argmin_confidence(logits, scale)
    want_d, want_c = kc.soft_argmin_confidence_plain(logits, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_c, want_c, rtol=1e-5, atol=1e-6)
    err = max((got_d - want_d).abs().max().item(), (got_c - want_c).abs().max().item())
    rows.append(dict(
        name=kc.SOFT_ARGMIN, route="cuda", source="hobot_stereonet_tpu_torch/csrc/soft_argmin.cu",
        replaces="hobot_stereonet_tpu/ops/pallas/correlation.py:124", batch=b,
        tolerance="f32 rounding (rtol 1e-5, atol 1e-4 px / 1e-6)", max_abs_err=err,
        ms=median_ms(lambda: kc.soft_argmin_confidence(logits, scale), flush),
        ms_read_flush=median_ms(lambda: kc.soft_argmin_confidence(logits, scale), flush,
                                read_flush=True),
        plain_ms=median_ms(lambda: kc.soft_argmin_confidence_plain(logits, scale), flush),
        bound=bound(b * h * w * d * 2 + 2 * b * h * w * 4, 5.0 * b * h * w * d),
        library_ms=None))
    del logits, got_d, got_c, want_d, want_c

    for r in rows:
        name = r["name"] + (" " + r["mode"] if "mode" in r else "")
        phase(f"kernel {name} B={b}: max |err| {r['max_abs_err']:.3g} ({r['tolerance']}), "
              f"kernel {r['ms']:.4f} ms ({r['ms_read_flush']:.4f} ms after a read flush), "
              f"plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}, "
              f"{100 * r['bound'][0] / r['ms']:.0f}% of it); {card}")
    return rows


def groupnorm_census(dev) -> dict:
    """The GroupNorm inputs of both networks at 720p: {(samples a frame, C,
    spatial): {network: GroupNorms of that shape a forward}}, from hooks on
    one bf16 forward of each (seeded random weights) at batch 1."""
    import torch

    from hobot_stereonet_tpu_torch.config import Config, StereoNetConfig
    from hobot_stereonet_tpu_torch.models import build_model
    from hobot_stereonet_tpu_torch.models.layers import GroupNorm

    census: dict = {}
    flagship = ROOT / "checkpoints" / "flagship" / "config.json"
    for name, mcfg in (("fast", Config.from_json(str(flagship)).model),
                       ("classic", StereoNetConfig())):
        torch.manual_seed(0)
        net = build_model(name, mcfg, dev).eval()
        seen = []
        hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
                 for m in net.modules() if isinstance(m, GroupNorm)]
        frames = torch.rand((1, H, W, 3), device=dev) * 2 - 1
        with torch.inference_mode():
            net(frames, torch.roll(frames, -3, 2))
        for hk in hooks:
            hk.remove()
        for x in seen:
            fmt = torch.channels_last_3d if x.dim() == 5 else torch.channels_last
            if x.dtype != torch.bfloat16 or not x.is_contiguous(memory_format=fmt):
                raise AssertionError(f"{name}: a GroupNorm input {tuple(x.shape)} {x.dtype} "
                                     f"is not channels-last bf16")
            key = (x.shape[0], x.shape[1], tuple(x.shape[2:]))
            census.setdefault(key, {}).setdefault(name, 0)
            census[key][name] += 1
        del net, seen, frames
    torch.cuda.empty_cache()
    return census


def _plain_by_chunks(fn, x, *rest, chunks: int = 4):
    """``fn(x[i:j], *rest)`` over chunks of the batch on host threads (the
    plain version is per sample), its tensor outputs concatenated."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    parts = [c for c in x.split(max(1, -(-x.shape[0] // chunks))) if c.shape[0]]
    with ThreadPoolExecutor(max_workers=len(parts)) as pool:
        outs = list(pool.map(lambda c: fn(c, *rest), parts))
    return tuple(torch.cat(ts) for ts in zip(*outs))


def group_norm_phase(dev, census, flush, card, dtype) -> list:
    """The GroupNorm kernel against its plain version, bit for bit (output,
    mean and rstd), at every shape of ``census`` and batch of
    :data:`GN_BATCHES`, through both entries: the plain GroupNorm, and the
    fused one with the conv bias, the skip and the LeakyReLU (and its
    int8 form, without the bias, and without the skip), in ``dtype`` (bf16
    or float32), in the mode the launch chooses and in the other.  The bf16
    cases timed beside the byte bound (inputs read once, outputs written
    once), ATen's ``F.group_norm`` with the float32 casts, and the unfused
    sequence the blocks ran before (bias add, the plain entry, residual
    add, LeakyReLU).  float32 runs on no serving path: its cases are
    checked, not timed, and its smaller batches are the first samples of
    the largest, held to the same plain result (the plain version is per
    sample), which phase 13 runs beside its commands."""
    import torch
    import torch.nn.functional as F

    from hobot_stereonet_tpu_torch.models.layers import GN_EPS, num_groups
    from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg

    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []
    src = dict(route="cuda", source="hobot_stereonet_tpu_torch/csrc/group_norm.cu",
               replaces="hand-written without a Pallas counterpart (flax GroupNorm, "
                        "hobot_stereonet_tpu/models/layers.py, left to XLA)")
    for (mult, c, spatial), per_net in sorted(census.items()):
        g = num_groups(c)
        w = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.rand(c, device=dev, generator=gen) - 0.5
        cb = torch.rand(c, device=dev, generator=gen) * 4 - 2
        fmt = torch.channels_last_3d if len(spatial) == 3 else torch.channels_last
        view = (1, -1) + (1,) * len(spatial)
        tag = "f32" if dtype == torch.float32 else "bf16"
        plain = None                             # float32: the largest batch's plain result
        for b in (sorted(GN_BATCHES, reverse=True) if tag == "f32" else GN_BATCHES):
            n = mult * b
            if plain is None:
                x = (torch.randn((n, c) + spatial, device=dev, generator=gen) * 3 + 1)
                x = x.to(dtype).contiguous(memory_format=fmt)
                sk = torch.randn((n, c) + spatial, device=dev, generator=gen).to(dtype)
                sk = sk.contiguous(memory_format=fmt)
                a = x + cb.to(dtype).view(view)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                want, w_mean, w_rstd = _plain_by_chunks(kg.group_norm_plain, x, g, w, bias,
                                                        GN_EPS)
                end.record()
                torch.cuda.synchronize()
                plain_ms = start.elapsed_time(end)
                want_a, a_mean, a_rstd = _plain_by_chunks(kg.group_norm_plain, a, g, w,
                                                          bias, GN_EPS)
                if tag == "f32":
                    plain = (x, sk, a, want, w_mean, w_rstd, want_a, a_mean, a_rstd)
            else:
                x, sk, a, want, w_mean, w_rstd, want_a, a_mean, a_rstd = (
                    t[:n] for t in plain)
            # The launch's own mode (walk in order or scan, from N * C) and the other.
            in_order = kg.walks_in_order(n, c)
            mode, other = ("walk in order", "scan") if in_order else ("scan", "walk in order")
            checks = {
                "plain entry": (kg._group_norm_cuda(x, g, w, bias, GN_EPS),
                                (want, w_mean, w_rstd)),
                f"plain entry, {other}": (
                    kg._launch(x, g, w, bias, GN_EPS, None, None, False,
                               sequential=not in_order)[:3], (want, w_mean, w_rstd)),
                "fused, bias + skip": (
                    kg._group_norm_cuda(x, g, w, bias, GN_EPS, conv_bias=cb, skip=sk,
                                        activate=True),
                    (kg.leaky_relu(sk + want_a), a_mean, a_rstd)),
                f"fused, bias + skip, {other}": (
                    kg._launch(x, g, w, bias, GN_EPS, cb, sk, True,
                               sequential=not in_order)[:3],
                    (kg.leaky_relu(sk + want_a), a_mean, a_rstd)),
                "fused, bias": (
                    kg._group_norm_cuda(x, g, w, bias, GN_EPS, conv_bias=cb, activate=True),
                    (kg.leaky_relu(want_a), a_mean, a_rstd)),
                "fused, int8 form (no bias) + skip": (
                    kg._group_norm_cuda(x, g, w, bias, GN_EPS, skip=sk, activate=True),
                    (kg.leaky_relu(sk + want), w_mean, w_rstd)),
            }
            torch.cuda.synchronize()
            for label, (got, exp) in checks.items():
                if not all(torch.equal(u, v) for u, v in zip(got, exp)):
                    raise AssertionError(
                        f"group_norm {label} {n}x{c}x{spatial} {tag} differs from its plain "
                        f"version: bit-equal {float((got[0] == exp[0]).float().mean())}, "
                        f"statistics equal {torch.equal(got[1], exp[1])} / "
                        f"{torch.equal(got[2], exp[2])}")
            err = max((got[0].float() - exp[0].float()).abs().max().item()
                      for got, exp in checks.values())
            del want, want_a, checks
            shape = f"{n}x{c}x{'x'.join(map(str, spatial))}"
            if dtype == torch.float32:
                phase(f"kernel group_norm [{shape}] f32 B={b}: exact, plain entry and fused "
                      f"(bias + skip, bias, no bias + skip), {mode} and {other} (not timed)")
                del x, sk, a
                continue
            elems = x.numel()
            esize = x.element_size()
            iters = 10 if elems > 2e8 else 30
            ms = median_ms(lambda: kg.group_norm(x, g, w, bias, GN_EPS), flush, iters=iters)
            fused_ms = median_ms(lambda: kg.group_norm_fused(
                x, g, w, bias, GN_EPS, conv_bias=cb, skip=sk, activate=True), flush,
                iters=iters)
            fused_noskip_ms = median_ms(lambda: kg.group_norm_fused(
                x, g, w, bias, GN_EPS, conv_bias=cb, activate=True), flush, iters=iters)
            lib_ms = median_ms(lambda: F.group_norm(x.float(), g, w, bias, GN_EPS).to(dtype),
                               flush, iters=iters)
            seq_ms = median_ms(lambda: kg.leaky_relu(sk + kg.group_norm(
                x + cb.to(dtype).view(view), g, w, bias, GN_EPS)), flush, iters=iters)
            # One fused call's six phases (kernel diagnostics: block 0's clock).
            clock = torch.zeros(9, dtype=torch.int64, device=dev)
            kg._launch(x, g, w, bias, GN_EPS, cb, sk, True, clock=clock)
            clock = clock.tolist()
            phases_us = [round((b_ - a_) / 1e3, 1) for a_, b_ in zip(clock[:6], clock[1:7])]
            # Launch counts by shape and form (group_norm_shapes).
            key = (n, c, spatial)
            common = dict(name=kg.NAME, shape=shape, batch=b, per_forward=per_net,
                          tolerance="exact (output, mean, rstd)", max_abs_err=err,
                          plain_ms=plain_ms, **src)
            rows.append(dict(common, mode=f"plain entry, {tag}, {mode}", ms=ms,
                             library_ms=lib_ms, key=key + ("plain",),
                             bound=bound(2.0 * esize * elems, 8.0 * elems)))
            rows.append(dict(common, mode=f"fused bias + skip + LeakyReLU, {tag}, {mode}",
                             ms=fused_ms, library_ms=None, unfused_ms=seq_ms,
                             key=key + ("skip",),
                             bound=bound(3.0 * esize * elems, 12.0 * elems)))
            rows.append(dict(common, mode=f"fused bias + LeakyReLU, {tag}, {mode}",
                             ms=fused_noskip_ms, library_ms=None, key=key + ("no skip",),
                             bound=bound(2.0 * esize * elems, 10.0 * elems)))
            r0, r1, r2 = rows[-3:]
            phase(f"kernel group_norm [{shape}] {tag} (per forward {per_net}) B={b}: exact, "
                  f"plain entry and fused (bias + skip, bias, no bias + skip), {mode} and "
                  f"{other}; plain entry {ms:.4f} ms (bound {r0['bound'][0]:.4f}, "
                  f"{100 * r0['bound'][0] / ms:.0f}%), ATen F.group_norm with the float32 "
                  f"casts {lib_ms:.4f} ms (kernel / "
                  f"ATen {ms / lib_ms:.3f}); fused with skip {fused_ms:.4f} ms (bound "
                  f"{r1['bound'][0]:.4f}, {100 * r1['bound'][0] / fused_ms:.0f}%), the "
                  f"unfused sequence {seq_ms:.4f} ms; fused without skip "
                  f"{fused_noskip_ms:.4f} ms (bound {r2['bound'][0]:.4f}, "
                  f"{100 * r2['bound'][0] / fused_noskip_ms:.0f}%); plain version "
                  f"{plain_ms:.1f} ms; fused call's phases (sums, prediction, maps, ordered "
                  f"walk, statistics, output) {phases_us} us, {clock[7]} windows and "
                  f"{clock[8]} segments stepped alone in its ordered walk; {card}")
            del x, sk, a
        torch.cuda.empty_cache()
    return rows


def int8_conv_shapes(cfg, b: int) -> list:
    """The flagship's distinct conv shapes at 720p and ``b`` frames:
    (label, convs of that shape, N, Cin, Cout, kernel, stride, H, W, input
    dtype) with N, H, W the conv's input (the tower runs on both eyes,
    N = 2b).  The 28 convs of a batch in bf16, then the tower's first conv
    with the float32 input that the RGB ingest hands it (``Config()``)."""
    import torch

    m = cfg.model
    c, d = m.feature_channels, m.num_disparities_coarse
    agg, k = max(m.aggregation_channels, 64), m.cost_resolution_divisor
    h, w = H // k, W // k
    bf = torch.bfloat16
    shapes = [(f"tower ConvBlock_{i}", 1, 2 * b, m.input_channels if i == 0 else c, c, 5, 2,
               H >> i, W >> i, bf) for i in range(m.downsample_factor)]
    return shapes + [
        ("tower 3x3", 2 * m.num_feature_res_blocks + 1, 2 * b, c, c, 3, 1, h, w, bf),
        ("aggregation ConvBlock_0", 1, b, d + c, agg, 3, 1, h, w, bf),
        ("aggregation and mask 3x3", 2 * m.num_aggregation_layers + 1, b, agg, agg, 3, 1, h, w,
         bf),
        ("aggregation Conv_0", 1, b, agg, d, 3, 1, h, w, bf),
        ("upsample_mask", 1, b, 64, 9 * k * k, 3, 1, h, w, bf),
        ("tower ConvBlock_0, float32 in", 1, 2 * b, m.input_channels, c, 5, 2, H, W,
         torch.float32),
    ]


def int8_kernel_phase(b, rng, flush, dev, cfg, card) -> list:
    """The int8 conv against its plain version at each flagship conv shape,
    in both schemes, bit for bit; its time beside its bound and cuDNN's
    bf16 conv of the same shape."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch.models.layers import SameConv2d
    from hobot_stereonet_tpu_torch.ops.kernels import int8_conv as k8

    rows = []
    shapes = int8_conv_shapes(cfg, b)
    if sum(s[1] for s in shapes if s[-1] == torch.bfloat16) != 28:
        raise AssertionError(f"expected the flagship's 28 convs, got {shapes}")
    for label, count, n, cin, cout, k, stride, h, w, x_dtype in shapes:
        x = torch.from_numpy(rng.uniform(-1, 1, (n, h, w, cin)).astype(np.float32)
                             ).to(x_dtype).to(dev).permute(0, 3, 1, 2)
        q_w = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8)).to(dev)
        packed = k8.pack_weight(q_w)
        s_k = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(dev)
        s_dyn = torch.from_numpy(rng.uniform(0.005, 0.01, n).astype(np.float32)).to(dev)
        s_static = torch.tensor([1.0 / 127], device=dev)
        schemes = {"dynamic": (s_dyn, s_dyn, True),
                   "static": (s_static, torch.tensor([127.0], device=dev), False)}
        ho, wo = -(-h // stride), -(-w // stride)
        kk = k * k * cin
        conv = SameConv2d(cin, cout, k, stride).to(dev, torch.bfloat16).to(
            memory_format=torch.channels_last)
        x16 = x.bfloat16()
        with torch.inference_mode():
            cudnn_ms = median_ms(lambda: conv(x16), flush)
        del x16
        for scheme, (sx, qs, divide) in schemes.items():
            kw = dict(stride=stride, divide=divide, out_dtype=torch.bfloat16)
            got = k8.int8_conv(x, q_w, packed, s_k, bias, sx, qs, **kw)
            want = k8.int8_conv_plain(x, q_w, s_k, bias, sx, qs, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(f"int8_conv {label} B={b} {scheme} differs from its plain "
                                     f"version: max |err| {err}, bit-equal "
                                     f"{(got == want).float().mean().item()}")
            del got, want
            rows.append(dict(
                name=k8.NAME, shape=label, scheme=scheme, convs=count, route="cuda",
                source="hobot_stereonet_tpu_torch/csrc/int8_conv.cu",
                replaces="hobot_stereonet_tpu/ops/quant.py:92 (XLA s8 conv, not Pallas)",
                batch=b, tolerance="exact", max_abs_err=err, x_dtype=str(x_dtype),
                ms=median_ms(lambda: k8.int8_conv(x, q_w, packed, s_k, bias, sx, qs, **kw),
                             flush),
                plain_ms=median_ms(lambda: k8.int8_conv_plain(x, q_w, s_k, bias, sx, qs, **kw),
                                   flush, iters=3, warmup=1),
                bound=bound(n * h * w * cin * x.element_size() + cout * kk + n * ho * wo * cout * 2,
                            2.0 * n * ho * wo * cout * kk, INT8_OPS),
                library_ms=None, cudnn_bf16_ms=cudnn_ms))
        del x, q_w, packed, conv
    torch.cuda.empty_cache()
    for r in rows:
        phase(f"kernel int8_conv {r['shape']} (x{r['convs']}) B={b} {r['scheme']}: exact; "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}, {100 * r['bound'][0] / r['ms']:.0f}% "
              f"of it); cuDNN bf16 conv of the shape {r['cudnn_bf16_ms']:.4f} ms, kernel / "
              f"cuDNN {r['ms'] / r['cudnn_bf16_ms']:.3f}; {card}")
    for scheme in ("dynamic", "static"):
        mine = [r for r in rows if r["scheme"] == scheme and "float32" not in r["shape"]]
        total = sum(r["ms"] * r["convs"] for r in mine)
        cudnn = sum(r["cudnn_bf16_ms"] * r["convs"] for r in mine)
        limit = sum(r["bound"][0] * r["convs"] for r in mine)
        slower = [r["shape"] for r in mine if r["ms"] > r["cudnn_bf16_ms"]]
        phase(f"kernel int8_conv, the 28 convs of a batch of {b} ({scheme}): {total:.4f} ms, "
              f"bound {limit:.4f} ms ({100 * limit / total:.0f}% of it), cuDNN bf16 {cudnn:.4f} "
              f"ms (kernel / cuDNN {total / cudnn:.3f}); shapes slower than cuDNN's bf16 conv: "
              f"{slower or 'none'}; {card}")
    return rows


def int8_host_time(dev, cfg, card) -> float:
    """Host time of one ``int8_conv`` call at batch 1 (the tower's 3x3 conv on
    both eyes): the wrapper's checks, the plan lookup, the tensor map's
    encoding and the launch, averaged over 200 calls between two syncs; and
    of its C entry alone (the tensor map and the launch), called with the
    same arguments."""
    import ctypes

    import torch

    from hobot_stereonet_tpu_torch.ops.kernels import build
    from hobot_stereonet_tpu_torch.ops.kernels import int8_conv as k8

    c, k = cfg.model.feature_channels, cfg.model.cost_resolution_divisor
    x = torch.zeros((2, H // k, W // k, c), dtype=torch.bfloat16, device=dev).permute(0, 3, 1, 2)
    q_w = torch.ones((c, c, 3, 3), dtype=torch.int8, device=dev)
    packed = k8.pack_weight(q_w)
    s_k = torch.full((c,), 1e-3, device=dev)
    bias = torch.zeros(c, device=dev)
    s = torch.full((2,), 0.01, device=dev)
    kw = dict(stride=1, divide=True, out_dtype=torch.bfloat16)
    for _ in range(10):
        out = k8.int8_conv(x, q_w, packed, s_k, bias, s, s, **kw)
    args = k8.plan(2, c, H // k, W // k, c, 3, 1, torch.bfloat16, torch.bfloat16).args()
    entry = (x.data_ptr(), packed.data_ptr(), s_k.data_ptr(), bias.data_ptr(), s.data_ptr(),
             s.data_ptr(), out.data_ptr(), ctypes.addressof(args), 1, 1, build.stream_handle(x))
    lib = build.library()
    calls = 200
    times = {}
    for name, call in (("wrapper", lambda: k8.int8_conv(x, q_w, packed, s_k, bias, s, s, **kw)),
                       ("C entry", lambda: build.check(k8.NAME, lib.hst_int8_conv(*entry)))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            call()
        times[name] = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
    phase(f"kernel int8_conv host time at batch 1 (tower 3x3 on both eyes): "
          f"{times['wrapper']:.2f} us a call over {calls} calls, of which its C entry alone "
          f"(tensor map, launch) {times['C entry']:.2f} us; {card}")
    return times["wrapper"]


def tf32_flags() -> tuple:
    import torch

    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def record_tf32(seen: dict, key):
    """A module hook that records the TF32 flags under ``key`` (once) and
    changes nothing (it returns None)."""
    def hook(*args):
        seen.setdefault(key, tf32_flags())
    return hook


@contextlib.contextmanager
def group_norm_shapes(model, counts: dict):
    """While open, count ``model``'s GroupNorm calls in ``counts`` by input
    shape and form: {(N, C, spatial, form): calls}, form "skip" (a residual
    block's fused call), "no skip" (fused, the conv bias and LeakyReLU
    alone) or "plain" (the unfused GroupNorm)."""
    from hobot_stereonet_tpu_torch.models.layers import GroupNorm

    def hook(mod, args, kwargs):
        x = args[0]
        if kwargs.get("skip") is not None:
            form = "skip"
        elif kwargs.get("conv_bias") is not None or kwargs.get("activate"):
            form = "no skip"
        else:
            form = "plain"
        key = (x.shape[0], x.shape[1], tuple(x.shape[2:]), form)
        counts[key] = counts.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(hook, with_kwargs=True) for m in model.modules()
             if isinstance(m, GroupNorm)]
    try:
        yield counts
    finally:
        for hk in hooks:
            hk.remove()


def px_stats(got, want) -> dict:
    """|got - want| in px: median, p99.99, max, and pixels over 1 px."""
    import numpy as np

    e = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return dict(median=float(np.median(e)), p9999=float(np.quantile(e, 0.9999)),
                max=float(e.max()), over_1px=int((e > 1.0).sum()), n=int(e.size))


def check_bf16(tag: str, st: dict) -> None:
    ok = (st["median"] <= BF16_MEDIAN_PX and st["over_1px"] <= BF16_OVER_1PX * st["n"]
          and st["max"] <= BF16_MAX_PX)
    if not ok:
        raise AssertionError(f"{tag}: {st} beyond median {BF16_MEDIAN_PX} px, "
                             f"{BF16_OVER_1PX:.2%} over 1 px, max {BF16_MAX_PX} px")


def on_path(names, fn):
    """Run ``fn`` with the launch counts reset just before and read just after;
    fail if a kernel in ``names`` was not launched.  Returns (fn's result, counts)."""
    from hobot_stereonet_tpu_torch.ops.kernels import build

    build.reset_launch_counts()
    out = fn()
    counts = dict(build.launch_counts)
    missing = [n for n in names if counts.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on this path: {missing}; {counts}")
    return out, counts


# Launches by route on the main paths, by kernel and path: {name: {path: {route: n}}}.
ROUTE_LAUNCHES: dict = {}


def check_routes(path: str, name: str, route: str, launches: int) -> dict:
    """Read the route counts of ``name`` since the last reset (the path just
    driven), record them under ``path`` and fail unless all ``launches`` took
    ``route``."""
    from hobot_stereonet_tpu_torch.ops.kernels import build

    got = {k.split("/", 1)[1]: n for k, n in build.route_counts.items()
           if k.split("/", 1)[0] == name}
    ROUTE_LAUNCHES.setdefault(name, {})[path] = got
    if launches <= 0 or got != {route: launches}:
        raise AssertionError(f"{path}: {name} launched {launches} times, by route {got}; "
                             f"expected all on the {route} route")
    phase(f"routes: {path}: {name} launched {launches} times, by route {got}")
    return got


def profile_summary(prof, top: int = 10) -> tuple:
    """From a ``torch.profiler`` run: (device-busy share of the traced
    window, total device time in ms, the ``top`` device kernels and copies
    with the most device time as (name, ms, calls))."""
    def on_device(e) -> bool:
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    events = [e for e in prof.events() if e.time_range.end > e.time_range.start]
    dev = sorted((e.time_range.start, e.time_range.end) for e in events if on_device(e))
    if not dev:
        return 0.0, 0.0, []
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in dev:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    kernels = sorted((a for a in prof.key_averages() if on_device(a)),
                     key=lambda a: a.device_time_total, reverse=True)
    total = sum(a.device_time_total for a in kernels) / 1e3
    return (busy / span if span > 0 else 0.0, total,
            [(a.key, a.device_time_total / 1e3, a.count) for a in kernels[:top]])


ELEMENTWISE = {"where": ("where",), "add": ("CUDAFunctor_add", "add_kernel"),
               "mul": ("MulFunctor", "mul_kernel"), "compare": ("Compare", "_ge_", "ge_kernel")}


def elementwise_calls(prof, what: str) -> dict:
    """Device launches in a profile of the elementwise ops that stood around
    each GroupNorm before the fusion (LeakyReLU's compare, multiply and
    ``where``, the bias and residual adds), and of the GroupNorm kernel;
    fails if a ``where`` (the LeakyReLU's) ran."""
    def on_device(e) -> bool:
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    counts = dict.fromkeys(list(ELEMENTWISE) + ["group_norm_scan_kernel"], 0)
    for a in prof.key_averages():
        if not on_device(a):
            continue
        for fam, keys in ELEMENTWISE.items():
            if any(k in a.key for k in keys):
                counts[fam] += a.count
        if "group_norm_scan_kernel" in a.key:
            counts["group_norm_scan_kernel"] += a.count
    phase(f"profile {what}: elementwise launches around the GroupNorms (fused into its "
          f"kernel): {counts}")
    if counts["where"]:
        raise AssertionError(f"{what}: {counts['where']} where launches: a LeakyReLU ran "
                             f"outside the GroupNorm kernel")
    return counts


def serve_frames(eng, feed) -> list:
    """Queue the frames, start the engine (one bucket of them), drain, stop;
    every result finite, one per frame."""
    import numpy as np

    from hobot_stereonet_tpu_torch.runtime.engine import Frame

    for i, f in enumerate(feed):
        eng.feed(Frame(time.monotonic(), f, H, 2 * W, index=i))
    eng.start(warmup=False)
    eng.drain(timeout=240.0)
    results = list(eng.results(timeout=1.0))
    eng.stop()
    if sorted(r.index for r in results) != list(range(len(feed))) or eng.metrics.nan_dropped:
        raise AssertionError(f"{len(results)} results for {len(feed)} frames, "
                             f"{eng.metrics.nan_dropped} flagged non-finite")
    for r in results:
        d = np.asarray(r.disparity)
        if d.shape != (H, W) or not np.isfinite(d).all():
            raise AssertionError(f"frame {r.index}: disparity {d.shape}, not finite")
    return results


def int8_and_rgb_phase(ctx: dict) -> dict:
    """Phase 10; returns the launches of each (kernel, mode or scheme) on its path."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.config import Config, PreprocessConfig
    from hobot_stereonet_tpu_torch.ops import quant
    from hobot_stereonet_tpu_torch.runtime.benchmark import measure_engine_fps
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine
    from hobot_stereonet_tpu_torch.runtime.evaluate import evaluate_dataset
    from hobot_stereonet_tpu_torch.utils.profiling import device_trace

    dev, cfg, yuv, trained, card = ctx["dev"], ctx["cfg"], ctx["yuv"], ctx["trained"], ctx["card"]
    ring, slots, ecfg = ctx["ring"], ctx["slots"], ctx["ecfg"]
    stored = reference.load_outputs(reference.INT8_OUTPUTS_NPZ)
    schemes = {"dynamic": dict(int8=True), "static": dict(static_quant=str(reference.CALIB_JSON))}
    lo, hi = (reference.HELDOUT_EPE_PX - reference.HELDOUT_EPE_CI95_PX,
              reference.HELDOUT_EPE_PX + reference.HELDOUT_EPE_CI95_PX)
    launches = {}

    # Held-out accuracy in each scheme, paired against JAX's int8 EPEs.
    for scheme, kw in schemes.items():
        t = time.monotonic()
        quant.amax_calls.clear()
        res, counts = on_path(INT8_PATH[1:], lambda: evaluate_dataset(
            None, trained, ctx["heldout"], ctx["eval_cfg"], device=dev, **kw))
        jax_epe = stored[f"{scheme}_heldout_epe"]
        delta = np.asarray(res.per_frame_epe) - jax_epe
        ci = 1.96 * delta.std(ddof=1) / np.sqrt(len(delta))
        phase(f"int8 accuracy, {scheme}: over {res.n_frames} held-out scenes EPE {res.epe:.4f} px "
              f"(must lie in [{lo:.4f}, {hi:.4f}]), D1 {res.d1_all:.4f}; paired per-scene EPE - "
              f"JAX int8 {scheme}: mean {delta.mean():+.5f} +- {ci:.5f} px (95 %; limit "
              f"|mean| {INT8_PAIRED_MEAN_PX}), max |.| {np.abs(delta).max():.4f} (JAX mean "
              f"{jax_epe.mean():.4f}, D1 {float(stored[f'{scheme}_heldout_d1']):.4f}); launches "
              f"{counts}, amax reductions {quant.amax_calls['cuda']} "
              f"({time.monotonic() - t:.1f} s)")
        if not (lo <= res.epe <= hi and abs(delta.mean()) <= INT8_PAIRED_MEAN_PX):
            raise AssertionError(f"int8 {scheme} held-out EPE {res.epe}, paired mean "
                                 f"{delta.mean()}")

    # A frame alone against the same frame in the batch of 32: int8 bit for bit.
    t = time.monotonic()
    int8_engines = {}
    for scheme, kw in schemes.items():
        e8 = StereoEngine(ecfg, params=trained, emit_confidence=True, **kw)
        with torch.inference_mode():
            whole = e8.pipeline(ring.data[slots])
            single = e8.pipeline(ring.data[slots[:1]])
        torch.cuda.synchronize()
        for name, a, b in (("disparity", whole[0], single[0]), ("confidence", whole[2], single[2])):
            if not torch.equal(a[:1], b):
                raise AssertionError(f"int8 {scheme}: frame 0 alone differs from frame 0 in the "
                                     f"batch of {len(slots)} ({name}, max |diff| "
                                     f"{(a[:1] - b).abs().max().item()})")
        int8_engines[scheme] = e8
    phase(f"int8 batch invariance: frame 0 alone equals frame 0 in the batch of {len(slots)}, "
          f"disparity and confidence bit for bit, in both schemes ({time.monotonic() - t:.1f} s)")

    # C1: the bf16 frame alone against in the batch, as shipped and under
    # deterministic cuDNN, with the batch-32 frames/s of each.
    shipped = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    for name, setting in (("as shipped", shipped), ("deterministic cuDNN", (True, False))):
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = setting
        t = time.monotonic()
        e16 = ctx["bf16_engine"]
        with torch.inference_mode():
            whole = e16.pipeline(ring.data[slots])[0]
            single = e16.pipeline(ring.data[slots[:1]])[0]
        torch.cuda.synchronize()
        st = px_stats(single[0].cpu().numpy(), whole[0].cpu().numpy())
        st["bit_equal"] = float((single[0] == whole[0]).float().mean())
        fps = measure_engine_fps(params=trained, model_cfg=cfg.model, preprocess_cfg=yuv,
                                 batch=32, n_batches=4, ring_size=2, height=H, width=W)["fps"]
        phase(f"C1 bf16 {name} (cudnn.deterministic={setting[0]}, benchmark={setting[1]}): "
              f"frame 0 alone vs in the batch of {len(slots)}: {st}; measure_engine_fps batch "
              f"32: {fps} frames/s; {card} ({time.monotonic() - t:.1f} s)")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = shipped

    # StereoEngine(Config()) serves RGB; the int8 engines serve the flagship's
    # YUV (dynamic) and RGB with the quantized input (static).
    feed = ctx["rng"].integers(0, 256, (N_FRAMES, 3 * H * W), dtype=np.uint8)
    rgbq = dataclasses.replace(Config(), preprocess=PreprocessConfig(quantize=True))
    runs = (("Config() bf16 RGB", Config(), {}, ("nv12_ingest", "rgb")),
            ("flagship int8 dynamic YUV", cfg, schemes["dynamic"], ("int8_conv", "dynamic")),
            ("Config() int8 static RGB + quantize", rgbq, schemes["static"],
             ("int8_conv", "static")))
    for label, ecfg_i, kw, key in runs:
        t = time.monotonic()
        eng = StereoEngine(ecfg_i, params=trained, **kw)
        eng.warmup(buckets=[N_FRAMES])
        quant.amax_calls.clear()
        want = INT8_PATH if kw else BF16_PATH
        _, counts = on_path(want, lambda: serve_frames(eng, feed))
        amax = quant.amax_calls["cuda"]
        expect_amax = 28 if kw.get("int8") else 0
        if kw and (counts["int8_conv"] != 28 or amax != expect_amax):
            raise AssertionError(f"{label}: {counts['int8_conv']} int8 conv launches, {amax} "
                                 f"amax reductions for one batch; expected 28 and {expect_amax}")
        launches[key] = counts[key[0]]
        if label.endswith("quantize"):
            launches[("nv12_ingest", "rgb+quantize")] = counts["nv12_ingest"]
        phase(f"engine {label}: {N_FRAMES} frames of {W}x{H} served in one batch, finite; "
              f"launches {counts}, amax reductions {amax} ({time.monotonic() - t:.1f} s)")
        del eng

    # The benchmark surface in int8.
    for scheme, kw in schemes.items():
        for stage_timing in (False, True):
            for b, nb in BENCH_BATCHES.items():
                t = time.monotonic()
                out, counts = on_path(INT8_PATH, lambda: measure_engine_fps(
                    params=trained, model_cfg=cfg.model, preprocess_cfg=yuv, batch=b,
                    n_batches=nb, stage_timing=stage_timing, ring_size=2, height=H, width=W,
                    **kw))
                phase(f"bench int8 {scheme}: measure_engine_fps batch {b}, stage_timing="
                      f"{stage_timing}: {out}; launches {counts}; {card} "
                      f"({time.monotonic() - t:.1f} s)")

    # One ring-fed int8 batch of 32 under the profiler, after one unprofiled.
    for scheme, e8 in int8_engines.items():
        e8.warmup(buckets=[N_FRAMES], ring=ring)
        with device_trace(str(ctx["log"] / f"int8_{scheme}_batch{N_FRAMES}")) as prof:
            _, event = e8._launch((ring, slots))
            e8._wait(event)
        busy, total, top = profile_summary(prof)
        if top:
            elementwise_calls(prof, f"int8 {scheme} batch {N_FRAMES}")
        phase(f"profile int8 {scheme}: one ring-fed batch of {N_FRAMES} at {W}x{H}: device busy "
              f"{100 * busy:.1f} % of the traced window, {total:.3f} ms of device time; the "
              f"largest kernels and copies: {card}")
        for name, ms, calls in top:
            phase(f"profile:   {ms:9.3f} ms  {calls:5d} calls  {name[:110]}")
    return launches


def classic_kernel_row(b, rng, flush, dev, h, w, d, scale, card) -> dict:
    """The D-leading soft-argmin against its plain version at batch ``b`` on
    the CLASSIC path's cost [b, D, h, w] bf16 (and against the scalar route,
    bit for bit); its route, time and bound."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch.ops.kernels import build
    from hobot_stereonet_tpu_torch.ops.kernels import correlation as kc

    cost = torch.from_numpy(3.0 * rng.standard_normal((b, d, h, w), np.float32)
                            ).bfloat16().to(dev)
    plan = kc.soft_argmin_cost_plan(b, d, h * w, cost.data_ptr(), cost.element_size())
    build.route_counts.clear()
    got_d, got_c = kc.soft_argmin_cost(cost, scale)
    routes = dict(build.route_counts)
    want_d, want_c = kc.soft_argmin_cost_plain(cost, scale)
    scalar = kc._soft_argmin_cost_launch(cost, scale, "scalar")
    torch.cuda.synchronize()
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_c, want_c, rtol=1e-5, atol=1e-6)
    if routes != {f"{kc.SOFT_ARGMIN_COST}/vector": 1} or not (
            torch.equal(got_d, scalar[0]) and torch.equal(got_c, scalar[1])):
        raise AssertionError(f"{kc.SOFT_ARGMIN_COST} [{b}, {d}, {h}, {w}]: routes {routes} "
                             f"(plan {plan}); the vector route must equal the scalar one")
    err = max((got_d - want_d).abs().max().item(), (got_c - want_c).abs().max().item())
    row = dict(
        name=kc.SOFT_ARGMIN_COST, route="cuda", source="hobot_stereonet_tpu_torch/csrc/soft_argmin.cu",
        replaces="hobot_stereonet_tpu/ops/pallas/correlation.py:124", batch=b, shape=f"{h}x{w}",
        plan=dict(route=plan.route, pixels=plan.pixels, threads=plan.threads,
                  grid=list(plan.grid)),
        tolerance="f32 rounding (rtol 1e-5, atol 1e-4 px / 1e-6)", max_abs_err=err,
        ms=median_ms(lambda: kc.soft_argmin_cost(cost, scale), flush),
        ms_read_flush=median_ms(lambda: kc.soft_argmin_cost(cost, scale), flush, read_flush=True),
        plain_ms=median_ms(lambda: kc.soft_argmin_cost_plain(cost, scale), flush),
        bound=bound(b * d * h * w * 2 + 2 * b * h * w * 4, 5.0 * b * h * w * d),
        library_ms=None)
    phase(f"kernel {row['name']} B={b} (cost [{b},{d},{h},{w}] bf16): {plan.route} route, "
          f"{plan.pixels} pixels a thread, {plan.threads} threads a block, grid {plan.grid}, "
          f"bit-equal to the scalar route; max |err| {err:.3g} "
          f"({row['tolerance']}), kernel {row['ms']:.4f} ms ({row['ms_read_flush']:.4f} ms after "
          f"a read flush), plain {row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
          f"({row['bound'][1]}, {100 * row['bound'][0] / row['ms']:.0f}% of it); {card}")
    return row


def classic_phase(ctx: dict) -> tuple:
    """Phase 11, the CLASSIC StereoNet; returns (kernel rows, launches of
    the D-leading soft-argmin on the engine's path)."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.config import Config, StereoNetConfig
    from hobot_stereonet_tpu_torch.data.stream import DeviceFrameRing
    from hobot_stereonet_tpu_torch.models import StereoNet
    from hobot_stereonet_tpu_torch.models.layers import cast_convs
    from hobot_stereonet_tpu_torch.ops import preprocess as pp
    from hobot_stereonet_tpu_torch.ops.kernels import build
    from hobot_stereonet_tpu_torch.runtime.benchmark import measure_engine_fps
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine
    from hobot_stereonet_tpu_torch.runtime.evaluate import evaluate_dataset
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params
    from hobot_stereonet_tpu_torch.utils.profiling import device_trace

    dev, card, rng, heldout = ctx["dev"], ctx["card"], ctx["rng"], ctx["heldout"]
    t = time.monotonic()
    mcfg = StereoNetConfig()
    k = mcfg.cost_resolution_divisor
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = [classic_kernel_row(b, rng, flush, dev, H // k, W // k, mcfg.num_disparities_coarse,
                               float(k), card) for b in BATCHES]
    # The training shape: a batch of 8 crops of 128x256, cost at 1/8.
    rows.append(classic_kernel_row(TRAIN_BATCH, rng, flush, dev, TRAIN_CROP[0] // k,
                                   TRAIN_CROP[1] // k, mcfg.num_disparities_coarse, float(k),
                                   card))
    del flush

    # The trained weights against the stored JAX outputs (RGB input).
    params = reference.load_params(reference.CLASSIC_PARAMS_NPZ)
    stored = reference.load_outputs(reference.CLASSIC_OUTPUTS_NPZ)
    rgb = Config().preprocess
    scenes = [heldout[i] for i in reference.SCENES]

    def net(dtype, device):
        c = dataclasses.replace(mcfg, compute_dtype=dtype)
        m = StereoNet(c, device=device)
        m.load_state_dict(from_flax_params(params, c, "classic"))
        return cast_convs(m, dtype).eval()

    def run_scenes(m, device):
        x = torch.cat([pp.rgb_pair_to_model_input(s.left, s.right, rgb, device) for s in scenes])
        with torch.inference_mode():
            o = m(*pp.split_model_input(x))
        return o["disparity"].cpu().numpy(), o["confidence"].cpu().numpy()

    build.reset_launch_counts()
    d32, c32 = run_scenes(net(torch.float32, dev), dev)
    if build.launch_counts["soft_argmin_cost"] != 1:
        raise AssertionError(f"CLASSIC on the card: launches {dict(build.launch_counts)}")
    dcpu, ccpu = run_scenes(net(torch.float32, "cpu"), "cpu")
    card_cpu = (float(np.abs(d32 - dcpu).max()), float(np.abs(c32 - ccpu).max()))
    jax32 = px_stats(d32, stored["f32_disparity"])
    jax32_conf = float(np.abs(c32 - stored["f32_confidence"]).max())
    phase(f"classic: float32 on the card vs the port on the CPU, 2 held-out scenes at 256x512: "
          f"disparity max |err| {card_cpu[0]:.3g} px (limit 1e-3), confidence {card_cpu[1]:.3g} "
          f"(limit 1e-4); vs JAX float32: {jax32} (limits median 1e-4, max 3e-3 px, fault C5), "
          f"confidence {jax32_conf:.3g} (limit 1e-4)")
    if not (card_cpu[0] <= 1e-3 and card_cpu[1] <= 1e-4 and jax32["median"] <= 1e-4
            and jax32["max"] <= 3e-3 and jax32_conf <= 1e-4):
        raise AssertionError("CLASSIC float32 on the card disagrees")

    net16 = net(torch.bfloat16, dev)
    d16, c16 = run_scenes(net16, dev)
    st = px_stats(d16, stored["bf16_disparity"])
    conf16 = float(np.abs(c16 - stored["bf16_confidence"]).max())
    check_bf16("classic trained bf16 scenes", st)
    frame = torch.from_numpy(reference.frame_720p())[None].to(dev)
    with torch.inference_mode():
        x = pp.nv12_ingest(frame, H, 2 * W, rgb)
        d720 = net16(*pp.split_model_input(x))["disparity"][0].cpu().numpy()
    st720 = px_stats(d720, stored["bf16_720p_disparity"])
    check_bf16("classic trained bf16 720p", st720)
    phase(f"classic: bf16 on the card vs JAX, 2 scenes: {st}, confidence max |err| {conf16:.3g} "
          f"(limit 0.03); the 720p frame: {st720} ({time.monotonic() - t:.1f} s)")
    if conf16 > 0.03:
        raise AssertionError(f"CLASSIC bf16 confidence {conf16}")

    # Held-out accuracy in bf16, paired against the stored JAX EPEs.
    t = time.monotonic()
    res, counts = on_path(CLASSIC_PATH[1:], lambda: evaluate_dataset(
        "classic", params, heldout, Config(), device=dev))
    jax_epe = stored["heldout_epe"]
    delta = np.asarray(res.per_frame_epe) - jax_epe
    ci = 1.96 * delta.std(ddof=1) / np.sqrt(len(delta))
    lo, hi = (reference.CLASSIC_HELDOUT_EPE_PX - reference.CLASSIC_HELDOUT_EPE_CI95_PX,
              reference.CLASSIC_HELDOUT_EPE_PX + reference.CLASSIC_HELDOUT_EPE_CI95_PX)
    phase(f"classic accuracy: bf16 on the card over {res.n_frames} held-out scenes: EPE "
          f"{res.epe:.4f} px (must lie in [{lo:.4f}, {hi:.4f}]), D1 {res.d1_all:.4f}; paired "
          f"per-scene EPE - JAX's: mean {delta.mean():+.5f} +- {ci:.5f} px (95 %), max |.| "
          f"{np.abs(delta).max():.4f} (JAX mean {jax_epe.mean():.4f}, D1 "
          f"{float(stored['heldout_d1']):.4f}); launches {counts} ({time.monotonic() - t:.1f} s)")
    if not lo <= res.epe <= hi:
        raise AssertionError(f"CLASSIC held-out EPE {res.epe} outside [{lo}, {hi}]")
    check_routes("classic held-out bf16", "soft_argmin_cost", "vector",
                 counts["soft_argmin_cost"])

    # The engine: 32 frames at 720p, microbatch 8, streamed == synchronous;
    # the microbatched pipeline against the whole batch on rendered scenes.
    t = time.monotonic()
    ccfg = dataclasses.replace(Config(), engine=dataclasses.replace(
        Config().engine, device_microbatch=8))
    eng = StereoEngine(ccfg, params=params, emit_confidence=True, model="classic")
    eng.warmup(buckets=[N_FRAMES])
    feed = rng.integers(0, 256, (N_FRAMES, 3 * H * W), dtype=np.uint8)
    with group_norm_shapes(eng.model, ctx["gn_shapes"]):
        results, launches = on_path(CLASSIC_PATH, lambda: serve_frames(eng, feed))
    if eng.metrics.dispatch_batch.n != 1 or launches["soft_argmin_cost"] != N_FRAMES // 8:
        raise AssertionError(f"classic engine: {eng.metrics.dispatch_batch.summary()}, "
                             f"launches {launches}")
    check_routes("classic engine", "soft_argmin_cost", "vector", launches["soft_argmin_cost"])
    with torch.inference_mode():
        sync = [o.cpu().numpy() for o in eng.pipeline(torch.from_numpy(feed).to(dev))[:3]]
    for r in results:
        for name, got, want in zip(("disparity", "depth_m", "confidence"),
                                   (r.disparity, r.depth_m, r.confidence), sync):
            if not np.array_equal(got, want[r.index]):
                raise AssertionError(f"classic frame {r.index}: streamed {name} differs from "
                                     "the synchronous pipeline")
    ring = DeviceFrameRing(height=H, width=W, ring_size=4, seed=1, device=dev)
    slots = [i % ring.data.shape[0] for i in range(N_FRAMES)]
    with torch.inference_mode():
        chunked = eng.pipeline(ring.data[slots])[0].cpu().numpy()
        whole = StereoEngine(Config(), params=params, model="classic").pipeline(
            ring.data[slots])[0].cpu().numpy()
    micro = px_stats(chunked, whole)
    micro["bit_equal"] = float(np.mean(chunked == whole))
    check_bf16("classic device_microbatch=8 vs the whole batch", micro)
    phase(f"classic engine: {N_FRAMES} frames of {W}x{H} (RGB, bf16, device_microbatch=8) in "
          f"one dispatch, finite, streamed == synchronous bit for bit; launches {launches}; "
          f"microbatch 8 vs the whole batch of {N_FRAMES} (4 rendered scenes): {micro} "
          f"({time.monotonic() - t:.1f} s)")
    del eng, results, sync, chunked, whole

    # The benchmark surface, with the caching allocator's retries (a retry
    # frees cached blocks and synchronizes) and peak memory of each run;
    # batch 32 also with one batch in flight.
    runs = [(st, b, nb, 4) for st in (False, True) for b, nb in BENCH_BATCHES.items()]
    for stage_timing, b, nb, inflight in runs + [(False, N_FRAMES, BENCH_BATCHES[N_FRAMES], 1)]:
        t = time.monotonic()
        retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
        torch.cuda.reset_peak_memory_stats(dev)
        out, counts = on_path(CLASSIC_PATH, lambda: measure_engine_fps(
            model="classic", params=params, model_cfg=mcfg, preprocess_cfg=rgb, batch=b,
            n_batches=nb, stage_timing=stage_timing, device_microbatch=8, inflight=inflight,
            ring_size=2, height=H, width=W))
        retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) - retries
        phase(f"bench classic: measure_engine_fps batch {b}, stage_timing={stage_timing}, "
              f"inflight={inflight}: {out}; launches {counts}; allocator retries {retries}, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; {card} "
              f"({time.monotonic() - t:.1f} s)")

    # One ring-fed batch of 32 under the profiler, after one unprofiled.
    pcfg = dataclasses.replace(ccfg, engine=dataclasses.replace(ccfg.engine, fetch_results=False))
    eng = StereoEngine(pcfg, params=params, model="classic")
    eng.warmup(buckets=[1, N_FRAMES], ring=ring)
    for b in (1, N_FRAMES):
        with device_trace(str(ctx["log"] / f"classic_batch{b}")) as prof:
            _, event = eng._launch((ring, slots[:b]))
            eng._wait(event)
        busy, total, top = profile_summary(prof, top=16 if b > 1 else 6)
        if top:
            elementwise_calls(prof, f"classic batch {b}")
        phase(f"profile classic: one ring-fed batch of {b} at {W}x{H}, microbatch 8: device "
              f"busy {100 * busy:.1f} % of the traced window, {total:.3f} ms of device time; the "
              f"largest kernels and copies: {card}")
        for name, ms, calls in top:
            phase(f"profile:   {ms:9.3f} ms  {calls:5d} calls  {name[:110]}")
    conv_probe(dev, eng.model, card)
    return rows, launches


def int8_conv_key(mod, x) -> tuple:
    """An int8 conv call's shape: (route, input shape, weight shape, stride,
    dilation)."""
    return (mod.route, tuple(x.shape), tuple(mod.q_weight.shape), mod.stride, mod.dilation)


@contextlib.contextmanager
def int8_conv_calls(model, counts: dict):
    """While open, count ``model``'s int8 conv calls in ``counts`` by
    :func:`int8_conv_key`."""
    from hobot_stereonet_tpu_torch.ops.quant import Int8Conv

    def hook(mod, args):
        key = int8_conv_key(mod, args[0])
        counts[key] = counts.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, Int8Conv)]
    try:
        yield counts
    finally:
        for hk in hooks:
            hk.remove()


def classic_int8_convs(net, dev) -> list:
    """Every int8 conv of a quantized CLASSIC (``net`` on the card) with the
    input it gets at a chunk of 8 frames at 720p, one per distinct
    :func:`int8_conv_key`: [(label, module, input, count, key)]."""
    import torch

    from hobot_stereonet_tpu_torch.ops.quant import Int8Conv

    seen: dict = {}

    def hook(name):
        def rec(mod, args):
            x = args[0]
            key = int8_conv_key(mod, x)
            if key in seen:
                seen[key][3] += 1
            else:
                seen[key] = [name, mod, x.clone(memory_format=torch.preserve_format), 1, key]
        return rec

    hooks = [m.register_forward_pre_hook(hook(n)) for n, m in net.named_modules()
             if isinstance(m, Int8Conv)]
    frames = torch.rand((8, H, W, 3), device=dev) * 2 - 1
    try:
        with torch.inference_mode():
            net(frames, torch.roll(frames, -3, 2))
    finally:
        for hk in hooks:
            hk.remove()
    return list(seen.values())


def classic_int8_conv_rows(net, dev, flush, card) -> tuple:
    """Each CLASSIC int8 conv shape at a chunk of 8 at 720p, through the
    int8 kernel (``Int8Conv.on_card``), against the plain version bit for
    bit in both schemes (the static one with the module's calibrated
    scale, the dynamic one with the input's per-sample scales); the static
    call timed beside its int8 bound, the plain version and cuDNN's bf16
    conv of the same shape.  At each 3-D and dilated shape (the library
    route's until the kernel took them) also the library route, the
    yardstick: im2col, ``torch._int_mm`` and the epilogue kernel
    (``int8_epilogue``), exact against the plain version and timed as
    ``library_ms``; and the epilogue kernel alone on the route's static
    product, against its plain version with the calibrated scale and with
    per-sample ones, timed beside its byte bound.  Returns (kernel rows,
    epilogue rows), each conv row keyed by :func:`int8_conv_key`."""
    import torch
    import torch.nn.functional as F

    from hobot_stereonet_tpu_torch.ops import int8_gemm, quant
    from hobot_stereonet_tpu_torch.ops.kernels import int8_conv as k8

    kernel_rows, epilogue_rows = [], []
    for name, mod, x, count, key in classic_int8_convs(net, dev):
        if mod.route != "kernel":
            raise AssertionError(f"classic int8 {name}: routed to {mod.route}")
        q_w, s_k, b = mod.q_weight, mod.weight_scale, mod.bias
        kw = dict(stride=mod.stride, divide=False, out_dtype=torch.bfloat16)
        s_dyn = quant.activation_scale(x)
        former = mod.dilation > 1 or x.dim() == 5       # the library route's before
        w_gemm = int8_gemm.gemm_weight(q_w)

        def call(sx, qs, divide):
            return mod.on_card(x, sx, qs, divide=divide)

        def library(sx, qs, divide):
            return int8_gemm.int8_conv_im2col(x, q_w, w_gemm, s_k, b, sx, qs,
                                              dilation=mod.dilation, **dict(kw, divide=divide))

        err = 0.0
        for sx, qs, divide in ((mod.act_scale, mod.act_mult, False), (s_dyn, s_dyn, True)):
            want = k8.int8_conv_plain(x, q_w, s_k, b, sx, qs, dilation=mod.dilation,
                                      **dict(kw, divide=divide))
            for route, fn in (("kernel", call), ("library", library))[:2 if former else 1]:
                got = fn(sx, qs, divide)
                torch.cuda.synchronize()
                err = max(err, (got.float() - want.float()).abs().max().item())
                if not torch.equal(got, want):
                    raise AssertionError(f"classic int8 {name} ({route}) {tuple(x.shape)} "
                                         f"divide={divide} differs from the plain version: max "
                                         f"|err| {err}")
                del got
            del want
        out_shape = tuple(call(mod.act_scale, mod.act_mult, False).shape)
        ms = median_ms(lambda: call(mod.act_scale, mod.act_mult, False), flush, iters=10)
        library_ms = median_ms(lambda: library(mod.act_scale, mod.act_mult, False), flush,
                               iters=10) if former else None
        plain_ms = median_ms(lambda: k8.int8_conv_plain(
            x, q_w, s_k, b, mod.act_scale, mod.act_mult, dilation=mod.dilation, **kw), flush,
            iters=1, warmup=1)
        wt = q_w.to(torch.bfloat16).contiguous(memory_format=k8.memory_format(q_w.dim()))
        pads = [k8.same_pads(s, k, mod.stride, mod.dilation)
                for s, k in zip(x.shape[2:], q_w.shape[2:])]
        conv = F.conv3d if x.dim() == 5 else F.conv2d
        x16 = F.pad(x.bfloat16(), [p for lo_hi in reversed(pads) for p in lo_hi])
        cudnn_ms = median_ms(lambda: conv(x16, wt, None, mod.stride, 0, mod.dilation), flush,
                             iters=10)
        k_red = q_w[0].numel()
        n_out = torch.Size(out_shape).numel()
        padded = mod.channels != tuple(q_w.shape[1::-1])
        note = f" (padded to {mod.channels[0]} -> {mod.channels[1]})" if padded else ""
        plan = k8.plan(x.shape[0], mod.channels[0], *x.shape[-2:], mod.channels[1],
                       q_w.shape[-1], mod.stride, x.dtype, torch.bfloat16, mod.dilation,
                       x.shape[2] if x.dim() == 5 else 0)
        row = dict(shape=f"{name} {list(x.shape)} -> {mod.q_weight.shape[0]}"
                         f"{f' dilation {mod.dilation}' if mod.dilation > 1 else ''}{note}",
                   convs=count, batch=8, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   tolerance="exact", cudnn_bf16_ms=cudnn_ms, library_ms=library_ms,
                   launch_key=key, former_library=former, tile_rows=plan.th,
                   bound=bound(x.numel() * x.element_size() + q_w.numel() + 2 * n_out,
                               2.0 * n_out * k_red, INT8_OPS))
        kernel_rows.append(row)
        lib = (f", the library route (yardstick) {library_ms:.4f} ms, kernel / library "
               f"{ms / library_ms:.3f}" if former else "")
        phase(f"classic int8 conv (kernel, {plan.th}-row tiles) {row['shape']} (x{count}): exact "
              f"in both schemes; {ms:.4f} ms, bound {row['bound'][0]:.4f} ms "
              f"({row['bound'][1]}, {100 * row['bound'][0] / ms:.0f}% of it), plain "
              f"{plain_ms:.1f} ms, cuDNN bf16 conv of the shape {cudnn_ms:.4f} ms{lib}; {card}")
        del x16, wt
        if former:
            epilogue_rows.append(epilogue_row(row, mod, x, w_gemm, s_dyn, flush, card))
        del x, w_gemm
    torch.cuda.empty_cache()
    for label, rows in (("all", kernel_rows),
                        ("3-D and dilated", [r for r in kernel_rows if r["former_library"]])):
        total = sum(r["ms"] * r["convs"] for r in rows)
        limit = sum(r["bound"][0] * r["convs"] for r in rows)
        cudnn = sum(r["cudnn_bf16_ms"] * r["convs"] for r in rows)
        lib = sum((r["library_ms"] or 0.0) * r["convs"] for r in rows)
        phase(f"classic int8 convs through the kernel, {label}: {sum(r['convs'] for r in rows)} "
              f"convs, {len(rows)} shapes; a chunk of 8: {total:.3f} ms (bound {limit:.3f} ms, "
              f"{100 * limit / total:.0f}% of it; cuDNN bf16 {cudnn:.3f} ms"
              f"{f'; the library route {lib:.3f} ms' if lib else ''}); {card}")
    return kernel_rows, epilogue_rows


def epilogue_row(conv_row: dict, mod, x, w_gemm, s_dyn, flush, card) -> dict:
    """The library route's epilogue kernel (on no serving path: the
    yardstick's) at one conv shape: on the route's int32 product in the
    static scheme, bit for bit against its
    plain version (``epilogue``, float64 with TwoSum) with the calibrated
    scale and with the per-sample ones ``s_dyn``; timed beside its byte
    bound (the int32 values read once, the bf16 outputs written once)."""
    import torch

    from hobot_stereonet_tpu_torch.ops import int8_gemm
    from hobot_stereonet_tpu_torch.ops.kernels import int8_conv as k8

    acc, m, _ = int8_gemm.int8_product(x, mod.q_weight, w_gemm, mod.act_mult,
                                       stride=mod.stride, dilation=mod.dilation, divide=False)
    cout, per = mod.q_weight.shape[0], m // x.shape[0]
    s_k, b = mod.weight_scale, mod.bias

    def kernel(sx):
        return k8.int8_epilogue(acc, m, cout, per, sx, s_k, b, torch.bfloat16)

    def plain(sx):
        return k8.epilogue(acc[:m, :cout].float().view(-1, per, cout), sx, s_k, b, 2,
                           torch.bfloat16).view(m, cout)

    for sx in (mod.act_scale, s_dyn):
        got, want = kernel(sx), plain(sx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"int8_epilogue {conv_row['shape']}: differs from its plain "
                                 f"version by {(got.float() - want.float()).abs().max().item()}")
        del got, want
    ms = median_ms(lambda: kernel(mod.act_scale), flush, iters=10)
    plain_ms = median_ms(lambda: plain(mod.act_scale), flush, iters=1, warmup=1)
    row = dict(shape=f"{conv_row['shape']}: [{m}, {acc.shape[1]}] int32 -> [{m}, {cout}] bf16",
               convs=conv_row["convs"], batch=8, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               tolerance="exact", library_ms=None,
               bound=bound(m * cout * (4.0 + 2.0), 3.0 * m * cout))
    phase(f"kernel int8_epilogue [{row['shape']}] (x{row['convs']}): exact with the calibrated "
          f"and per-sample scales; {ms:.4f} ms, bound {row['bound'][0]:.4f} ms "
          f"({row['bound'][1]}, {100 * row['bound'][0] / ms:.0f}% of it), plain {plain_ms:.2f} "
          f"ms; {card}")
    return row


def check_int8_spread(tag: str, st: dict) -> None:
    ok = (st["median"] <= CLASSIC_INT8_MEDIAN_PX and st["over_1px"] <= CLASSIC_INT8_OVER_1PX
          * st["n"] and st["max"] <= CLASSIC_INT8_MAX_PX)
    if not ok:
        raise AssertionError(f"{tag}: {st} beyond median {CLASSIC_INT8_MEDIAN_PX} px, "
                             f"{CLASSIC_INT8_OVER_1PX:.1%} over 1 px, max "
                             f"{CLASSIC_INT8_MAX_PX} px")


def classic_int8_phase(ctx: dict) -> tuple:
    """Phase 11b, CLASSIC in int8; returns (int8 kernel rows, epilogue kernel
    rows, {(kernel, scheme): launches on the int8 engines' paths}, the
    library route's calls on them by scheme (none), and their int8 conv
    calls by scheme and :func:`int8_conv_key`)."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.config import Config, StereoNetConfig
    from hobot_stereonet_tpu_torch.models import StereoNet
    from hobot_stereonet_tpu_torch.ops import int8_gemm, quant
    from hobot_stereonet_tpu_torch.ops import preprocess as pp
    from hobot_stereonet_tpu_torch.runtime.benchmark import measure_engine_fps
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine
    from hobot_stereonet_tpu_torch.runtime.evaluate import evaluate_dataset
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params

    dev, card, rng, heldout = ctx["dev"], ctx["card"], ctx["rng"], ctx["heldout"]
    params = reference.load_params(reference.CLASSIC_PARAMS_NPZ)
    stored = reference.load_outputs(reference.CLASSIC_INT8_OUTPUTS_NPZ)
    calib = str(reference.CLASSIC_CALIB_JSON)
    schemes = {"dynamic": dict(int8=True), "static": dict(static_quant=calib)}
    mcfg = StereoNetConfig()
    rgb = Config().preprocess

    def net(**kw):
        m = StereoNet(mcfg, device=dev)
        m.load_state_dict(from_flax_params(params, mcfg, "classic"))
        return quant.serving_model(m, **kw)

    # The routes, and each conv shape through the kernel against the plain version.
    t = time.monotonic()
    static_net = net(**schemes["static"])
    routes = quant.routes(static_net)
    by_route = {r: sorted(k for k, v in routes.items() if v == r) for r in ("kernel", "library")}
    phase(f"classic int8: {len(routes)} convs, {len(by_route['kernel'])} through the int8 kernel "
          f"and {len(by_route['library'])} through the library route (im2col + torch._int_mm)")
    if (len(by_route["kernel"]), len(by_route["library"])) != CLASSIC_INT8_ROUTES:
        raise AssertionError(f"classic int8 routes: {by_route}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kernel_rows, epilogue_rows = classic_int8_conv_rows(static_net, dev, flush, card)
    del flush, static_net
    phase(f"classic int8: conv shapes checked and timed ({time.monotonic() - t:.1f} s)")

    # The two stored scenes and the 720p frame against JAX's int8 outputs.
    t = time.monotonic()
    scenes = [heldout[i] for i in reference.SCENES]
    x = torch.cat([pp.rgb_pair_to_model_input(s.left, s.right, rgb, dev) for s in scenes])
    frame = torch.from_numpy(reference.frame_720p())[None].to(dev)
    for scheme, kw in schemes.items():
        m = net(**kw)
        with torch.inference_mode():
            d = m(*pp.split_model_input(x))["disparity"].cpu().numpy()
            d720 = m(*pp.split_model_input(pp.nv12_ingest(frame, H, 2 * W, rgb)))[
                "disparity"][0].cpu().numpy()
        st, st720 = px_stats(d, stored[f"{scheme}_disparity"]), px_stats(
            d720, stored[f"{scheme}_720p_disparity"])
        check_int8_spread(f"classic int8 {scheme} scenes", st)
        check_int8_spread(f"classic int8 {scheme} 720p", st720)
        phase(f"classic int8 {scheme}: on the card vs JAX int8, 2 scenes: {st}; the 720p frame: "
              f"{st720}")
        del m
    phase(f"classic int8: stored outputs checked ({time.monotonic() - t:.1f} s)")

    # Held-out accuracy in each scheme, paired against JAX's int8 EPEs.
    lo, hi = (reference.CLASSIC_HELDOUT_EPE_PX - reference.CLASSIC_HELDOUT_EPE_CI95_PX,
              reference.CLASSIC_HELDOUT_EPE_PX + reference.CLASSIC_HELDOUT_EPE_CI95_PX)
    for scheme, kw in schemes.items():
        t = time.monotonic()
        int8_gemm.calls.clear()
        res, counts = on_path(CLASSIC_INT8_PATH[1:], lambda: evaluate_dataset(
            "classic", params, heldout, Config(), device=dev, **kw))
        jax_epe = stored[f"{scheme}_heldout_epe"]
        delta = np.asarray(res.per_frame_epe) - jax_epe
        ci = 1.96 * delta.std(ddof=1) / np.sqrt(len(delta))
        phase(f"classic int8 accuracy, {scheme}: over {res.n_frames} held-out scenes EPE "
              f"{res.epe:.4f} px (must lie in [{lo:.4f}, {hi:.4f}]), D1 {res.d1_all:.4f}; paired "
              f"per-scene EPE - JAX int8 {scheme}: mean {delta.mean():+.5f} +- {ci:.5f} px (95 %; "
              f"limit |mean| {INT8_PAIRED_MEAN_PX}), max |.| {np.abs(delta).max():.4f} (JAX "
              f"mean {jax_epe.mean():.4f}, D1 {float(stored[f'{scheme}_heldout_d1']):.4f}); "
              f"launches {counts}, library calls {int8_gemm.calls['cuda']} "
              f"({time.monotonic() - t:.1f} s)")
        if not (lo <= res.epe <= hi and abs(delta.mean()) <= INT8_PAIRED_MEAN_PX):
            raise AssertionError(f"classic int8 {scheme} held-out EPE {res.epe}, paired mean "
                                 f"{delta.mean()}")

    # The engines: 32 frames at 720p, microbatch 8, streamed == synchronous.
    ccfg = dataclasses.replace(Config(), engine=dataclasses.replace(
        Config().engine, device_microbatch=8))
    feed = rng.integers(0, 256, (N_FRAMES, 3 * H * W), dtype=np.uint8)
    launches, library_calls, conv_calls = {}, {}, {}
    for scheme, kw in schemes.items():
        t = time.monotonic()
        eng = StereoEngine(ccfg, params=params, emit_confidence=True, model="classic", **kw)
        eng.warmup(buckets=[N_FRAMES])
        int8_gemm.calls.clear()
        with int8_conv_calls(eng.model, conv_calls.setdefault(scheme, {})) as by_shape:
            results, counts = on_path(CLASSIC_INT8_PATH, lambda: serve_frames(eng, feed))
        library_calls[scheme] = int8_gemm.calls["cuda"]
        by_route = {r: sum(v for k, v in by_shape.items() if k[0] == r)
                    for r in ("kernel", "library")}
        chunks = N_FRAMES // 8
        kernel_convs, library_convs = CLASSIC_INT8_ROUTES
        if (eng.metrics.dispatch_batch.n != 1
                or counts["int8_conv"] != kernel_convs * chunks
                or by_route["kernel"] != kernel_convs * chunks
                or library_calls[scheme] != library_convs * chunks
                or by_route["library"] != library_convs * chunks
                or counts.get("int8_epilogue", 0) != 0
                or counts["soft_argmin_cost"] != chunks):
            raise AssertionError(f"classic int8 {scheme} engine: "
                                 f"{eng.metrics.dispatch_batch.summary()}, launches {counts}, "
                                 f"library calls {library_calls[scheme]}, int8 conv calls by "
                                 f"route {by_route}")
        with torch.inference_mode():
            sync = [o.cpu().numpy() for o in eng.pipeline(torch.from_numpy(feed).to(dev))[:3]]
        for r in results:
            for name, got, want in zip(("disparity", "depth_m", "confidence"),
                                       (r.disparity, r.depth_m, r.confidence), sync):
                if not np.array_equal(got, want[r.index]):
                    raise AssertionError(f"classic int8 {scheme} frame {r.index}: streamed "
                                         f"{name} differs from the synchronous pipeline")
        launches.update({(k, f"classic {scheme}"): v for k, v in counts.items()})
        phase(f"classic int8 engine, {scheme}: {N_FRAMES} frames of {W}x{H} (RGB, "
              f"device_microbatch=8) in one dispatch, finite, streamed == synchronous bit for "
              f"bit; launches {counts}, library calls {library_calls[scheme]} "
              f"({time.monotonic() - t:.1f} s)")
        del eng, results, sync

    # The benchmark surface.
    for scheme, kw in schemes.items():
        for b, nb in BENCH_BATCHES.items():
            t = time.monotonic()
            out, counts = on_path(CLASSIC_INT8_PATH, lambda: measure_engine_fps(
                model="classic", params=params, model_cfg=mcfg, preprocess_cfg=rgb, batch=b,
                n_batches=nb, device_microbatch=8, ring_size=2, height=H, width=W, **kw))
            phase(f"bench classic int8 {scheme}: measure_engine_fps batch {b}: {out}; launches "
                  f"{counts}; {card} ({time.monotonic() - t:.1f} s)")
    return kernel_rows, epilogue_rows, launches, library_calls, conv_calls


def check_backward(name: str, got, want) -> str:
    """float32: within 1e-5 of the largest magnitude; bf16: >= 99.9 % of the
    values within one bf16 step of the plain version's, all within two."""
    import torch

    from hobot_stereonet_tpu_torch.ops.kernels import correlation as kc

    if got.dtype == torch.float32:
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        detail = f"max |err| {err:.3g} ({err / scale:.3g} of the largest)"
        ok = err <= 1e-5 * scale
    else:
        ulps = kc.bf16_ulp_distance(got, want)
        one = (ulps <= 1).float().mean().item()
        detail = (f"bit-equal {(ulps == 0).float().mean().item():.6f}, within one bf16 step "
                  f"{one:.6f}, max {ulps.max().item()} steps")
        ok = one >= 0.999 and ulps.max().item() <= 2
    if not ok:
        raise AssertionError(f"{name} differs from its plain version: {detail}")
    return detail


def backward_kernel_rows(rng, flush, dev, c, d, scale, card) -> list:
    """Each backward kernel against its plain version (float32 and bf16) at
    :data:`BWD_SHAPES`, two calls bit-equal; the bf16 kernel's time beside its
    bound.  The soft-argmin backward kernels run with both cotangents and
    with ``gd`` only (the training step's launch: its loss never reads the
    confidence), each on the staged route (asserted); their plain version is
    timed once a shape, with both cotangents."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch.ops.kernels import build
    from hobot_stereonet_tpu_torch.ops.kernels import correlation as kc

    def randn(*shape, s=1.0):
        return torch.from_numpy(s * rng.standard_normal(shape).astype(np.float32)).to(dev)

    rows = []
    for b, h, w in BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            fl, fr, dcorr = randn(b, h, w, c).to(dtype), randn(b, h, w, c).to(dtype), \
                randn(b, h, w, d).to(dtype)
            logits = randn(b, h, w, d, s=3.0).to(dtype)
            cost = randn(b, d, h, w, s=3.0).to(dtype)
            gd, gc = randn(b, h, w), randn(b, h, w)
            size = logits.element_size()
            sa = "hobot_stereonet_tpu/ops/pallas/correlation.py:124"
            cases = [(kc.CORRELATION_BWD, None, "csrc/correlation.cu",
                      "hobot_stereonet_tpu/ops/pallas/correlation.py:66",
                      lambda: kc.correlation_volume_backward(dcorr, fl, fr),
                      lambda: kc.correlation_volume_backward_plain(dcorr, fl, fr), None,
                      b * h * w * (d + 4 * c) * size, 4.0 * b * h * w * d * c)]
            for cot, g in (("gd, gc", gc), ("gd", None)):
                cases += [
                    (kc.SOFT_ARGMIN_BWD, cot, "csrc/soft_argmin.cu", sa,
                     lambda g=g: (kc.soft_argmin_confidence_backward(logits, gd, g, scale),),
                     lambda g=g: (kc.soft_argmin_confidence_backward_plain(logits, gd, g, scale),),
                     kc.soft_argmin_backward_plan(kc.CHANNEL_LAST, b, d, h * w, logits.data_ptr(),
                                                  size, g is not None),
                     b * h * w * (2 * d * size + 4 * (1 + (g is not None))), 10.0 * b * h * w * d),
                    (kc.SOFT_ARGMIN_COST_BWD, cot, "csrc/soft_argmin.cu", sa,
                     lambda g=g: (kc.soft_argmin_cost_backward(cost, gd, g, scale),),
                     lambda g=g: (kc.soft_argmin_cost_backward_plain(cost, gd, g, scale),),
                     kc.soft_argmin_backward_plan(kc.D_LEADING, b, d, h * w, cost.data_ptr(),
                                                  size, g is not None),
                     b * h * w * (2 * d * size + 4 * (1 + (g is not None))), 10.0 * b * h * w * d),
                ]
            plain_ms = {}
            for name, cot, src, replaces, fn, plain, plan, nbytes, flops in cases:
                build.route_counts.clear()
                got, want = fn(), plain()
                routes = dict(build.route_counts)
                again = fn()
                torch.cuda.synchronize()
                label = f"{name}{f' ({cot})' if cot else ''} {dtype} B={b} {h}x{w}"
                detail = "; ".join(check_backward(name, g, p) for g, p in zip(got, want))
                # Tensor cores in bf16, SIMT in float32; the soft-argmin's staged route at D = 24.
                route = plan.route if plan else ("mma" if dtype == torch.bfloat16 else "simt")
                if routes != {f"{name}/{route}": 1} or (plan and route != "staged"):
                    raise AssertionError(f"{label}: routes {routes}, planned {route}")
                if not all(torch.equal(g, a) for g, a in zip(got, again)):
                    raise AssertionError(f"{label}: two calls differ")
                detail += f"; {route} route, two calls bit-equal"
                err = max((g.float() - p.float()).abs().max().item() for g, p in zip(got, want))
                if dtype != torch.bfloat16:
                    phase(f"kernel {label}: {detail}")
                    continue
                if name not in plain_ms:
                    plain_ms[name] = median_ms(plain, flush, iters=5)
                row = dict(
                    name=name, route="cuda", source="hobot_stereonet_tpu_torch/" + src,
                    replaces=replaces, batch=b, shape=f"{h}x{w}", max_abs_err=err,
                    **({"cotangents": cot} if cot else {}),
                    plan=(plan._asdict() if plan else
                          dict(route="mma", instruction="mma.sync.m16n8k16 bf16",
                               deterministic=True)),
                    tolerance=detail, ms=median_ms(fn, flush), plain_ms=plain_ms[name],
                    bound=bound(nbytes, flops, BF16_FLOPS if name == kc.CORRELATION_BWD
                                else F32_FLOPS),
                    library_ms=None)
                rows.append(row)
                phase(f"kernel {label}: {detail}; plan {row['plan']}; kernel {row['ms']:.4f} ms, "
                      f"plain {row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
                      f"({row['bound'][1]}, {100 * row['bound'][0] / row['ms']:.0f}% of it); "
                      f"{card}")
            del fl, fr, dcorr, logits, cost, gd, gc
    return rows


def train_step_parity(model: str, dtype, dev) -> tuple:
    """One ``make_train_step`` of ``model`` from its committed weights on the
    stored batch, against JAX's stored step (raises beyond the bounds);
    returns (a summary, the TF32 flags its first conv read in the forward
    and in the backward)."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models import build_model
    from hobot_stereonet_tpu_torch.runtime import training
    from hobot_stereonet_tpu_torch.runtime.train_loop import to_model_input
    from hobot_stereonet_tpu_torch.runtime.weights import (_flatten, _unwrap, from_flax_params,
                                                           to_flax_params)

    stored = reference.load_train_step(model)
    cfg = StereoNetConfig(compute_dtype=dtype)
    net = build_model(model, cfg, dev)
    npz = reference.PARAMS_NPZ if model == "fast" else reference.CLASSIC_PARAMS_NPZ
    net.load_state_dict(from_flax_params(reference.load_params(npz), cfg, model))
    opt = training.make_optimizer()
    params = dict(net.named_parameters())
    state = training.TrainState(params, opt.init(params), 0)
    left, right = (to_model_input(torch.from_numpy(stored[k]).to(dev), str(stored["color_space"]))
                   for k in ("left_u8", "right_u8"))
    flags = {}
    conv = net.FeatureTower_0.ConvBlock_0.Conv_0
    hooks = (conv.register_forward_pre_hook(record_tf32(flags, "forward")),
             conv.register_full_backward_pre_hook(record_tf32(flags, "backward")))
    _, m = training.make_train_step(net, opt, cfg.max_disparity)(
        state, left, right, torch.from_numpy(stored["disparity"]).to(dev))
    for hk in hooks:
        hk.remove()
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    flat = {"/".join(k): v for k, v in _flatten(_unwrap(to_flax_params(
        {k: p.grad for k, p in params.items()})))}
    want = stored["f32" if dtype == torch.float32 else "bf16"]
    if dtype == torch.float32:
        errs = reference.grad_mismatches(flat, want["grads"], 0.0)
        worst = max(errs, key=lambda e: e[1]) if errs else ("", 0.0)
        bad = [e for e in errs if e[1] > reference.TRAIN_F32_GRAD_RTOL]
        ok = (abs(loss - want["loss"]) <= reference.TRAIN_F32_RTOL * abs(want["loss"])
              and abs(norm - want["grad_norm"]) <= reference.TRAIN_F32_NORM_RTOL[model]
              * want["grad_norm"] and not bad)
        detail = (f"loss {loss:.7f} (JAX {want['loss']:.7f}), grad norm {norm:.6f} (JAX "
                  f"{want['grad_norm']:.6f}), worst gradient {worst[0]} {worst[1]:.3g} relative "
                  f"L2, {len(bad)} of {len(flat)} beyond {reference.TRAIN_F32_GRAD_RTOL}")
    else:
        f32 = stored["f32"]
        res = reference.bf16_grad_check(flat, want["grads"], f32["grads"])
        ok = res["ok"] and abs(loss - f32["loss"]) <= reference.BF16_LOSS_FACTOR * abs(
            want["loss"] - f32["loss"])
        detail = (f"loss {loss:.6f} (JAX bf16 {want['loss']:.6f}, f32 {f32['loss']:.6f}), "
                  f"grad norm {norm:.5f} (JAX {want['grad_norm']:.5f}); distance from JAX's "
                  f"bf16 over JAX bf16's from f32, all gradients: {res['ratio']:.3f} (limit 1); "
                  f"tensors within that bound alone {res['share']:.3f}; farthest gradient "
                  f"that JAX's bf16 resolves: {res['worst'][0]} {res['worst'][1]:.3g} from "
                  f"JAX's f32 (limit {reference.BF16_TENSOR_RTOL})")
    if not (ok and np.isfinite(loss)):
        raise AssertionError(f"{model} {dtype} training step on the card vs JAX: {detail}")
    return detail, flags


def training_phase(ctx: dict) -> tuple:
    """Phase 12; returns (backward kernel rows, {(kernel, None): launches on
    the training loops' paths})."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch.config import Config
    from hobot_stereonet_tpu_torch.data.loader import BatchIterator, SyntheticStereoDataset
    from hobot_stereonet_tpu_torch.models import FastStereoNet
    from hobot_stereonet_tpu_torch.ops.kernels import build
    from hobot_stereonet_tpu_torch.runtime import checkpoint as ckpt
    from hobot_stereonet_tpu_torch.runtime import training
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine
    from hobot_stereonet_tpu_torch.runtime.train_loop import to_model_input, train_synthetic
    from hobot_stereonet_tpu_torch.utils.profiling import device_trace

    dev, card, rng, cfg = ctx["dev"], ctx["card"], ctx["rng"], ctx["cfg"]
    t = time.monotonic()
    k = cfg.model.cost_resolution_divisor
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = backward_kernel_rows(rng, flush, dev, cfg.model.feature_channels,
                                cfg.model.num_disparities_coarse, float(k), card)
    del flush
    phase(f"training: backward kernels checked and timed ({time.monotonic() - t:.1f} s)")

    t = time.monotonic()
    outside = tf32_flags()
    for model in ("fast", "classic"):
        for dtype in (torch.float32, torch.bfloat16):
            build.reset_launch_counts()
            detail, flags = train_step_parity(model, dtype, dev)
            phase(f"training parity: {model} {str(dtype).removeprefix('torch.')} one step on the "
                  f"card vs JAX's stored step: {detail}; TF32 (cuDNN, matmul) in the forward "
                  f"and backward {flags}; launches {dict(build.launch_counts)}")
            want = (False, False) if dtype == torch.float32 else outside
            if flags != {"forward": want, "backward": want}:
                raise AssertionError(f"{model} {dtype} train step: TF32 {flags}, expected {want}")
    phase(f"training parity: done ({time.monotonic() - t:.1f} s)")

    # The flagship's loop from fresh weights; CLASSIC's reuses the rendered scenes.
    t = time.monotonic()
    ck = ROOT / "build" / "train_checkpoint"
    scenes = SyntheticStereoDataset(size=512, seed=0, height=2 * TRAIN_CROP[0],
                                    width=2 * TRAIN_CROP[1])
    res, counts = on_path(TRAIN_PATH, lambda: train_synthetic(
        steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, crop_hw=TRAIN_CROP, log_every=1,
        model="fast", dataset=scenes, model_cfg=cfg.model,
        color_space=cfg.preprocess.color_space, checkpoint_dir=str(ck), device=dev))
    losses = [h["loss"] for h in res["history"]]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    phase(f"training loop: flagship (bf16, {cfg.preprocess.color_space}) {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} crops {TRAIN_CROP[0]}x{TRAIN_CROP[1]} from init_params: "
          f"{res['steps_per_sec']} steps/s (scenes rendered on the host inside the loop, one "
          f"wait a step for the logged loss); mean loss of steps 1-5 {first:.4f}, of the last 5 "
          f"{last:.4f}, final EPE {res['final_epe']:.3f} px; launches {counts}; {card} "
          f"({time.monotonic() - t:.1f} s)")
    if not (last < first and all(np.isfinite(losses))):
        raise AssertionError(f"the flagship's loss did not fall: {losses}")
    want = {n: TRAIN_STEPS * (ctx["gn_per_forward"]["fast"] if n == "group_norm" else 1)
            for n in TRAIN_PATH}
    if any(counts[n] != k for n, k in want.items()):
        raise AssertionError(f"expected {want} launches in {TRAIN_STEPS} steps: {counts}")
    check_routes("flagship training loop", "correlation_bwd", "mma", counts["correlation_bwd"])
    check_routes("flagship training loop", "soft_argmin_bwd", "staged", counts["soft_argmin_bwd"])
    launches = {(n, None): counts[n] for n in ("correlation_bwd", "soft_argmin_bwd")}

    # The device step alone: one batch on the card, 10 steps, then one profiled.
    t = time.monotonic()
    net = FastStereoNet(cfg.model, device=dev)
    opt = training.make_optimizer(lr=1e-3, warmup_steps=4, total_steps=100)
    state = training.create_train_state(net, torch.Generator().manual_seed(1), opt)
    step = training.make_train_step(net, opt, cfg.model.max_disparity)
    l8, r8, d8 = next(iter(BatchIterator(scenes, TRAIN_BATCH, TRAIN_CROP, seed=1)))
    left, right = (to_model_input(torch.from_numpy(a).to(dev), cfg.preprocess.color_space)
                   for a in (l8, r8))
    gt = torch.from_numpy(d8).to(dev)
    for _ in range(3):
        state, m = step(state, left, right, gt)
    torch.cuda.synchronize()

    def steps_per_s() -> float:
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(10):
            state, m = step(state, left, right, gt)
        float(m["loss"])
        return 10 / (time.perf_counter() - t0)

    device_rate = steps_per_s()
    with device_trace(str(ctx["log"] / "train_step")) as prof:
        state, m = step(state, left, right, gt)
        float(m["loss"])
    busy, total, top = profile_summary(prof, top=12)
    phase(f"training step alone (one batch kept on the card): {device_rate:.2f} steps/s; one "
          f"profiled step: device busy {100 * busy:.1f} % of the traced window, {total:.3f} ms "
          f"of device time; the largest kernels and copies: {card}")
    for name, ms, calls in top:
        phase(f"profile:   {ms:9.3f} ms  {calls:5d} calls  {name[:110]}")
    del net, state, step, left, right, gt

    # The checkpoint the loop saved, served at 720p.
    params = ckpt.load_params(str(ck), like=FastStereoNet(cfg.model, device="cpu"))
    eng = StereoEngine(cfg, params=params)
    frames = torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, 3 * H * W),
                                           dtype=np.uint8)).to(dev)
    with torch.inference_mode():
        disp = eng.pipeline(frames)[0]
    torch.cuda.synchronize()
    if disp.shape != (TRAIN_BATCH, H, W) or not bool(torch.isfinite(disp).all()):
        raise AssertionError(f"served the trained checkpoint: {tuple(disp.shape)}, finite "
                             f"{bool(torch.isfinite(disp).all())}")
    phase(f"training: the saved checkpoint ({ck.name}/params.npz) served {TRAIN_BATCH} frames of "
          f"{W}x{H} through StereoEngine, disparity finite, median "
          f"{disp.median().item():.3f} px ({time.monotonic() - t:.1f} s)")
    del eng, frames, disp

    # CLASSIC (RGB): 10 steps on the scenes the flagship's loop rendered.
    t = time.monotonic()
    ccfg = Config()
    cres, ccounts = on_path(CLASSIC_TRAIN_PATH, lambda: train_synthetic(
        steps=CLASSIC_TRAIN_STEPS, batch_size=TRAIN_BATCH, crop_hw=TRAIN_CROP, log_every=1,
        model="classic", dataset=scenes, model_cfg=ccfg.model,
        color_space=ccfg.preprocess.color_space, device=dev))
    closs = [h["loss"] for h in cres["history"]]
    phase(f"training loop: CLASSIC (bf16, rgb) {CLASSIC_TRAIN_STEPS} steps of {TRAIN_BATCH} "
          f"crops: {cres['steps_per_sec']} steps/s (scenes already rendered); losses "
          f"{[round(x, 3) for x in closs]}; launches {ccounts}; {card} "
          f"({time.monotonic() - t:.1f} s)")
    if not all(np.isfinite(closs)) or ccounts["soft_argmin_cost_bwd"] != CLASSIC_TRAIN_STEPS:
        raise AssertionError(f"CLASSIC training: losses {closs}, launches {ccounts}")
    check_routes("classic training loop", "soft_argmin_cost", "vector",
                 ccounts["soft_argmin_cost"])
    check_routes("classic training loop", "soft_argmin_cost_bwd", "staged",
                 ccounts["soft_argmin_cost_bwd"])
    launches[("soft_argmin_cost_bwd", None)] = ccounts["soft_argmin_cost_bwd"]
    return rows, launches


def conv_probe(dev, net, card) -> None:
    """cuDNN's bf16 convs of CLASSIC (``net``, on the card) at one chunk of
    8 frames at 720p: each conv fed the input it gets in the network (its
    median time over 5 calls); then the 3-D
    aggregation conv in NCDHW against ``channels_last_3d`` (the layout's
    cost) and a full-resolution 12-channel dilated conv against the same
    with the channels zero-padded to 16 (whether cuDNN then takes its
    tensor-core kernels)."""
    import torch
    import torch.nn.functional as F

    convs = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: convs.append((name, mod, args[0].clone(
            memory_format=torch.preserve_format))))
        for name, m in net.named_modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    frames = torch.rand((8, H, W, 3), device=dev) * 2 - 1
    try:
        with torch.inference_mode():
            net(frames, torch.roll(frames, -3, 2))
    finally:
        for h in hooks:
            h.remove()
    del frames
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    total = 0.0
    for name, mod, x in convs:
        with torch.inference_mode():
            ms = median_ms(lambda: mod(x), flush, iters=5, warmup=2)
        total += ms
        dil = mod.dilation[0]
        phase(f"classic conv: {name} {mod.in_channels}->{mod.out_channels}"
              f"{f' dilation {dil}' if dil > 1 else ''} on {list(x.shape)}: {ms:.3f} ms")
    phase(f"classic conv: the {len(convs)} convs of a chunk of 8 (each with its input's copies "
          f"and casts): {total:.3f} ms; {card}")
    del convs
    k = net.cfg.cost_resolution_divisor
    c, d = net.cfg.aggregation_channels, net.cfg.num_disparities_coarse
    cases = [  # label, x shape, w shape, dilation, memory format
        ("conv3d 32->32 3x3x3", (8, c, d, H // k, W // k), (c, c, 3, 3, 3), 1,
         torch.channels_last_3d),
        ("same in NCDHW", (8, c, d, H // k, W // k), (c, c, 3, 3, 3), 1, torch.contiguous_format),
        ("conv2d 12->12 3x3 dilation 2", (8, 12, H, W), (12, 12, 3, 3), 2, torch.channels_last),
        ("same, channels zero-padded to 16", (8, 16, H, W), (16, 16, 3, 3), 2,
         torch.channels_last),
    ]
    for label, xs, ws, dil, fmt in cases:
        x = torch.randn(xs, device=dev).bfloat16().contiguous(memory_format=fmt)
        wt = (torch.randn(ws, device=dev) * 0.05).bfloat16().contiguous(memory_format=fmt)
        conv = F.conv3d if len(xs) == 5 else F.conv2d
        ms = median_ms(lambda: conv(x, wt, None, 1, dil, dil), flush, iters=10)
        flops = 2.0 * x[:, :1].numel() * wt[0].numel() * ws[0]
        phase(f"classic conv probe: cuDNN bf16 {label} on {list(xs)} ({fmt}): {ms:.3f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s; {card}")
        del x, wt


def _die_with_parent() -> None:
    """In a child: be killed when this script's process ends (Linux
    ``PR_SET_PDEATHSIG``), so that no command outlives the run."""
    import ctypes
    import signal

    ctypes.CDLL(None).prctl(1, signal.SIGKILL)


def start_cli(*args: str):
    """``python3 -m hobot_stereonet_tpu_torch.cli <args>`` from the checkout's
    root, its output captured."""
    return subprocess.Popen([sys.executable, "-m", "hobot_stereonet_tpu_torch.cli", *args],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            preexec_fn=_die_with_parent)


def finish_cli(name: str, proc, timeout: float = 300.0) -> dict:
    """Wait for a command; it must exit 0 and print one JSON line last."""
    out, err = proc.communicate(timeout=timeout)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"cli {name}: exit {proc.returncode}; stdout {out[-1500:]!r}; "
                             f"stderr {err[-3000:]!r}")
    return json.loads(lines[-1])


def cli_phase(ctx: dict) -> None:
    """Phase 13: the command line, each command a process of its own on the
    card (``python3 -m hobot_stereonet_tpu_torch.cli``), exit 0 and one JSON
    line each, checked against the same work in this process.  They run
    several at once (the stream renders its 720p scenes on the host, about
    a second each, so it starts first), and ``bench`` alone after them, so
    that nothing else runs on the card while it times.  ``dump`` and ``compare``
    of two dumps need PNG input, read through PIL: they run only where
    :data:`CARD_HAS_PIL`."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch import cli, reference
    from hobot_stereonet_tpu_torch.config import Config
    from hobot_stereonet_tpu_torch.data.bintensor import load_input_tensor, save_input_tensor
    from hobot_stereonet_tpu_torch.ops import colorspace as cs
    from hobot_stereonet_tpu_torch.ops import preprocess as pp
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine

    t = time.monotonic()
    dev, cfg, trained = ctx["dev"], ctx["cfg"], ctx["trained"]
    out = ROOT / "build" / "cli"
    out.mkdir(parents=True, exist_ok=True)
    sbs = reference.frame_720p()
    x = pp.nv12_ingest(torch.from_numpy(sbs)[None].to(dev), H, 2 * W, Config().preprocess)
    save_input_tensor(str(out / "x.raw"), x.cpu().numpy(), dtype="float32", layout="nchw")
    eyes = cs.split_side_by_side_nv12(torch.from_numpy(sbs), H, 2 * W)
    for name, eye in zip(("left.nv12", "right.nv12"), eyes):
        eye.numpy().tofile(out / name)
    classic = ["--model", "classic", "--checkpoint", str(reference.CLASSIC_PARAMS_NPZ)]
    layered = ["eval", "--dataset", "layered", "--frames", "8", "--check-determinism"]
    commands = {
        "infer --input-bin": ["infer", "--input-bin", str(out / "x.raw")],
        "infer .nv12": ["infer", "--left", str(out / "left.nv12"), "--right",
                        str(out / "right.nv12")],
        "eval flagship bf16": layered,
        "eval flagship --int8-calib": layered + ["--int8-calib", str(reference.CALIB_JSON)],
        "eval classic --int8": layered + classic + ["--int8"],
        "calibrate classic": ["calibrate", "--out", str(out / "classic_calib.json")] + classic,
    }
    if CARD_HAS_PIL:
        from PIL import Image

        s = ctx["heldout"][0]
        for name, img in (("left.png", s.left), ("right.png", s.right)):
            Image.fromarray(img).save(out / name)
        pair = ["--left", str(out / "left.png"), "--right", str(out / "right.png")]
        commands["dump bf16"] = ["dump", *pair, "--out", str(out / "a.npz")]
        commands["dump bf16 again"] = ["dump", *pair, "--out", str(out / "b.npz"),
                                       "--bin-out", str(out / "b_bin")]
    stream = start_cli("stream", "--frames", "64", "--unpaced", "--ring")
    procs = {name: start_cli(*args) for name, args in commands.items()}
    slam, loaders = slam_clis(), artifact_loaders(ctx)
    beside = artifact_clis(ctx, out)
    # Phase 3's float32 GroupNorm cases (checked, not timed) run here, beside
    # these processes; no timing runs until bench.
    t3 = time.monotonic()
    group_norm_phase(dev, ctx["census"], None, ctx["card"], torch.float32)
    phase(f"groupnorm: the float32 cases exact, beside the commands "
          f"({time.monotonic() - t3:.1f} s)")
    got = {name: finish_cli(name, proc) for name, proc in procs.items()}
    after = {"eval classic --int8-calib (calibrated here)":
             layered + classic + ["--int8-calib", str(out / "classic_calib.json")]}
    if CARD_HAS_PIL:
        after["compare the two dumps"] = ["compare", str(out / "a.npz"), str(out / "b.npz")]
    procs = {name: start_cli(*args) for name, args in after.items()}
    got.update({name: finish_cli(name, proc) for name, proc in procs.items()})
    got["stream --frames 64 --unpaced --ring"] = finish_cli("stream", stream)
    ctx["slam_lines"] = {name: finish_cli(name, proc) for name, proc in slam.items()}
    ctx["loader_reports"] = {name: finish_cli(f"artifact loader {name}", proc)
                             for name, proc in loaders.items()}
    ctx["artifact_lines"] = {name: finish_cli(name, proc) for name, proc in beside.items()}
    got["bench --streaming"] = finish_cli("bench", start_cli("bench", "--streaming"))
    for name, line in got.items():
        phase(f"cli {name}: {json.dumps(line)[:400]}")

    # The same work in this process: the default engine (the crowned
    # flagship's model and weights, RGB input) on the same inputs.
    eng = StereoEngine(dataclasses.replace(Config(), model=cfg.model), params=trained)
    disp = eng.infer_preprocessed(load_input_tensor(str(out / "x.raw"), H, W))
    imgs = [cli._read_any_image(str(out / n), H, W) for n in ("left.nv12", "right.nv12")]
    disp_nv12 = eng.infer(*imgs)
    for name, d in (("infer --input-bin", disp), ("infer .nv12", disp_nv12)):
        want = {"min": float(d.min()), "max": float(d.max()), "mean": float(d.mean())}
        line = got[name]["disparity_px"]
        diff = max(abs(line[k] - want[k]) for k in want)
        phase(f"cli {name}: the JSON line against StereoEngine on the same input: max "
              f"|difference| {diff:.3g} px (limit {CLI_ENGINE_PX})")
        if got[name]["shape"] != [H, W] or diff > CLI_ENGINE_PX:
            raise AssertionError(f"cli {name}: {line} against the engine's {want}")
    for name, line in got.items():
        if name.startswith("eval") and not (line["deterministic"] and line["n_frames"] == 8
                                            and np.isfinite(line["epe_px"])):
            raise AssertionError(f"cli {name}: {line}")
    if got["calibrate classic"]["convs"] != 53:
        raise AssertionError(f"cli calibrate classic: {got['calibrate classic']}")
    committed = json.loads(reference.CLASSIC_CALIB_JSON.read_text())
    mine = json.loads((out / "classic_calib.json").read_text())
    equal = sum(mine[k] == committed[k] for k in committed)
    phase(f"cli calibrate classic on the card: {equal} of {len(committed)} scales equal to "
          f"classic_calib.json (JAX's on the CPU), largest ratio "
          f"{max(max(mine[k] / committed[k], committed[k] / mine[k]) for k in committed):.5f}")
    stream = got["stream --frames 64 --unpaced --ring"]
    if (stream["capture_ring"] != "native"
            or stream["frames_out"] + stream["capture_dropped"] != 64 or stream["nan_dropped"]):
        raise AssertionError(f"cli stream: {stream}")
    if CARD_HAS_PIL and not got["compare the two dumps"]["match"]:
        raise AssertionError(f"cli compare: {got['compare the two dumps']}")
    if got["bench --streaming"]["value"] <= 0:
        raise AssertionError(f"cli bench: {got['bench --streaming']}")
    phase(f"cli: {len(got)} commands, each exit 0 with its JSON line; the stream's frames "
          f"carried by the native host ring; beside them {len(slam)} slam runs, "
          f"{len(loaders)} artifact loaders and {len(beside)} commands on the artifact, checked "
          f"in phases 15 and 14 ({time.monotonic() - t:.1f} s)")


# Run in a fresh process that cannot import the networks' code: load an
# artifact on the card, run each entry on the given inputs (launch counts a
# call, against the custom operators in the entry's graph), then serve 32
# frames through ArtifactEngine (equal to the largest entry's output).
ARTIFACT_LOADER = r"""
import collections, importlib.abc, json, sys, time
class NoModels(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.startswith("hobot_stereonet_tpu_torch.models"):
            raise ImportError("the artifact loader may not import " + name)
        return None
sys.meta_path.insert(0, NoModels())
import numpy as np
import torch
from hobot_stereonet_tpu_torch.data.stream import Frame
from hobot_stereonet_tpu_torch.ops.kernels import build
from hobot_stereonet_tpu_torch.runtime.artifact import ArtifactEngine, CompiledStereoArtifact
path, inputs, out_path, n_frames = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
data = np.load(inputs)
sbs, left, right = data["sbs"], data["left"], data["right"]
t = time.monotonic()
art = CompiledStereoArtifact(path)
h, w = art.height, art.width
report = {"load_s": time.monotonic() - t, "entries": {}}
outs = {}
for kind in ("nv12", "rgb"):
    for b in art.buckets:
        t = time.monotonic()
        graph = art._entry(kind, b).graph
        load_s = time.monotonic() - t
        ops = collections.Counter(str(n.target).split(".")[1] for n in graph.nodes
                                  if n.op == "call_function" and str(n.target).startswith("hst."))
        for _ in range(2):            # the second call is the one counted
            build.reset_launch_counts()
            if kind == "nv12":
                d, z = art.run_nv12(sbs[:b])
                outs[f"nv12_b{b}_depth"] = z
            else:
                d = art.infer(left[:b], right[:b])
            torch.cuda.synchronize()
        outs[f"{kind}_b{b}_disparity"] = d
        report["entries"][f"{kind}_b{b}"] = dict(launches=dict(build.launch_counts),
                                                 ops=dict(ops), load_s=load_s)
b = max(art.buckets)
eng = ArtifactEngine(art, drop_on_full=False)
for i in range(n_frames):
    eng.feed(Frame(time.monotonic(), sbs[i % len(sbs)], h, 2 * w, index=i))
eng.start()
eng.drain(timeout=120.0)
res = sorted(eng.results(timeout=0.5), key=lambda r: r.index)
eng.stop()
assert len(res) == n_frames and not eng.metrics.nan_dropped, (len(res), eng.metrics.snapshot())
for r in res:
    assert np.array_equal(r.disparity, outs[f"nv12_b{b}_disparity"][r.index % b])
report["served"] = len(res)
assert not any(m.startswith("hobot_stereonet_tpu_torch.models") for m in sys.modules)
np.savez(out_path, **outs)
print(json.dumps(report))
"""


def artifact_exports() -> dict:
    """Start the CLI's ``export`` of the flagship (its config and committed
    weights, 1280x720, buckets 1 and 8, platform cuda) in bf16 and in int8
    static, two processes at once, beside the build (an export traces the
    graph and launches no kernel); ``main`` waits for them before phase 3
    times anything.  Returns each artifact's path and its process."""
    from hobot_stereonet_tpu_torch import reference

    out = ROOT / "build" / "artifact"
    out.mkdir(parents=True, exist_ok=True)
    base = ["export", "--config", str(ROOT / "checkpoints" / "flagship" / "config.json"),
            "--checkpoint", str(reference.PARAMS_NPZ),
            "--buckets", ",".join(map(str, ARTIFACT_BUCKETS)), "--platforms", "cuda"]
    return {"bf16": (out / "bf16.stereoblob",
                     start_cli(*base, "--out", str(out / "bf16.stereoblob"))),
            "int8 static": (out / "int8_static.stereoblob",
                            start_cli(*base, "--out", str(out / "int8_static.stereoblob"),
                                      "--int8-calib", str(reference.CALIB_JSON)))}


def artifact_loaders(ctx: dict) -> dict:
    """Start the loaders (:data:`ARTIFACT_LOADER`), one process for each
    exported artifact, on frames and images written here; phase 14 reads
    their reports."""
    import numpy as np

    out = ROOT / "build" / "artifact"
    rng = np.random.default_rng(14)
    b_max = max(ARTIFACT_BUCKETS)
    np.savez(out / "inputs.npz", sbs=rng.integers(0, 256, (b_max, 3 * H * W), dtype=np.uint8),
             left=rng.integers(0, 256, (b_max, H, W, 3), dtype=np.uint8),
             right=rng.integers(0, 256, (b_max, H, W, 3), dtype=np.uint8))
    return {name: subprocess.Popen(
        [sys.executable, "-c", ARTIFACT_LOADER, str(path), str(out / "inputs.npz"),
         str(out / f"{name.replace(' ', '_')}_outputs.npz"), str(ARTIFACT_FRAMES)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=_die_with_parent) for name, (path, _) in ctx["exports"].items()}


def artifact_phase(ctx: dict) -> None:
    """Phase 14: the compiled artifact.  The exports (run beside the build)
    exited 0; each artifact's loader, a fresh process that cannot
    import the networks' code (:data:`ARTIFACT_LOADER`, run beside phase
    13's commands), found each entry's launches a call to be the
    flagship's kernels and the graph's ``hst::`` operators one launch each
    (so no plain version ran), and served 32 frames; here each entry's
    outputs must equal ``StereoEngine.pipeline`` bit for bit (the rgb
    entries the network on the same batch), and ``ArtifactEngine`` and
    ``StereoEngine`` serve host frames in bf16 at each bucket in turns
    (``runtime.benchmark.fps_in_turns``), nothing else on the card."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.ops import preprocess as pp
    from hobot_stereonet_tpu_torch.runtime.artifact import ArtifactEngine, CompiledStereoArtifact
    from hobot_stereonet_tpu_torch.runtime.benchmark import fps_in_turns
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine

    t = time.monotonic()
    dev, cfg, trained, card = ctx["dev"], ctx["cfg"], ctx["trained"], ctx["card"]
    out = ROOT / "build" / "artifact"
    for name, (path, line) in ctx["exports"].items():
        if line["bytes"] != path.stat().st_size or line["buckets"] != list(ARTIFACT_BUCKETS):
            raise AssertionError(f"export {name}: {line}")
        phase(f"artifact: export {name}: {line['bytes']} bytes in {line['seconds']:.3f} s "
              f"(its process, beside the build and the other export); {json.dumps(line)}")
    inputs = np.load(out / "inputs.npz")
    sbs, left, right = inputs["sbs"], inputs["left"], inputs["right"]

    for name, (path, _) in ctx["exports"].items():
        rep = ctx["loader_reports"][name]
        got = np.load(out / f"{name.replace(' ', '_')}_outputs.npz")
        expect = dict(ARTIFACT_LAUNCHES)
        quant = {} if name == "bf16" else {"static_quant": str(reference.CALIB_JSON)}
        if quant:
            expect["int8_conv"] = ARTIFACT_INT8_CONVS
        for entry, info in rep["entries"].items():
            want = dict(expect) if entry.startswith("nv12") else {
                k: v for k, v in expect.items() if k != "nv12_ingest"}
            by_ops = {OP_KERNELS[op]: n for op, n in info["ops"].items()}
            if info["launches"] != want or by_ops != want:
                raise AssertionError(f"artifact {name} {entry}: launches {info['launches']}, "
                                     f"hst operators in its graph {info['ops']}; expected {want}")
        eng = StereoEngine(cfg, params=trained, **quant)
        for b in ARTIFACT_BUCKETS:
            with torch.inference_mode():
                d, z = (o.cpu().numpy() for o in eng.pipeline(
                    torch.from_numpy(sbs[:b]).to(dev))[:2])
                x = pp.rgb_batch_to_model_input(torch.from_numpy(left[:b]).to(dev),
                                                torch.from_numpy(right[:b]).to(dev),
                                                cfg.preprocess)
                d_rgb = eng.model(*pp.split_model_input(x))["disparity"].cpu().numpy()
            for what, a, want_a in ((f"nv12_b{b} disparity", got[f"nv12_b{b}_disparity"], d),
                                    (f"nv12_b{b} depth", got[f"nv12_b{b}_depth"], z),
                                    (f"rgb_b{b} disparity", got[f"rgb_b{b}_disparity"], d_rgb)):
                if not np.array_equal(a, want_a):
                    raise AssertionError(f"artifact {name} {what} differs from the engine: max "
                                         f"|diff| {np.abs(a - want_a).max()}")
        del eng
        loads = ", ".join(f"{k} {v['load_s']:.2f} s" for k, v in rep["entries"].items())
        phase(f"artifact {name}: loaded without the networks' code (entries {loads}); every "
              f"entry equals StereoEngine bit for bit; launches a call "
              f"{rep['entries']['nv12_b1']['launches']} (rgb: no ingest), one a hst operator; "
              f"ArtifactEngine served {rep['served']} frames there")
    art = CompiledStereoArtifact(str(ctx["exports"]["bf16"][0]))
    for b in ARTIFACT_BUCKETS:
        a_eng = ArtifactEngine(art, max_batch=b, drop_on_full=False)
        a_eng.warmup()
        e = StereoEngine(dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, max_batch=b, drop_on_full=False)), params=trained)
        e.warmup(buckets=[b])
        runs = fps_in_turns({"ArtifactEngine": a_eng, "StereoEngine": e}, sbs,
                            ARTIFACT_FPS_FRAMES[b], rounds=ARTIFACT_FPS_ROUNDS)
        ratios = [x / y for x, y in zip(runs["ArtifactEngine"], runs["StereoEngine"])]
        phase(f"artifact bf16: batch {b}, {ARTIFACT_FPS_ROUNDS} rounds of "
              f"{ARTIFACT_FPS_FRAMES[b]} frames of {W}x{H} an engine, in turns (host "
              f"frames): ArtifactEngine {runs['ArtifactEngine']}, StereoEngine "
              f"{runs['StereoEngine']} frames/s; ratios {ratios}, median "
              f"{statistics.median(ratios)}; {card}")
        del a_eng, e
    art.close()
    stream, infer = (ctx["artifact_lines"][k] for k in ("stream --artifact", "infer --artifact"))
    if stream["frames_out"] != 8 or stream["nan_dropped"] or infer["shape"] != [H, W]:
        raise AssertionError(f"cli with --artifact: stream {stream}, infer {infer}")
    phase(f"artifact: cli (beside phase 13's commands) stream --artifact "
          f"{json.dumps(stream)[:300]}; infer --artifact {json.dumps(infer)} "
          f"({time.monotonic() - t:.1f} s)")


def artifact_clis(ctx: dict, eyes: Path) -> dict:
    """Start the CLI's ``stream --artifact`` (8 synthetic frames) and ``infer
    --artifact`` (the raw ``.nv12`` eyes in ``eyes``) on the bf16 artifact
    (the exported bf16 artifact)."""
    path, _ = ctx["exports"]["bf16"]
    return {"stream --artifact": start_cli("stream", "--frames", "8", "--unpaced",
                                           "--artifact", str(path)),
            "infer --artifact": start_cli("infer", "--left", str(eyes / "left.nv12"),
                                          "--right", str(eyes / "right.nv12"),
                                          "--artifact", str(path))}


def slam_clis() -> dict:
    """Start the CLI's ``slam`` runs (each a process of its own): the
    defaults (network disparity from the flagship's weights), ground-truth
    disparity, loop closure with the confidence gate, and an EuRoC-layout
    sequence this function writes (rendered scenes, an ideal rig)."""
    import numpy as np

    from hobot_stereonet_tpu_torch.data.euroc import write_sequence
    from hobot_stereonet_tpu_torch.data.synthetic import LayeredScene

    root = ROOT / "build" / "slam" / "euroc"
    cam_h, cam_w, focal, baseline = 240, 320, 300.0, 0.12
    scene = LayeredScene(np.random.default_rng(11), cam_h, cam_w, focal, baseline)
    ts = np.linspace(0, 1, 10)
    centers = np.stack([0.6 * ts, 0.12 * np.sin(2 * np.pi * ts), np.zeros_like(ts)], axis=-1)
    frames = [scene.render(float(x), float(y)) for x, y, _ in centers]
    write_sequence(str(root / "MH_01_easy"), [f[0] for f in frames], [f[1] for f in frames],
                   centers, focal, baseline)
    runs = {"slam": [], "slam --gt-disparity": ["--gt-disparity"],
            "slam --loop-closure --confidence-gate 0.5": ["--loop-closure",
                                                          "--confidence-gate", "0.5"],
            "slam --odometry-root (EuRoC layout)": ["--odometry-root", str(root),
                                                    "--sequence", "MH_01_easy"]}
    return {name: start_cli("slam", *args) for name, args in runs.items()}


def slam_phase(ctx: dict) -> None:
    """Phase 15: the SLAM back end on the card.  The CLI's ``slam`` runs
    (:func:`slam_clis`, beside phase 13's commands) exit 0, never lose track, print their ATE (on
    ground-truth disparity under 0.05 m); ``StereoSLAM`` on the card and on
    the CPU on the CPU tests' run (seed 11, 320x240, 12 frames, 256
    keypoints, ground-truth disparity) agree frame by frame (camera centres,
    BA costs, keyframes, loops); TF32 reads off inside the geometry even
    where it is on outside."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch.config import CameraConfig, SLAMConfig
    from hobot_stereonet_tpu_torch.data.synthetic import LayeredScene
    from hobot_stereonet_tpu_torch.slam import pose_graph, tracker

    t = time.monotonic()
    got = ctx["slam_lines"]
    for name, line in got.items():
        phase(f"slam: cli {name}: {json.dumps(line)}")
        lost = line.get("lost", line["frames"] - line.get("tracked", 0))
        if lost or "ate_m" not in line or not np.isfinite(line["ate_m"]):
            raise AssertionError(f"cli {name}: {line}")
    if got["slam --gt-disparity"]["ate_m"] >= SLAM_ATE_M:
        raise AssertionError(f"slam --gt-disparity: ATE {got['slam --gt-disparity']['ate_m']} m")

    cam = CameraConfig(width=320, height=240, focal_px=300.0, baseline_mm=120.0)
    scene = LayeredScene(np.random.default_rng(11), cam.height, cam.width, cam.focal_px,
                         cam.baseline_m)
    ts = np.linspace(0, 1, 12)
    gt = np.stack([0.6 * ts, 0.12 * np.sin(2 * np.pi * ts), np.zeros_like(ts)], axis=-1)
    frames = [scene.render(float(x), float(y)) for x, y, _ in gt]
    tf32_seen = []
    real_solve = torch.linalg.solve

    def solve(*a, **k):
        if a[0].device.type == "cuda":
            tf32_seen.append(tf32_flags())
        return real_solve(*a, **k)

    res = {}
    saved = tf32_flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    torch.linalg.solve = solve
    try:
        for device in (ctx["dev"], "cpu"):
            slam = tracker.StereoSLAM(cam, SLAMConfig(keyframe_translation_m=0.08,
                                                      ba_iterations=6),
                                      num_keypoints=256, device=device)
            t1 = time.monotonic()
            outs = [slam.process(l, d) for l, _, d in frames]
            cost = slam.refine_window(window=3)["cost"]
            loops = pose_graph.close_loops(slam)
            centres = np.stack(slam.state.trajectory)
            res[str(device)] = dict(
                seconds=time.monotonic() - t1, tracked=sum(o["tracked"] for o in outs),
                ate_m=tracker.absolute_trajectory_error(centres, gt),
                keyframes=len(slam.state.keyframes), ba_cost=(float(cost[0]), float(cost[-1])),
                loops=0 if loops is None else len(loops["loops"]), centres=centres,
                cost=np.asarray(cost, np.float64))
    finally:
        torch.linalg.solve = real_solve
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    card_run, cpu_run = res[str(ctx["dev"])], res["cpu"]
    brief = {k: {n: v for n, v in r.items() if n not in ("centres", "cost")}
             for k, r in res.items()}
    phase(f"slam: StereoSLAM, 12 frames of 320x240 on ground-truth disparity, windowed BA and "
          f"loop closure: card {brief[str(ctx['dev'])]}, CPU {brief['cpu']}; {ctx['card']}")
    for r in (card_run, cpu_run):
        if r["tracked"] != 12 or r["ate_m"] >= SLAM_ATE_M or r["ba_cost"][1] > 1.01 * r["ba_cost"][0]:
            raise AssertionError(f"StereoSLAM: {brief}")
    if (card_run["centres"].shape != cpu_run["centres"].shape
            or card_run["cost"].shape != cpu_run["cost"].shape
            or (card_run["keyframes"], card_run["loops"]) != (cpu_run["keyframes"], cpu_run["loops"])):
        raise AssertionError(f"StereoSLAM on the card against the CPU: {brief}")
    centre_gap = float(np.linalg.norm(card_run["centres"] - cpu_run["centres"], axis=1).max())
    cost_gap = float(np.max(np.abs(card_run["cost"] - cpu_run["cost"])
                            / np.maximum(np.abs(cpu_run["cost"]), 1e-30)))
    phase(f"slam: the card against the CPU: largest camera-centre distance {centre_gap:.3e} m "
          f"(limit {SLAM_CENTRE_TO_CPU_M}) over {len(cpu_run['centres'])} frames; largest "
          f"relative BA cost difference {cost_gap:.3e} (limit {SLAM_COST_TO_CPU}) over "
          f"{len(cpu_run['cost'])} costs; ATE {card_run['ate_m']!r} against {cpu_run['ate_m']!r} m")
    if centre_gap > SLAM_CENTRE_TO_CPU_M or cost_gap > SLAM_COST_TO_CPU:
        raise AssertionError(f"StereoSLAM on the card against the CPU: centres {centre_gap} m, "
                             f"BA costs {cost_gap} relative")
    if not tf32_seen or any(f != (False, False) for f in tf32_seen):
        raise AssertionError(f"TF32 inside the geometry's solves on the card: {set(tf32_seen)}")
    phase(f"slam: TF32 read (cuDNN, matmul) = (False, False) at each of the {len(tf32_seen)} "
          f"solves on the card, with TF32 on outside ({time.monotonic() - t:.1f} s)")


def start_two_ranks(out: Path) -> list:
    """``scripts/torch_two_ranks_one_card.py`` as ranks 0 and 1 (gloo on
    cuda:0), their output captured; rank 0 writes ``out / "out.json"``."""
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "scripts" / "torch_two_ranks_one_card.py"), "--rank",
         str(r), "--world", "2", "--store", str(out), "--out", str(out / "out.json"),
         "--frames", str(SCALE_BATCH)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, preexec_fn=_die_with_parent) for r in (0, 1)]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tile_halves(rows: int) -> list:
    """(first row, rows) of each rank's tile of a tensor with ``rows`` rows
    at ``tile = 2`` (the engine's split: at 1/8, where both networks' 720p
    images have H / 8 rows, then scaled to the tensor's resolution)."""
    from hobot_stereonet_tpu_torch.parallel.tiling import split_rows

    coarse = split_rows(H // 8, 2)
    counts = [c * rows // (H // 8) for c in coarse]
    return [(sum(counts[:t]), counts[t]) for t in range(2)]


def split_group_norm_cases(dev, census) -> list:
    """The split GroupNorm entries at every shape of ``census`` at a batch of
    :data:`SCALE_BATCH` (bf16; conv bias, skip and LeakyReLU, the residual
    blocks' form): ``group_norm_stats``, the statistics finished, then
    ``group_norm_apply`` over the whole tensor equal the fused launch bit
    for bit (output, mean, rstd).  Then the two row tiles that ``tile = 2``
    gives (:func:`tile_halves`), each in a tensor of its own as a rank holds
    it: each tile's sums, combined, give statistics within 8 sqrt(n)
    float32 ulps of the scale (the values' RMS for the mean, rstd for
    rstd; n elements a group) of the whole's (each side is a float32 chain
    off the exact value by about sqrt(n) ulps: 1e-4 relative at 720x1280),
    and each tile's output from them is kept: :func:`split_group_norm_plain`
    and :func:`split_group_norm_rows` hold both entries on each tile to
    their plain versions.  Returns the cases."""
    import torch

    from hobot_stereonet_tpu_torch.models.layers import GN_EPS, num_groups
    from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg

    gen = torch.Generator(device=dev).manual_seed(16)
    cases = []
    for (mult, c, spatial), per_net in sorted(census.items()):
        g, n = num_groups(c), mult * SCALE_BATCH
        fmt = torch.channels_last_3d if len(spatial) == 3 else torch.channels_last
        w = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.rand(c, device=dev, generator=gen) - 0.5
        cb = torch.rand(c, device=dev, generator=gen) * 4 - 2
        x = (torch.randn((n, c) + spatial, device=dev, generator=gen) * 3 + 1).to(
            torch.bfloat16).contiguous(memory_format=fmt)
        sk = torch.randn((n, c) + spatial, device=dev, generator=gen).to(
            torch.bfloat16).contiguous(memory_format=fmt)
        count = c // g * x[0, 0].numel()
        with torch.inference_mode():
            want, w_mean, w_rstd = kg._group_norm_cuda(x, g, w, bias, GN_EPS, conv_bias=cb,
                                                       skip=sk, activate=True)
            sums = kg.group_norm_stats(x, g, cb)
            mean, rstd = kg.statistics_from_sums(sums, count, GN_EPS)
            got = kg.group_norm_apply(x, w, bias, mean, rstd, conv_bias=cb, skip=sk,
                                      activate=True)
            for name, a, b in (("output", got, want), ("mean", mean, w_mean),
                               ("rstd", rstd, w_rstd)):
                if not torch.equal(a, b):
                    raise AssertionError(f"split GroupNorm [{n}, {c}, {spatial}]: stats then "
                                         f"apply differ from the fused launch in {name}")
            dim = x.dim() - 2
            tiles = [dict(x=x.narrow(dim, a, m).contiguous(memory_format=fmt),
                          sk=sk.narrow(dim, a, m).contiguous(memory_format=fmt))
                     for a, m in tile_halves(x.shape[dim])]
            for tl in tiles:
                tl["sums"] = kg.group_norm_stats(tl["x"], g, cb)
            mean2, rstd2 = kg.statistics_from_sums(
                kg.combine_sums([tl["sums"] for tl in tiles]), count, GN_EPS)
            for tl in tiles:
                tl["out"] = kg.group_norm_apply(tl["x"], w, bias, mean2, rstd2, conv_bias=cb,
                                                skip=tl["sk"], activate=True)
            a = (x + cb.to(x.dtype).view((1, -1) + (1,) * len(spatial))).float()
            rms = a.reshape(n, g, -1).pow(2).mean(2).sqrt()
        ulps = 8 * count ** 0.5 * 2.0 ** -24
        far = {}
        for name, got2, whole, scale in (("mean", mean2, w_mean, rms), ("rstd", rstd2, w_rstd,
                                                                         w_rstd)):
            far[name] = float(((got2 - whole).abs() / scale).max())
            if far[name] > ulps:
                raise AssertionError(f"split GroupNorm [{n}, {c}, {spatial}] over row tiles: "
                                     f"{name} {far[name]} of its scale from the whole's "
                                     f"(limit {ulps:.3g})")
        tile_shape = tuple(tiles[0]["x"].shape[2:])
        phase(f"scale-out: split GroupNorm [{n}, {c}, {'x'.join(map(str, spatial))}] bf16 "
              f"(x{per_net}): stats then apply == the fused launch bit for bit; its two "
              f"tile = 2 tiles [{n}, {c}, {'x'.join(map(str, tile_shape))}] combined: "
              f"statistics within {far} of their scale from the whole's (limit {ulps:.3g})")
        cases.append(dict(shape=(n, c, spatial), tile_shape=(n, c, tile_shape), per_net=per_net,
                          g=g, w=w, bias=bias, cb=cb, mean=mean2, rstd=rstd2, tiles=tiles))
    return cases


def split_group_norm_plain(cases) -> list:
    """Each case's split entries on each tile by their plain versions on the
    host, from the card's combined statistics: ([(sums, output) a tile],
    {entry: ms a call, the tiles' mean})."""
    from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg

    out = []
    for cs in cases:
        host = {k: cs[k].cpu() for k in ("w", "bias", "cb", "mean", "rstd")}
        got, ms = [], {"group_norm_stats": 0.0, "group_norm_apply": 0.0}
        for tl in cs["tiles"]:
            x, sk = tl["x"].cpu(), tl["sk"].cpu()
            t_stats = time.monotonic()
            sums = kg.group_norm_stats(x, cs["g"], host["cb"])
            t_apply = time.monotonic()
            y = kg.group_norm_apply(x, host["w"], host["bias"], host["mean"], host["rstd"],
                                    conv_bias=host["cb"], skip=sk, activate=True)
            t_end = time.monotonic()
            got.append((sums, y))
            ms["group_norm_stats"] += (t_apply - t_stats) * 1e3 / len(cs["tiles"])
            ms["group_norm_apply"] += (t_end - t_apply) * 1e3 / len(cs["tiles"])
        out.append((got, ms))
    return out


def split_group_norm_rows(cases, plain, flush, card, tile_calls: dict) -> list:
    """Each split entry on each case's tile = 2 tile (rank 0's), at batch
    :data:`SCALE_BATCH` and 4 times it (that batch is the first samples,
    tiled): the card's time beside its byte bound (stats: x read once;
    apply: x and the skip read, the output written once), and at the
    smaller batch the plain version's time (:func:`split_group_norm_plain`)
    and the largest difference from it on either tile (must be 0: the sums
    and the output bit for bit).  ``tile_calls``: the tile = 2 run's
    GroupNorm calls on rank 0 by input shape, one launch of each entry a
    call, which must be the census' count at each tile shape."""
    import torch

    from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg

    rows = []
    src = dict(route="cuda", source="hobot_stereonet_tpu_torch/csrc/group_norm.cu",
               replaces="hand-written without a Pallas counterpart (flax GroupNorm, "
                        "hobot_stereonet_tpu/models/layers.py, left to XLA), split at its "
                        "statistics for row tiles")
    for cs, (plain_tiles, plain_ms) in zip(cases, plain):
        n, c, spatial = cs["tile_shape"]
        key = f"[{n}, {c}, {'x'.join(map(str, spatial))}]"
        if tile_calls.get(key, 0) != sum(cs["per_net"].values()):
            raise AssertionError(f"the tile = 2 run's GroupNorms at {key}: "
                                 f"{tile_calls.get(key, 0)} calls, the census' {cs['per_net']}")
        g, w, bias, cb = cs["g"], cs["w"], cs["bias"], cs["cb"]
        t = time.monotonic()
        errs = {"group_norm_stats": 0.0, "group_norm_apply": 0.0}
        for tl, (sums, y) in zip(cs["tiles"], plain_tiles):
            errs["group_norm_stats"] = max(errs["group_norm_stats"],
                                           float((tl["sums"].cpu() - sums).abs().max()))
            errs["group_norm_apply"] = max(errs["group_norm_apply"], float(
                (tl["out"].cpu().float() - y.float()).abs().max()))
        if any(errs.values()):
            raise AssertionError(f"split GroupNorm on the tiles {key} against its plain "
                                 f"version: {errs}")
        for b_mult in (1, 4):
            x, sk = cs["tiles"][0]["x"], cs["tiles"][0]["sk"]
            fmt = torch.channels_last_3d if x.dim() == 5 else torch.channels_last
            x = x.repeat((b_mult,) + (1,) * (x.dim() - 1)).contiguous(memory_format=fmt)
            sk = sk.repeat((b_mult,) + (1,) * (x.dim() - 1)).contiguous(memory_format=fmt)
            mean, rstd = cs["mean"].repeat(b_mult, 1), cs["rstd"].repeat(b_mult, 1)
            elems = x.numel()
            with torch.inference_mode():
                ms = {"group_norm_stats": median_ms(lambda: kg.group_norm_stats(x, g, cb), flush),
                      "group_norm_apply": median_ms(lambda: kg.group_norm_apply(
                          x, w, bias, mean, rstd, conv_bias=cb, skip=sk, activate=True), flush)}
            bounds = {"group_norm_stats": bound(2 * elems, 2 * elems),
                      "group_norm_apply": bound(3 * 2 * elems, 4 * elems)}
            batch = SCALE_BATCH * b_mult
            for name in ms:
                row = dict(name=name, **src, batch=batch, per_forward=cs["per_net"],
                           shape=f"[{n * b_mult}, {c}, {'x'.join(map(str, spatial))}]",
                           tile_key=key, max_abs_err=errs[name], ms=ms[name],
                           bound=bounds[name],
                           plain_ms=plain_ms[name] if b_mult == 1 else None, library_ms=None)
                phase(f"kernel {name} {row['shape']} (a tile = 2 tile) bf16 B={batch}: "
                      f"{ms[name]:.4f} ms, bound {bounds[name][0]:.4f} ms ({bounds[name][1]}, "
                      f"{100 * bounds[name][0] / ms[name]:.0f} %)"
                      + (f", plain (host) {plain_ms[name]:.1f} ms, exact on both tiles; "
                         f"{tile_calls[key]} launches on the tile = 2 run" if b_mult == 1
                         else "") + f"; {card}")
                if b_mult == 1:
                    rows.append(row)
        phase(f"scale-out: split GroupNorm on the tiles {key} timed "
              f"({time.monotonic() - t:.1f} s)")
    return rows


def sharded_step_phase(dev, mesh, card) -> dict:
    """The flagship's ``make_sharded_train_step`` on the (1, 1) NCCL ``mesh``
    against ``make_train_step`` from the same committed weights on the stored
    batch (4 crops of 128x256), float32 and bf16: the loss, EPE, gradient
    norm, every gradient and the updated parameters bit for bit, with the
    same launches, under cuDNN's deterministic algorithms (its default ones
    may sum a weight gradient in another order from run to run).  Returns a
    summary by precision, with both runs for :func:`sharded_step_timing`."""
    import torch

    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models import build_model
    from hobot_stereonet_tpu_torch.ops.kernels import build
    from hobot_stereonet_tpu_torch.parallel.mesh import replicate, shard_batch
    from hobot_stereonet_tpu_torch.runtime import training
    from hobot_stereonet_tpu_torch.runtime.train_loop import to_model_input
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params

    stored = reference.load_train_step("fast")
    cs = str(stored["color_space"])
    batch = [to_model_input(torch.from_numpy(stored[k]).to(dev), cs)
             for k in ("left_u8", "right_u8")] + [torch.from_numpy(stored["disparity"]).to(dev)]
    flax = reference.load_params(reference.PARAMS_NPZ)
    summary = {}
    shipped = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = StereoNetConfig(compute_dtype=dtype)
        runs = {}
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        for kind in ("make_train_step", "sharded"):
            net = build_model("fast", cfg, dev)
            net.load_state_dict(from_flax_params(flax, cfg, "fast"))
            opt = training.make_optimizer()
            params = dict(net.named_parameters())
            if kind == "sharded":
                replicate(mesh, params)
                step = training.make_sharded_train_step(net, opt, mesh, cfg.max_disparity)
                inputs = [shard_batch(mesh, t, factor=cfg.cost_resolution_divisor)
                          for t in batch]
            else:
                step = training.make_train_step(net, opt, cfg.max_disparity)
                inputs = batch
            state = training.TrainState(params, opt.init(params), 0)
            torch.cuda.synchronize()
            build.reset_launch_counts()
            state, m = step(state, *inputs)
            torch.cuda.synchronize()
            runs[kind] = dict(
                step=step, state=state, inputs=inputs, metrics=m,
                launches=dict(build.launch_counts),
                grads={k: p.grad.clone() for k, p in params.items()},
                params={k: p.detach().clone() for k, p in params.items()})
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = shipped
        a, b = runs["make_train_step"], runs["sharded"]
        name = str(dtype).removeprefix("torch.")
        diff = [k for k in ("loss", "epe", "grad_norm")
                if not torch.equal(a["metrics"][k], b["metrics"][k])]
        diff += [f"grad {k}" for k in a["grads"] if not torch.equal(a["grads"][k], b["grads"][k])]
        diff += [f"param {k}" for k in a["params"]
                 if not torch.equal(a["params"][k], b["params"][k])]
        n_grads = len(a["grads"])
        for run in runs.values():
            del run["grads"], run["params"]
        if diff or a["launches"] != b["launches"] or any(
                b["launches"].get(k, 0) <= 0 for k in TRAIN_PATH):
            raise AssertionError(f"(1, 1) mesh sharded step, flagship {name}: differs from "
                                 f"make_train_step in {diff[:8]} ({len(diff)}); launches "
                                 f"{b['launches']}, make_train_step's {a['launches']}")
        summary[name] = {"loss": float(b["metrics"]["loss"]),
                         "grad_norm": float(b["metrics"]["grad_norm"]),
                         "launches": b["launches"], "runs": runs}
        phase(f"scale-out: (1, 1) NCCL mesh sharded train step, flagship {name}, stored batch "
              f"4x128x256: loss, EPE, gradient norm, all {n_grads} gradients and the "
              f"updated parameters equal make_train_step's bit for bit (cuDNN deterministic), "
              f"launches {b['launches']} (the same)")
    return summary


def sharded_step_timing(summary: dict, card: str, log: Path) -> None:
    """Both steps of :func:`sharded_step_phase` in turns, the card otherwise
    idle: steps/s on the host's clock and the median time a step between
    CUDA events on the stream (the runs' states go on from their checks);
    then one profiled step of each: its device time (the kernels' and
    copies' sum) and the device-busy share of the traced window."""
    import torch

    from hobot_stereonet_tpu_torch.utils.profiling import device_trace

    def timed(run) -> tuple:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2 * SHARDED_STEPS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(SHARDED_STEPS):
            events[2 * i].record()
            run["state"], m = run["step"](run["state"], *run["inputs"])
            events[2 * i + 1].record()
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms = [events[2 * i].elapsed_time(events[2 * i + 1]) for i in range(SHARDED_STEPS)]
        return SHARDED_STEPS / wall, statistics.median(ms)

    for name, res in summary.items():
        runs = res.pop("runs")
        turns = {"make_train_step": [], "sharded": []}
        for kind in ("make_train_step", "sharded", "sharded", "make_train_step"):
            turns[kind].append(timed(runs[kind]))
        res["steps_per_s"] = {k: [round(r, 3) for r, _ in v] for k, v in turns.items()}
        res["stream_ms"] = {k: [round(t, 4) for _, t in v] for k, v in turns.items()}
        res["device_ms"], res["busy"] = {}, {}
        for kind, run in runs.items():
            with device_trace(str(log / f"sharded_step_{kind}_{name}")) as prof:
                run["state"], m = run["step"](run["state"], *run["inputs"])
                float(m["loss"])
            busy, total, _ = profile_summary(prof)
            res["device_ms"][kind], res["busy"][kind] = round(total, 4), round(busy, 4)
        phase(f"scale-out: (1, 1) mesh sharded train step against make_train_step, flagship "
              f"{name}, in turns (make_train_step, sharded x2, make_train_step; "
              f"{SHARDED_STEPS} steps a round, the card otherwise idle): steps/s "
              f"{res['steps_per_s']}, median ms a step between CUDA events on the stream "
              f"{res['stream_ms']}; one profiled step each: device time {res['device_ms']} ms, "
              f"device busy {res['busy']} of the traced window; {card}")


def scale_out_phase(ctx: dict) -> tuple:
    """Phase 16: scale-out on one card.  Two gloo ranks on cuda:0 (started
    first, in processes of their own): tile = 2 engines of both networks,
    whose GroupNorms launch the split entries, against the one-card
    engines, and the distributed BA.  Meanwhile a single-rank NCCL group
    (``initialize``) and a (1, 1) mesh ``StereoEngine`` of the flagship at
    720p (bf16 and int8 static, a batch of :data:`SCALE_BATCH`) against
    ``StereoEngine``: bit for bit, with the same launches, synchronously
    and streamed; the split GroupNorm entries at every census shape and on
    its tile = 2 tiles.  Once the ranks are done (the card otherwise idle):
    both bf16 engines' frames/s in turns and the split entries' times at
    the tile shapes.  Returns the kernel rows and the tile = 2 run's
    GroupNorm calls by input shape."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch.config import MeshConfig
    from hobot_stereonet_tpu_torch.ops.kernels import build
    from hobot_stereonet_tpu_torch.parallel import distributed
    from hobot_stereonet_tpu_torch.parallel.mesh import make_mesh
    from hobot_stereonet_tpu_torch.reference import CALIB_JSON
    from hobot_stereonet_tpu_torch.runtime.benchmark import fps_in_turns
    from hobot_stereonet_tpu_torch.runtime.engine import Frame, StereoEngine

    dev, cfg, trained, card = ctx["dev"], ctx["cfg"], ctx["trained"], ctx["card"]
    t0 = time.monotonic()
    ranks_dir = ROOT / "build" / "two_ranks"
    ranks = start_two_ranks(ranks_dir)
    info = distributed.initialize(f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    if info["backend"] != "nccl" or info["process_count"] != 1:
        raise AssertionError(f"initialize: {info}")
    mesh = make_mesh(MeshConfig(1, 1))
    phase(f"scale-out: initialize formed a single-rank group: {info}; mesh {tuple(mesh.shape)} "
          f"{mesh.mesh_dim_names} on {mesh.device_type}")
    scfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, max_batch=SCALE_BATCH, batch_buckets=(1, SCALE_BATCH), drop_on_full=False))
    feed = np.random.default_rng(16).integers(0, 256, (SCALE_BATCH, 3 * H * W), dtype=np.uint8)
    batch = torch.from_numpy(feed).to(dev)
    engines, launches = {}, {}
    for scheme, kw in (("bf16", {}), ("int8 static", {"static_quant": str(CALIB_JSON)})):
        single = StereoEngine(scfg, params=trained, emit_confidence=True, **kw)
        meshed = StereoEngine(scfg, params=trained, emit_confidence=True, mesh=mesh, **kw)
        if meshed.mesh is None or meshed._tiles is not None:
            raise AssertionError("the (1, 1) mesh engine does not serve on its mesh")
        outs, counts = [], []
        for eng in (single, meshed):
            eng.warmup(buckets=[SCALE_BATCH])
            torch.cuda.synchronize()
            build.reset_launch_counts()
            with torch.inference_mode():
                o = [t.cpu() for t in eng.pipeline(batch)]
            torch.cuda.synchronize()
            outs.append(o)
            counts.append(dict(build.launch_counts))
        for name, a, b in zip(("disparity", "depth", "confidence", "flags"), *outs):
            if not torch.equal(a, b):
                raise AssertionError(f"(1, 1) mesh engine, {scheme}: {name} differs from "
                                     f"StereoEngine's (max |err| {float((a - b).abs().max())})")
        if counts[0] != counts[1] or any(counts[1].get(k, 0) <= 0 for k in BF16_PATH):
            raise AssertionError(f"(1, 1) mesh engine, {scheme}: launches {counts[1]}, "
                                 f"StereoEngine's {counts[0]}")
        # Streamed: the header, scatter and gather from the dispatch thread.
        build.reset_launch_counts()
        for i in range(SCALE_BATCH):
            meshed.feed(Frame(time.monotonic(), feed[i], H, 2 * W, index=i))
        meshed.start(warmup=False)
        meshed.drain(timeout=120.0)
        res = list(meshed.results(timeout=0.5))
        meshed.stop()
        streamed = dict(build.launch_counts)
        if sorted(r.index for r in res) != list(range(SCALE_BATCH)) or any(
                not np.array_equal(r.disparity, outs[0][0][r.index].numpy()) for r in res):
            raise AssertionError(f"(1, 1) mesh engine, {scheme}: streamed results differ")
        launches[scheme] = counts[1]
        phase(f"scale-out: (1, 1) NCCL mesh engine, flagship {scheme} at {W}x{H}, a batch of "
              f"{SCALE_BATCH}: disparity, depth, confidence and flags equal StereoEngine's bit "
              f"for bit, launches {counts[1]} (StereoEngine's {counts[0]}); streamed: "
              f"{len(res)} frames bit-equal, launches {streamed}")
        if scheme == "bf16":
            engines = {"StereoEngine": single, "mesh (1, 1)": meshed}
        else:
            meshed.close()
    t = time.monotonic()
    sharded = sharded_step_phase(dev, mesh, card)
    phase(f"scale-out: sharded train step on the (1, 1) mesh checked and timed "
          f"({time.monotonic() - t:.1f} s)")
    t = time.monotonic()
    cases = split_group_norm_cases(dev, ctx["census"])
    phase(f"scale-out: split GroupNorm checked at {len(cases)} shapes and their tiles "
          f"({time.monotonic() - t:.1f} s)")
    # The plain versions on a host thread while the two ranks finish.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as pool:
        plain = pool.submit(split_group_norm_plain, cases)
        logs = [proc.communicate(timeout=max(30.0, 420.0 - (time.monotonic() - t0)))[0]
                for proc in ranks]
        plain = plain.result()
    if any(p.returncode for p in ranks):
        raise AssertionError(f"two gloo ranks on one card: exits {[p.returncode for p in ranks]}; "
                             f"rank 0: {logs[0][-2500:]}; rank 1: {logs[1][-2500:]}")
    two = json.loads((ranks_dir / "out.json").read_text())
    tile_launches = two["launches"]
    missing = [k for k in TILE_PATH if tile_launches.get(k, 0) <= 0]
    if missing or tile_launches.get("group_norm"):
        raise AssertionError(f"tile = 2 path: kernels not launched {missing}; {tile_launches}")
    phase(f"scale-out: two gloo ranks on cuda:0, (1, 2) mesh bf16 engines of both networks on "
          f"the stored 720p scene x{SCALE_BATCH}: against the one-card engines "
          f"{two['tile2_vs_one_card']}; rank 0's launches in the two dispatches {tile_launches} "
          f"(seconds through the host {two['dispatch_s']}), its GroupNorm calls by shape "
          f"{two['group_norm_by_shape']}; the distributed BA on a (2, 1) mesh against one rank "
          f"{two['ba']} ({two['ba_s']:.2f} s); ranks done in {two['seconds']:.1f} s")
    train = two["train"]
    missing = [k for k in TILE_TRAIN_PATH if train["launches"].get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"sharded train step on two ranks: kernels not launched {missing}; "
                             f"{train['launches']}")
    for name, run in train["runs"].items():
        phase(f"scale-out: two gloo ranks, sharded train step {name}: step 1 against the stored "
              f"JAX step {run['vs_jax']}; ranks' parameters, moments and metrics bit-equal "
              f"after steps 1 and 2; seconds a step {run['step1_s']:.2f}, {run['step2_s']:.2f}; "
              f"rank 0's launches in step 1 {run['launches']}")
    phase(f"scale-out: two gloo ranks, sharded train steps done in {two['train_s']:.1f} s; rank "
          f"0's launches in the first steps {train['launches']}, by the tile's coarse shape "
          f"{train['by_shape']}, its GroupNorm calls by input shape "
          f"{train['group_norm_by_shape']}")
    # Timings, the card otherwise idle.
    sharded_step_timing(sharded, card, ctx["log"])
    rounds = fps_in_turns(engines, feed, SCALE_FRAMES, rounds=SCALE_ROUNDS)
    phase(f"scale-out: bf16 engines at batch {SCALE_BATCH}, host frames, in turns "
          f"({SCALE_ROUNDS} rounds of {SCALE_FRAMES}), frames/s: {rounds}; {card}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = split_group_norm_rows(cases, plain, flush, card, two["group_norm_by_shape"])
    for eng in engines.values():
        eng.close()
    distributed.shutdown()
    phase(f"scale-out: done in {time.monotonic() - t0:.1f} s")
    return rows, two["group_norm_by_shape"], dict(train, one_mesh=sharded)


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
    from concurrent.futures import ThreadPoolExecutor

    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.config import Config, PreprocessConfig
    from hobot_stereonet_tpu_torch.data.stream import DeviceFrameRing
    from hobot_stereonet_tpu_torch.models import FastStereoNet
    from hobot_stereonet_tpu_torch.models.layers import cast_convs
    from hobot_stereonet_tpu_torch.ops import preprocess as pp
    from hobot_stereonet_tpu_torch.ops.kernels import build
    from hobot_stereonet_tpu_torch.runtime.benchmark import measure_engine_fps
    from hobot_stereonet_tpu_torch.runtime.engine import Frame, StereoEngine
    from hobot_stereonet_tpu_torch.runtime.evaluate import evaluate_dataset
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params, random_flax_params
    from hobot_stereonet_tpu_torch.utils.profiling import device_trace

    # The held-out scenes render on a host thread while phases 2-6 run (the
    # dataset keeps them); the thread ends with its work, also on a failure.
    heldout = reference.heldout_dataset()
    renderer = ThreadPoolExecutor(max_workers=1)
    rendered = renderer.submit(lambda: [heldout[i] for i in range(len(heldout))])

    # 1. device ---------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True).stdout.strip()
    card = smi.splitlines()[0]
    clock_ghz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=10, check=True).stdout.split()[0]) / 1e3
    phase(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; largest SM "
          f"clock {clock_ghz:.3f} GHz; TF32 at PyTorch's defaults (cuDNN "
          f"{torch.backends.cudnn.allow_tf32}, matmul {torch.backends.cuda.matmul.allow_tf32})")
    print(card, flush=True)
    dev = torch.device("cuda:0")

    # 2. build ------------------------------------------------------------------
    exporting = artifact_exports()
    t = time.monotonic()
    build.library()
    phase(f"build: kernels ready in {time.monotonic() - t:.2f} s")
    report = kernel_report(build.BUILD_DIR / build.LIB_NAME,
                           (build.BUILD_DIR / "build.log").read_text())
    for fn, info in sorted(report.items()):
        phase(f"build: {fn}: {info}")
    def sass(prefix: str, op: str) -> int:
        return sum(info.get("sass", {}).get(op, 0) for fn, info in report.items()
                   if fn.startswith(prefix))

    hmma = sass("correlation_bf16_kernel", "HMMA")
    vec = sass("soft_argmin_vector_kernel", "LDG.128")
    # The backward on the tensor cores, fed by 16-byte cp.async; the D-leading
    # soft-argmin's vector instantiations' 8-byte loads (float32; bf16 loads 4
    # bytes, reported).
    bwd_hmma = sass("correlation_backward_mma_kernel", "HMMA")
    bwd_cp = sass("correlation_backward_mma_kernel", "LDGSTS.128")
    dlead_vec = {fn: {k: info.get("sass", {}).get(k, 0) for k in ("LDG", "LDG.64")}
                 for fn, info in report.items()
                 if fn.startswith("soft_argmin_dlead_vector_kernel")}
    phase(f"build: correlation_backward_mma_kernel HMMA {bwd_hmma}, LDGSTS.128 {bwd_cp}; "
          f"soft_argmin_dlead_vector_kernel loads by instantiation {dlead_vec}")
    if min(bwd_hmma, bwd_cp) <= 0:
        raise AssertionError("expected HMMA and LDGSTS.128 (16-byte cp.async) in "
                             f"correlation_backward_mma_kernel: {bwd_hmma}, {bwd_cp}")
    # The soft-argmin backward's staged route: every instantiation stages its
    # tile with 16-byte cp.async and stores it with 16-byte stores.
    staged = {fn: {k: info.get("sass", {}).get(k, 0) for k in ("LDGSTS.128", "STG.128", "SHFL")}
              for fn, info in report.items()
              if fn.startswith("soft_argmin_backward_staged_kernel")}
    phase(f"build: soft_argmin_backward_staged_kernel 16-byte copies in, 16-byte stores out, "
          f"shuffles, by instantiation: {staged}")
    if len(staged) != 32 or min(min(v["LDGSTS.128"], v["STG.128"]) for v in staged.values()) <= 0:
        raise AssertionError("expected LDGSTS.128 and STG.128 in each of the 32 instantiations "
                             f"of soft_argmin_backward_staged_kernel: {staged}")
    igmma = min(sass(k, "IGMMA") for k in ("int8_conv_wgmma_kernel", "int8_conv_dense_kernel"))
    # Each instantiation of the TMA kernel, the 8-row tiles of the dilated
    # and 3-D convs included, issues wgmma and TMA loads.
    wgmma_fns = {fn: (info.get("sass", {}).get("IGMMA", 0), info.get("sass", {}).get("UTMALDG", 0))
                 for fn, info in report.items() if fn.startswith("int8_conv_wgmma_kernel<")}
    tall = sorted(fn for fn in wgmma_fns if fn.endswith(",2>"))
    tma = min(min(v) for v in wgmma_fns.values()) if len(tall) == 3 else 0
    phase(f"build: int8_conv_wgmma_kernel instantiations (IGMMA, UTMALDG): {wgmma_fns}")
    ingest_st = sass("nv12_ingest_kernel", "STG.128")
    gn_shfl = sass("group_norm_scan_kernel", "SHFL")
    gn_bulk = sass("group_norm_walk_kernel", "UBLKCP")
    if min(hmma, vec, igmma, tma, ingest_st, gn_shfl, gn_bulk) <= 0:
        raise AssertionError(f"expected HMMA in correlation_bf16_kernel ({hmma}), 128-bit "
                             f"loads in soft_argmin_vector_kernel ({vec}), IGMMA (warpgroup "
                             f"int8 MMA) in both int8 conv kernels ({igmma}), IGMMA and UTMALDG "
                             f"(TMA loads) in each int8_conv_wgmma_kernel, three with 8-row "
                             f"tiles ({wgmma_fns}), 128-bit stores in "
                             f"nv12_ingest_kernel ({ingest_st}), SHFL (warp shuffles: the "
                             f"scan's combines) in group_norm_scan_kernel ({gn_shfl}) and "
                             f"UBLKCP (bulk copies) in group_norm_walk_kernel ({gn_bulk})")

    # Phase 14's exports (started beside the build) end before anything is timed.
    t = time.monotonic()
    exports = {name: (path, finish_cli(f"export {name}", proc, timeout=600.0))
               for name, (path, proc) in exporting.items()}
    phase(f"artifact: both exports done, {time.monotonic() - t:.1f} s after the build")

    # 3. kernels vs plain, at each batch -----------------------------------------
    rng = np.random.default_rng(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    cfg = Config.from_json(str(ROOT / "checkpoints" / "flagship" / "config.json"))
    k = cfg.model.cost_resolution_divisor
    h, w = H // k, W // k
    c, d = cfg.model.feature_channels, cfg.model.num_disparities_coarse
    rows = []
    floor = median_ms(lambda: torch.cuda._sleep(0), flush)
    phase(f"kernels: timing floor, an empty kernel by the same method: {floor:.4f} ms; {card}")
    for b in BATCHES:
        rows += kernel_phase(b, rng, flush, dev, h, w, c, d, float(k), card)
    for b in BATCHES:
        rows += int8_kernel_phase(b, rng, flush, dev, cfg, card)
    int8_host_time(dev, cfg, card)
    t = time.monotonic()
    census = groupnorm_census(dev)
    gn_per_forward = {net: sum(v.get(net, 0) for v in census.values())
                      for net in ("fast", "classic")}
    phase(f"groupnorm: the GroupNorm inputs at {W}x{H}, batch 1 (samples, channels, spatial): "
          f"GroupNorms a forward {census}; in all {gn_per_forward}")
    gn_rows = group_norm_phase(dev, census, flush, card, torch.bfloat16)
    rows += gn_rows
    phase(f"groupnorm: {len(gn_rows)} bf16 shapes, batches and forms exact and timed (float32 "
          f"in phase 13) ({time.monotonic() - t:.1f} s)")
    del flush
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
    gn_shapes: dict = {}          # GroupNorm calls by shape on the serving paths
    build.reset_launch_counts()
    t = time.monotonic()
    with group_norm_shapes(eng.model, gn_shapes):
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
    missing = [n for n in BF16_PATH if launches.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}; {launches}")
    if (launches["group_norm"] != gn_per_forward["fast"]
            or sum(gn_shapes.values()) != launches["group_norm"]):
        raise AssertionError(f"{launches['group_norm']} GroupNorm launches for one batch, "
                             f"expected {gn_per_forward['fast']}; by shape {gn_shapes}")
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

    del eng, results, ref, feed

    # 6. trained weights --------------------------------------------------------
    t = time.monotonic()
    trained = reference.load_params()
    stored = reference.load_outputs()
    scenes = [heldout[i] for i in reference.SCENES]
    yuv = PreprocessConfig(color_space="yuv")

    def trained_net(dtype, device):
        mcfg = dataclasses.replace(cfg.model, compute_dtype=dtype)
        m = FastStereoNet(mcfg, device=device)
        m.load_state_dict(from_flax_params(trained, mcfg))
        return cast_convs(m, dtype).eval()

    def run_scenes(net, device):
        x = torch.cat([pp.rgb_pair_to_model_input(s.left, s.right, yuv, device) for s in scenes])
        with torch.inference_mode():
            o = net(*pp.split_model_input(x))
        return o["disparity"].cpu().numpy(), o["confidence"].cpu().numpy()

    d32, c32 = run_scenes(trained_net(torch.float32, dev), dev)
    f32_err = float(np.abs(d32 - stored["f32_disparity"]).max())
    f32_conf = float(np.abs(c32 - stored["f32_confidence"]).max())
    if not (f32_err <= 1e-3 and f32_conf <= 1e-4):
        raise AssertionError(f"trained f32 network vs JAX: disparity max |err| {f32_err} px "
                             f"(limit 1e-3), confidence {f32_conf} (limit 1e-4)")
    phase(f"trained: float32 network on the card vs JAX on 2 held-out scenes at 256x512: "
          f"disparity max |err| {f32_err:.3g} px (limit 1e-3), confidence {f32_conf:.3g} "
          f"(limit 1e-4); reference made with XLA_FLAGS={stored['xla_flags']}")
    net16 = trained_net(torch.bfloat16, dev)
    d16, c16 = run_scenes(net16, dev)
    st = px_stats(d16, stored["bf16_disparity"])
    check_bf16("trained bf16 scenes", st)
    phase(f"trained: bf16 network on the card vs JAX on the 2 scenes: {st}; "
          f"confidence max |err| {float(np.abs(c16 - stored['bf16_confidence']).max()):.3g}")
    dcpu, _ = run_scenes(trained_net(torch.bfloat16, "cpu"), "cpu")
    phase(f"trained: bf16 network on the card vs the port on the CPU, same scenes: "
          f"{px_stats(d16, dcpu)}")
    frame = torch.from_numpy(reference.frame_720p())[None].to(dev)
    with torch.inference_mode():
        x = pp.nv12_ingest(frame, H, 2 * W, yuv)
        d720 = net16(*pp.split_model_input(x))["disparity"][0].cpu().numpy()
    st = px_stats(d720, stored["bf16_720p_disparity"])
    check_bf16("trained bf16 720p", st)
    phase(f"trained: bf16 network on the card vs JAX on the 720p frame: {st} "
          f"({time.monotonic() - t:.1f} s)")

    # TF32 as the network reads it: off in a float32 engine's forward, left
    # at PyTorch's default in the bf16 one's.
    tf32 = {}
    for dtype in (torch.float32, torch.bfloat16):
        e = StereoEngine(dataclasses.replace(cfg, preprocess=yuv, model=dataclasses.replace(
            cfg.model, compute_dtype=dtype)), params=trained)
        hook = e.model.FeatureTower_0.ConvBlock_0.Conv_0.register_forward_pre_hook(
            record_tf32(tf32, dtype))
        with torch.inference_mode():
            e.pipeline(frame)
        hook.remove()
        del e
    outside = tf32_flags()
    phase(f"trained: TF32 (cuDNN, matmul) inside the network of a StereoEngine: float32 "
          f"{tf32[torch.float32]}, bf16 {tf32[torch.bfloat16]}; outside {outside}")
    if tf32[torch.float32] != (False, False) or tf32[torch.bfloat16] != outside:
        raise AssertionError(f"TF32 inside the engines' networks: {tf32}, outside {outside}")

    # 7. held-out accuracy ------------------------------------------------------
    t = time.monotonic()
    rendered.result()
    phase(f"accuracy: {len(heldout)} held-out scenes rendered on a host thread")
    eval_cfg = dataclasses.replace(cfg, preprocess=yuv)
    res, eval_launches = on_path(
        BF16_PATH[1:],
        lambda: evaluate_dataset(None, trained, heldout, eval_cfg, device=dev))
    jax_epe = stored["heldout_epe"]
    delta = np.asarray(res.per_frame_epe) - jax_epe
    ci = 1.96 * delta.std(ddof=1) / np.sqrt(len(delta))
    lo, hi = (reference.HELDOUT_EPE_PX - reference.HELDOUT_EPE_CI95_PX,
              reference.HELDOUT_EPE_PX + reference.HELDOUT_EPE_CI95_PX)
    phase(f"accuracy: bf16 on the card over {res.n_frames} held-out scenes: EPE {res.epe:.4f} px "
          f"(must lie in [{lo:.4f}, {hi:.4f}]), D1 {res.d1_all:.4f}; paired per-scene "
          f"EPE - JAX's: mean {delta.mean():+.4f} +- {ci:.4f} px (95 %), max |.| "
          f"{np.abs(delta).max():.4f} (JAX mean {jax_epe.mean():.4f}, D1 "
          f"{float(stored['heldout_d1']):.4f}); launches {eval_launches} "
          f"({time.monotonic() - t:.1f} s)")
    if not lo <= res.epe <= hi:
        raise AssertionError(f"held-out EPE {res.epe} outside [{lo}, {hi}]")

    # 8. engine, benchmark surface ----------------------------------------------
    path = list(BF16_PATH)
    for stage_timing in (False, True):
        for b, nb in BENCH_BATCHES.items():
            t = time.monotonic()
            out, counts = on_path(path, lambda: measure_engine_fps(
                params=trained, model_cfg=cfg.model, preprocess_cfg=yuv, batch=b,
                n_batches=nb, stage_timing=stage_timing, ring_size=2, height=H, width=W))
            phase(f"bench: measure_engine_fps batch {b}, stage_timing={stage_timing}: {out}; "
                  f"launches {counts}; {card} ({time.monotonic() - t:.1f} s)")

    t = time.monotonic()
    ring = DeviceFrameRing(height=H, width=W, ring_size=4, seed=1, device=dev)
    ecfg = dataclasses.replace(cfg, preprocess=yuv, engine=dataclasses.replace(
        cfg.engine, fetch_results=False, drop_on_full=False))
    eng = StereoEngine(ecfg, params=trained, emit_confidence=True)
    eng.warmup(buckets=[N_FRAMES], ring=ring)

    def serve_ring():
        for f in ring.frames(N_FRAMES):
            eng.feed(f)
        eng.start(warmup=False)
        eng.drain(timeout=120.0)
        out = list(eng.results(timeout=0.5))
        eng.stop()
        return out

    results, ring_launches = on_path(path, serve_ring)
    slots = [i % ring.data.shape[0] for i in range(N_FRAMES)]
    with torch.inference_mode():
        want = eng.pipeline(ring.data[slots])
    for r in results:
        for name, got, w in (("disparity", r.disparity, want[0]),
                             ("confidence", r.confidence, want[2])):
            if not np.array_equal(np.asarray(got), w[r.index].cpu().numpy()):
                raise AssertionError(f"frame {r.index}: ring-fed {name} differs from the "
                                     "synchronous pipeline")
    if len(results) != N_FRAMES or eng.metrics.dispatch_batch.n != 1 or eng.metrics.nan_dropped:
        raise AssertionError(f"ring-fed run: {len(results)} results, "
                             f"{eng.metrics.dispatch_batch.summary()}")
    phase(f"engine: ring-fed, fetch_results=False: all {N_FRAMES} results equal the synchronous "
          f"pipeline's bit for bit; launches {ring_launches}")
    mb = StereoEngine(dataclasses.replace(ecfg, engine=dataclasses.replace(
        ecfg.engine, device_microbatch=8)), params=trained)
    with torch.inference_mode():
        chunked = mb.pipeline(ring.data[slots])[0]
        single = eng.pipeline(ring.data[slots[:1]])[0]
    torch.cuda.synchronize()
    whole = want[0]
    micro = (float((chunked == whole).float().mean()), float((chunked - whole).abs().max()))
    pad = px_stats(single[0].cpu().numpy(), whole[0].cpu().numpy())
    pad["bit_equal"] = float((single[0] == whole[0]).float().mean())
    phase(f"engine: device_microbatch=8 vs the whole batch of {N_FRAMES}: bit-equal share "
          f"{micro[0]:.6f}, max |diff| {micro[1]:.4g} px (limit {MICROBATCH_MAX_PX}); frame 0 "
          f"alone (a batch of 1) vs in the batch of {N_FRAMES}: {pad} "
          f"({time.monotonic() - t:.1f} s)")
    if micro[1] > MICROBATCH_MAX_PX:
        raise AssertionError(f"device_microbatch=8 differs from the whole batch by {micro[1]} px")
    check_bf16("a frame in a batch of 1 vs in a batch of 32", pad)

    # 9. profile ----------------------------------------------------------------
    t = time.monotonic()
    log = ROOT / "build" / "profile"
    for b in (1, N_FRAMES):
        with device_trace(str(log / f"batch{b}")) as prof:
            _, event = eng._launch((ring, slots[:b]))
            eng._wait(event)
        busy, total, top = profile_summary(prof)
        if not top:
            phase("profile: torch.profiler's key_averages() show no device time on this machine")
            break
        elementwise_calls(prof, f"flagship bf16 batch {b}")
        phase(f"profile: one ring-fed batch of {b} at {W}x{H}, dispatch to completion: device "
              f"busy {100 * busy:.1f} % of the traced window, {total:.3f} ms of device time; "
              f"the largest kernels and copies: {card}")
        for name, ms, calls in top:
            phase(f"profile:   {ms:9.3f} ms  {calls:5d} calls  {name[:110]}")
    phase(f"profile: traces in {log} ({time.monotonic() - t:.1f} s)")
    renderer.shutdown(wait=True)

    # 10. int8 and RGB ------------------------------------------------------------
    path_launches = int8_and_rgb_phase(dict(
        dev=dev, cfg=cfg, yuv=yuv, trained=trained, heldout=heldout, eval_cfg=eval_cfg,
        ring=ring, slots=slots, ecfg=ecfg, bf16_engine=eng, rng=rng, card=card, log=log))
    path_launches[("nv12_ingest", "yuv")] = launches["nv12_ingest"]
    path_launches[("group_norm", "fast")] = launches["group_norm"]
    for name in ("correlation", "soft_argmin"):
        path_launches[(name, None)] = launches[name]

    # 11. the CLASSIC StereoNet -------------------------------------------------
    classic_rows, classic_launches = classic_phase(dict(
        dev=dev, card=card, rng=rng, heldout=heldout, log=log, gn_shapes=gn_shapes))
    path_launches[("soft_argmin_cost", None)] = classic_launches["soft_argmin_cost"]
    path_launches[("group_norm", "classic")] = classic_launches["group_norm"]
    if (classic_launches["group_norm"] != gn_per_forward["classic"] * N_FRAMES // 8
            or sum(gn_shapes.values()) != launches["group_norm"] + classic_launches["group_norm"]):
        raise AssertionError(f"CLASSIC engine: {classic_launches['group_norm']} GroupNorm "
                             f"launches for {N_FRAMES // 8} chunks of 8; by shape {gn_shapes}")
    phase(f"groupnorm: launches by shape on the serving paths of phases 5 and 11: {gn_shapes}")
    rows += classic_rows

    # 11b. CLASSIC in int8 ----------------------------------------------------------
    c8_rows, epi_rows, c8_launches, library_calls, c8_calls = classic_int8_phase(
        dict(dev=dev, card=card, rng=rng, heldout=heldout))
    path_launches.update(c8_launches)
    path_launches.setdefault(("int8_epilogue", "classic static"), 0)   # on no serving path
    src8 = dict(name="int8_conv", route="cuda",
                source="hobot_stereonet_tpu_torch/csrc/int8_conv.cu",
                replaces="hobot_stereonet_tpu/ops/quant.py:92 (XLA s8 conv, not Pallas)")
    src_epi = dict(name="int8_epilogue", route="cuda",
                   source="hobot_stereonet_tpu_torch/csrc/int8_epilogue.cu",
                   replaces="hobot_stereonet_tpu/ops/quant.py:103-105 (the dequant of XLA's s8 "
                            "conv, not Pallas)")
    rows += [dict(r, scheme="classic static", **src8) for r in c8_rows]
    rows += [dict(r, scheme="classic static", **src_epi) for r in epi_rows]

    # 12. training ------------------------------------------------------------------
    train_rows, train_launches = training_phase(dict(dev=dev, card=card, rng=rng, cfg=cfg,
                                                     log=log, gn_per_forward=gn_per_forward))
    rows += train_rows
    path_launches.update(train_launches)

    # 13. the command line ---------------------------------------------------------
    ctx = dict(dev=dev, cfg=cfg, trained=trained, heldout=heldout, card=card, exports=exports,
               census=census, log=log)
    cli_phase(ctx)

    # 14. the compiled artifact ---------------------------------------------------------
    artifact_phase(ctx)

    # 15. SLAM ------------------------------------------------------------------------------
    slam_phase(ctx)

    # 16. scale-out on one card -----------------------------------------------------------
    scale_rows, tile_calls, train = scale_out_phase(ctx)
    rows += scale_rows

    def sharded_launches(r):
        """Rank 0's launches on the two ranks' sharded train steps: the split
        GroupNorm entries' by input shape (one each a call), the backward
        kernels' by the tile's coarse shape."""
        if r["name"] in ("group_norm_stats", "group_norm_apply"):
            return train["group_norm_by_shape"]
        return {k.split(" ", 1)[1]: c for k, c in train["by_shape"].items()
                if k.split(" ", 1)[0] == r["name"]} or None

    def row_launches(r):
        if "key" in r:                            # a GroupNorm shape and form: its launches
            return gn_shapes.get(r["key"], 0)
        if "tile_key" in r:                       # a split entry at a tile's shape (tile = 2)
            return tile_calls.get(r["tile_key"], 0)
        if "launch_key" in r:                     # a CLASSIC int8 shape (static engine)
            return c8_calls["static"].get(r["launch_key"], 0)
        return path_launches[(r["name"], r.get("mode") or r.get("scheme"))]

    print(json.dumps({"kernels": [dict(
        name=r["name"], **{k: r[k] for k in ("mode", "shape", "scheme", "convs", "per_forward",
                                             "cotangents") if k in r},
        route=r["route"], source=r["source"], replaces=r["replaces"],
        batch=r["batch"], launches=row_launches(r), max_abs_err=r["max_abs_err"], ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound"][0], bound_by=r["bound"][1],
        library_ms=r["library_ms"],
        **{k: r[k] for k in ("cudnn_bf16_ms", "unfused_ms", "other_mode_ms", "tile_rows", "plan")
           if k in r},
        **({"route_launches": ROUTE_LAUNCHES[r["name"]]} if r["name"] in ROUTE_LAUNCHES else {}),
        **({"sharded_step_launches": sharded_launches(r)} if r["name"] in (
            "group_norm_stats", "group_norm_apply", "correlation_bwd", "soft_argmin_bwd",
            "soft_argmin_cost_bwd") else {}))
        for r in rows], "library": dict(
            name="int8_conv_im2col",
            route="library: im2col + torch._int_mm, then the int8_epilogue kernel (not a kernel;"
                  " the yardstick of the 3-D and dilated int8 convs' library_ms)",
            source="hobot_stereonet_tpu_torch/ops/int8_gemm.py", calls=library_calls)}),
          flush=True)
    phase(f"done in {time.monotonic() - T0:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
