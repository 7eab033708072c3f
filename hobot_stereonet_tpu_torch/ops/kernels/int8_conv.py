"""w8a8 convolution: s8 x s8 -> s32 implicit GEMM with the dequant epilogue.

The JAX package computes each int8 conv as an XLA convolution with an int32
result (``hobot_stereonet_tpu/ops/quant.py``, ``_int8_conv`` and
``_int8_conv_static``); PyTorch has no such conv (``F.conv2d`` on int8
tensors returns int8 and wraps), so the port writes it by hand:
``csrc/int8_conv.cu``.  :func:`int8_conv_plain` is the same function in
plain PyTorch.

The function, for an input ``x`` [N, Cin, H, W] or [N, Cin, D, H, W]
(float32 or bfloat16, channels-last memory) and int8 weights ``q_w``
[Cout, Cin, kh, kw] or [Cout, Cin, kd, kh, kw]:

    q   = clip(rint(x / qs[n]), -127, 127)      (divide; dynamic scales)
        = clip(rint(x * qs), -127, 127)         (static: qs = float32(1/s_x))
    acc = conv(q, q_w), flax "SAME" zero padding, any dilation, int32
    y   = fma(float(acc), sx[n] * s_k[c], bias[c]), rounded once to out_dtype

``sx`` and ``qs`` hold one value per sample or one for all.  The static
scheme multiplies by the reciprocal and the epilogue fuses its multiply
and add, because that is what XLA compiles the JAX code into
(``numerics.py``).

The kernel's launch plan (:func:`plan`: the slice of output channels a
block keeps resident, the output tile, the rings of input stages and the
shared-memory layout) and its weight layout (:func:`pack_weight`) are
chosen here; ``csrc/int8_conv.cu`` reads them from :class:`PlanArgs`.  The
kernel sizes its grid from the blocks the card keeps resident.  A dilated
conv reads a wider halo and looks its taps up ``dilation`` pixels apart; a
3-D conv loads the ``kd`` input planes around each output plane into one
stage and runs ``kd * kh * kw`` taps from it.

NaN: the kernel's code for a NaN input is -127, as for -inf (``fmaxf``
clips it); the plain version carries NaN through ``torch.clamp`` into every
output its window reaches.  Everything else is bit-equal.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from . import build
from .numerics import fma_f32

NAME = "int8_conv"
EPILOGUE_NAME = "int8_epilogue"   # the library route's epilogue (csrc/int8_epilogue.cu)
QMAX = 127.0
_IN_DTYPES = (torch.float32, torch.bfloat16)

SMEM_MAX = 232448             # shared memory one block may use on Hopper (227 KB)
SMEM_SM = 233472              # shared memory of one SM (228 KB); 1 KB reserved per block
TILE_ROWS, TILE_COLS = 4, 16  # one wgmma tile: 4 rows x 16 columns (M = 64); the dense
                              # path's warpgroup takes two (8 rows) for up to 32 channels
CONSUMER_WARPS = 8            # two warpgroups a block on the TMA path, one on the dense path
PITCH = 48                    # bytes per pixel of the int8 tile (32 channels + 16 of padding)
MAX_STAGES = 3                # input stages of a ring, at most (more measured no faster)
N_SINGLE = (8, 16, 24, 32, 48, 64)   # wgmma N of a slice of at most 64 channels
N_WIDE = 64                   # wgmma N of each instruction of a wider slice
N_MAX = 192                   # widest slice of output channels resident in a block
EPI_CHANNELS = 64             # channels of one epilogue pass through shared memory
PLAN_VERSION = 3              # struct PlanArgs of csrc/int8_conv.cu checks it
DENSE_CIN = (3, 4)            # Cin the dense path is routed at (bit-equal on the card at each)
MAX_DILATION = 8              # the widest dilation the kernel is routed at (CLASSIC's)
TALL_BN = (8, 16, 32)         # slices the TMA path is built for with two wgmma tiles a warp
MAX_PIXELS = 64 * 32          # halo pixels of a stage: the quantizer's per-thread mask holds 64
BOX_MAX = 256                 # a TMA box's extent along one axis


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1):
    """flax/XLA "SAME" padding (low, high) along one axis, for ``kernel``
    taps ``dilation`` apart (an extent of ``(kernel - 1) * dilation + 1``)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def output_slices(cout: int):
    """(BN, slices): the output channels a block keeps resident (the wgmma
    N, or a multiple of :data:`N_WIDE` for a wider slice) and how many
    slices of BN cover ``cout``; rows past ``cout`` hold zero weights."""
    if cout <= N_SINGLE[-1]:
        return next(n for n in N_SINGLE if n >= cout), 1
    slices = -(-cout // N_MAX)
    return _up(-(-cout // slices), N_WIDE), slices


def dense_input(cin: int) -> bool:
    """Whether the conv takes the dense path (the first conv, Cin = 3):
    taps packed 4 channels a pixel instead of 32-channel slices."""
    return cin % 8 != 0


def channels_per_tap(cin: int) -> int:
    """Channels of one tap in the reduction: ``Cin`` rounded up to 32
    (32-channel slices, one wgmma's depth) or, on the dense path, to 4
    (one 32-bit register of an A fragment holds one tap of a pixel)."""
    return _up(cin, 4 if dense_input(cin) else 32)


def pack_weight(q_w: torch.Tensor) -> torch.Tensor:
    """int8 [Cout, Cin, kh, kw] or [Cout, Cin, kd, kh, kw] -> the kernel's
    weight layout.

    The reduction index of a row is k = tap * channels_per_tap(Cin) +
    channel (taps in (kd, kh, kw) order), zero padded to K_pad, a multiple of
    32.  Rows are padded with zeros to ``slices * BN``
    (:func:`output_slices`).  The result is
    [slices, K_pad / 32, BN / 8, 2, 8, 16]: for each slice of BN output
    channels and each step of 32 along k, the wgmma core matrices of the
    K-major B operand without swizzle (8 rows of 16 bytes, 128 bytes
    each); the two 16-byte halves of k lie 128 bytes apart (the
    descriptor's leading byte offset) and groups of 8 rows 256 bytes apart
    (its stride byte offset).  A slice is one contiguous block that a
    bulk copy places in shared memory as it is.
    """
    cout, cin = q_w.shape[:2]
    cpt = channels_per_tap(cin)
    bn, slices = output_slices(cout)
    w = F.pad(q_w.permute(0, *range(2, q_w.dim()), 1), (0, cpt - cin)).reshape(cout, -1)
    k_pad = _up(w.shape[1], 32)
    w = F.pad(w, (0, k_pad - w.shape[1], 0, slices * bn - cout))
    return w.reshape(slices, bn // 8, 8, k_pad // 32, 2, 16).permute(0, 3, 1, 4, 2, 5).contiguous()


def packed_shape(cout: int, cin: int, *kernel: int):
    bn, slices = output_slices(cout)
    return (slices, _up(math.prod(kernel) * channels_per_tap(cin), 32) // 32, bn // 8, 2, 8, 16)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel runs one conv shape (all sizes in bytes or elements).

    Each block keeps one slice of BN output channels resident (its weights,
    ``w_bytes``, copied once) and walks output tiles of ``th`` x ``tw``
    pixels with a static stride; the kernel launches as many blocks per
    slice as the card keeps resident, at most ``tiles``.  For each tile it
    loads the input halo (``ih`` x ``iw`` pixels) into a ring of ``stages``
    stages: by TMA, ``bc`` channels at a time, into the ring of the consumer
    warpgroup that takes the tile (``rings`` = 2: each warpgroup waits on
    every phase of its own ring's barriers, in order), or on the dense path
    by 16-byte copies along each halo row (``row_bytes``; one ring).  It
    quantizes a stage into an int8 tile (``ih`` x ``aw`` pixels of
    ``aq_pitch`` bytes, columns grouped by their remainder modulo the
    stride, ``iwh`` to a group; two tiles: one for each of the TMA path's
    warpgroups, or used in turn on the dense path) and runs the wgmma steps
    from it.  The
    slice's ``s_k`` and bias (at ``off_par``) and each tap's (or, on the
    dense path, each k-step lane's) offset into the int8 tile (at
    ``off_tab``) are staged in shared memory once per block.

    On the TMA path a tile is ``th`` = 4 or 8 rows (one or two wgmma tiles
    of 64 pixels a warpgroup, :func:`tile_rows`).  A dilated conv
    (``dil`` > 1) reads an ``ih`` x ``iw`` halo of ``(th - 1) * stride +
    (KS - 1) * dil + 1`` rows and columns and finds tap (r, s) at row
    ``r * dil``, column ``s * dil``.  A 3-D conv walks the tiles of each
    of the ``D`` planes of each sample (``tiles`` = N * D * tiles_h *
    tiles_w) and loads the ``KD`` planes from ``d - pad_f`` into one stage
    (a 5-D TMA box, zero past the depth edges), so a stage and its int8
    tile hold ``KD * ih`` rows and a tap (kd, r, s) lies at row ``kd * ih
    + r``.  A 2-D conv has ``D`` = ``KD`` = 1.
    """
    N: int
    H: int
    W: int
    Cin: int
    Ho: int
    Wo: int
    Cout: int
    KS: int
    stride: int
    pad_t: int
    pad_l: int
    x_bf16: int
    y_bf16: int
    dense: int
    bn: int
    n_slices: int
    cpt: int
    slices: int
    k_blocks: int
    taps: int
    th: int
    tw: int
    ih: int
    iw: int
    iwh: int
    aw: int
    bc: int
    rings: int
    stages: int
    stage_bytes: int
    row_bytes: int
    aq_pitch: int
    aq_bytes: int
    epi_pitch: int
    w_bytes: int
    off_stage: int
    off_aq: int
    off_epi: int
    off_par: int
    off_tab: int
    off_bar: int
    smem: int
    tiles_h: int
    tiles_w: int
    tiles: int
    dil: int
    D: int
    KD: int
    pad_f: int

    def args(self) -> "PlanArgs":
        return PlanArgs(PLAN_VERSION, ctypes.sizeof(PlanArgs), *dataclasses.astuple(self))


class PlanArgs(ctypes.Structure):
    """The plan as ``csrc/int8_conv.cu`` reads it: ``struct PlanArgs``, a
    version and the struct's size (which the C entry checks), then the
    fields of :class:`Plan` in the same order, all int32."""
    _fields_ = [("version", ctypes.c_int), ("size", ctypes.c_int)] + [
        (f.name, ctypes.c_int) for f in dataclasses.fields(Plan)]


def tile_rows(dense: bool, bn: int, dilation: int, depth: int) -> int:
    """The output rows of a tile: on the dense path two wgmma tiles of 4
    rows for slices of up to 32 channels; on the TMA path one, except for
    the dilated convs at the slices :data:`TALL_BN`, which take two so
    that their wider halo is read for twice the rows."""
    if dense:
        return TILE_ROWS * (2 if bn <= 32 else 1)
    return TILE_ROWS * (2 if dilation > 1 and bn in TALL_BN else 1)


@functools.lru_cache(maxsize=256)
def plan(n: int, cin: int, h: int, w: int, cout: int, k: int, stride: int,
         x_dtype: torch.dtype, out_dtype: torch.dtype, dilation: int = 1, depth: int = 0,
         rows: "int | None" = None) -> Plan:
    """The launch plan of one conv shape: a 2-D conv of a k x k kernel
    (``depth`` = 0) or a 3-D conv of a k x k x k kernel over ``depth``
    input planes; ``rows`` sets the tile's height (default
    :func:`tile_rows`; 4 or, at :data:`TALL_BN`, 8 on the TMA path).

    Raises ``ValueError`` for a shape the kernel does not run: dilation or
    3-D taps other than at stride 1 on the TMA path, a halo wider than a
    TMA box or the quantizer's mask, or rings that do not fit in
    :data:`SMEM_MAX`.
    """
    xb = 2 if x_dtype == torch.bfloat16 else 4
    yb = 2 if out_dtype == torch.bfloat16 else 4
    ho, wo = -(-h // stride), -(-w // stride)
    dense = dense_input(cin)
    shape = (f"Cin {cin}, Cout {cout}, {k}x{k}{f'x{k}' if depth else ''} stride {stride} "
             f"dilation {dilation}, {x_dtype}")
    if (dilation > 1 or depth) and (dense or stride != 1):
        raise ValueError(f"{NAME}: dilated and 3-D convs run at stride 1 with Cin a multiple "
                         f"of 8 only, got {shape}")
    cpt = channels_per_tap(cin)
    kd = k if depth else 1
    taps = kd * k * k
    k_blocks = _up(taps * cpt, 32) // 32
    bn, n_slices = output_slices(cout)
    th, tw = rows or tile_rows(dense, bn, dilation, depth), TILE_COLS
    built = {tile_rows(dense, bn, 1, 0)} | ({2 * TILE_ROWS} if not dense and bn in TALL_BN else set())
    if th not in built:
        raise ValueError(f"{NAME}: no tile of {th} rows for {shape}")
    ih, iw = (th - 1) * stride + (k - 1) * dilation + 1, (tw - 1) * stride + (k - 1) * dilation + 1
    if not dense and (max(ih, iw) > BOX_MAX or kd * ih * iw > MAX_PIXELS):
        raise ValueError(f"{NAME}: a halo of {kd} x {ih} x {iw} pixels is too large for {shape}")
    iwh = -(-iw // stride)
    aw = stride * iwh
    if dense:
        bc, slices, aq_pitch, rings = 0, 1, cpt, 1
        row_bytes = _up(iw * cin * xb, 16) + 16     # a row's span, aligned down to 16 bytes
    else:
        bc, slices, aq_pitch, rings = min(32, cin), cpt // 32, PITCH, 2
        row_bytes = iw * bc * xb
    stage_bytes = _up(kd * ih * row_bytes, 128)
    aq_bytes = _up(kd * ih * aw * aq_pitch, 128)
    epi_pitch = min(bn, EPI_CHANNELS) * yb + 16
    w_bytes = k_blocks * bn * 32
    off_stage = _up(w_bytes, 128)
    n_tab = 8 * k_blocks if dense else taps      # A-fragment offsets: per k-step unit or per tap
    warps = CONSUMER_WARPS // 2 if dense else CONSUMER_WARPS
    tail = warps * 16 * epi_pitch + 8 * bn + 4 * n_tab + 8 + 8 * (2 * rings * MAX_STAGES + 1)
    fixed = off_stage + 2 * aq_bytes + tail
    # As many stages as fit beside the blocks per SM the kernel is built for
    # (two for slices of up to 64 channels, one for wider ones; eight of the
    # dense path's smaller blocks), or else one block an SM: a block whose
    # rings hold one stage in all cannot load ahead.
    per_sm = 8 if dense else 2 if bn <= 64 else 1
    stages = min(MAX_STAGES, (min(SMEM_MAX, SMEM_SM // per_sm - 1024) - fixed)
                 // (rings * stage_bytes))
    if rings * stages < 2:
        stages = min(MAX_STAGES, (SMEM_MAX - fixed) // (rings * stage_bytes))
    if stages < 1:
        raise ValueError(f"{NAME}: no plan fits {SMEM_MAX} bytes of shared memory for {shape}")
    off_aq = off_stage + rings * stages * stage_bytes
    off_epi = off_aq + 2 * aq_bytes
    off_par = off_epi + warps * 16 * epi_pitch      # the slice's s_k, then its bias
    off_tab = off_par + 8 * bn
    off_bar = _up(off_tab + 4 * n_tab, 8)
    smem = off_bar + 8 * (2 * rings * stages + 1)
    tiles_h, tiles_w = -(-ho // th), -(-wo // tw)
    pt, pl = same_pads(h, k, stride, dilation)[0], same_pads(w, k, stride, dilation)[0]
    pf = same_pads(depth, k, stride)[0] if depth else 0
    return Plan(n, h, w, cin, ho, wo, cout, k, stride, pt, pl, int(xb == 2), int(yb == 2),
                int(dense), bn, n_slices, cpt, slices, k_blocks, taps, th, tw, ih, iw, iwh, aw,
                bc, rings, stages, stage_bytes, row_bytes, aq_pitch, aq_bytes, epi_pitch,
                w_bytes, off_stage, off_aq, off_epi, off_par, off_tab, off_bar, smem, tiles_h,
                tiles_w, n * max(depth, 1) * tiles_h * tiles_w, dilation, max(depth, 1), kd, pf)


@functools.lru_cache(maxsize=256)
def _plan_args(*key) -> PlanArgs:
    return plan(*key).args()


def _check(x, q_w, s_k, bias, sx, qs, out_dtype) -> None:
    if x.dim() not in (4, 5) or q_w.dim() != x.dim() or x.shape[1] != q_w.shape[1]:
        raise ValueError(f"{NAME}: input {tuple(x.shape)} and weights {tuple(q_w.shape)} "
                         "do not match ([N, Cin, *spatial] and [Cout, Cin, *kernel], "
                         "2 or 3 spatial axes)")
    if x.dtype not in _IN_DTYPES or out_dtype not in _IN_DTYPES:
        raise TypeError(f"{NAME}: float32 or bfloat16 only, got {x.dtype} -> {out_dtype}")
    if q_w.dtype != torch.int8:
        raise TypeError(f"{NAME}: int8 weights expected, got {q_w.dtype}")
    for name, t in (("s_k", s_k), ("bias", bias), ("sx", sx), ("qs", qs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: {name} must be float32, got {t.dtype}")
    if s_k.numel() != q_w.shape[0] or bias.numel() != q_w.shape[0]:
        raise ValueError(f"{NAME}: s_k and bias need {q_w.shape[0]} values")
    if sx.numel() != qs.numel() or sx.numel() not in (1, x.shape[0]):
        raise ValueError(f"{NAME}: sx and qs need 1 or {x.shape[0]} values, "
                         f"got {sx.numel()} and {qs.numel()}")


def memory_format(dim: int) -> torch.memory_format:
    """The channels-last memory format of a ``dim``-D activation."""
    return torch.channels_last if dim == 4 else torch.channels_last_3d


def quantize_input(x: torch.Tensor, qs: torch.Tensor, divide: bool) -> torch.Tensor:
    """``clip(rint(x / qs[n]), +-127)`` (``divide``) or ``clip(rint(x * qs),
    +-127)`` of ``x`` [N, ...] in float32, as float32 codes."""
    q = x.float() if x.dtype != torch.float32 else x.clone()
    qv = qs.view(-1, *([1] * (x.dim() - 1)))
    q.div_(qv) if divide else q.mul_(qv)
    return q.round_().clamp_(-QMAX, QMAX)


def epilogue(acc: torch.Tensor, sx: torch.Tensor, s_k: torch.Tensor, bias: torch.Tensor,
             channel_axis: int, out_dtype: torch.dtype) -> torch.Tensor:
    """``fma(acc, sx[n] * s_k[c], bias[c])`` rounded once to float32, then to
    ``out_dtype``; ``acc`` (float32, exact integers) has its samples on axis
    0 and its channels on ``channel_axis``."""
    shape = [1] * acc.dim()
    shape[channel_axis] = -1
    scale = sx.view(-1, *([1] * (acc.dim() - 1))) * s_k.view(shape)
    return fma_f32(acc, scale, bias.view(shape)).to(out_dtype)


def int8_epilogue(acc: torch.Tensor, rows: int, cout: int, rows_per_sample: int,
                  sx: torch.Tensor, s_k: torch.Tensor, bias: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """:func:`epilogue` of an int32 product ``acc`` [>= rows, >= Cout]
    (``torch._int_mm``'s, columns padded past Cout), ``rows_per_sample``
    rows a sample -> [rows, Cout] in ``out_dtype``, contiguous.  The kernel
    of ``csrc/int8_epilogue.cu`` for CUDA tensors, :func:`epilogue` for CPU
    tensors."""
    if acc.dtype != torch.int32 or acc.dim() != 2 or acc.stride(1) != 1:
        raise ValueError(f"{EPILOGUE_NAME}: int32 rows with unit column stride expected, got "
                         f"{acc.dtype} {tuple(acc.shape)} strides {acc.stride()}")
    if rows % rows_per_sample or sx.numel() not in (1, rows // rows_per_sample):
        raise ValueError(f"{EPILOGUE_NAME}: {rows} rows, {rows_per_sample} a sample and "
                         f"{sx.numel()} scales do not agree")
    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{EPILOGUE_NAME}: unsupported device {acc.device}")
    return torch.ops.hst.int8_epilogue(acc, rows, cout, rows_per_sample, sx, s_k, bias,
                                       out_dtype)


@torch.library.custom_op("hst::int8_epilogue", mutates_args=(), device_types="cpu")
def _epilogue_op(acc: torch.Tensor, rows: int, cout: int, rows_per_sample: int,
                 sx: torch.Tensor, s_k: torch.Tensor, bias: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """``hst::int8_epilogue``: :func:`epilogue` on the CPU, the kernel of
    ``csrc/int8_epilogue.cu`` on CUDA (:func:`_epilogue_cuda`)."""
    a = acc[:rows, :cout].float().view(-1, rows_per_sample, cout)
    return epilogue(a, sx, s_k, bias, 2, out_dtype).view(rows, cout)


@_epilogue_op.register_fake
def _(acc, rows, cout, rows_per_sample, sx, s_k, bias, out_dtype):
    return acc.new_empty((rows, cout), dtype=out_dtype)


@_epilogue_op.register_kernel("cuda")
def _epilogue_cuda(acc: torch.Tensor, rows: int, cout: int, rows_per_sample: int,
                   sx: torch.Tensor, s_k: torch.Tensor, bias: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    if out_dtype not in _IN_DTYPES:
        raise TypeError(f"{EPILOGUE_NAME}: float32 or bfloat16 out only, got {out_dtype}")
    params = (sx, s_k, bias)
    if (acc.shape[0] < rows or acc.shape[1] < cout or s_k.numel() != cout
            or bias.numel() != cout
            or any(t.dtype != torch.float32 or t.device != acc.device or not t.is_contiguous()
                   for t in params)):
        raise ValueError(f"{EPILOGUE_NAME}: s_x, s_k and bias must be contiguous float32 on "
                         f"{acc.device}, with {cout} values of s_k and bias")
    y = torch.empty((rows, cout), dtype=out_dtype, device=acc.device)
    err = build.library().hst_int8_epilogue(
        acc.data_ptr(), acc.stride(0), rows, cout, rows_per_sample, sx.data_ptr(),
        int(sx.numel() != 1), s_k.data_ptr(), bias.data_ptr(), y.data_ptr(),
        int(out_dtype == torch.bfloat16), build.stream_handle(acc))
    build.check(EPILOGUE_NAME, err)
    build.launch_counts[EPILOGUE_NAME] += 1
    return y


def int8_conv_plain(x: torch.Tensor, q_w: torch.Tensor, s_k: torch.Tensor,
                    bias: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor, *,
                    stride: int, divide: bool, out_dtype: torch.dtype,
                    dilation: int = 1) -> torch.Tensor:
    """The function of the module docstring in plain PyTorch, channels-last
    out, for a 2-D or 3-D conv (``x`` [N, Cin, *spatial], ``q_w`` [Cout,
    Cin, *kernel]) at any stride and dilation, flax "SAME" padding.

    The integer conv runs in float64, where every partial sum of int8
    products is exact (|acc| <= 127^2 * K < 2^53), and is then rounded to
    float32 as the kernel's int32 -> float32 conversion rounds it.
    """
    _check(x, q_w, s_k, bias, sx, qs, out_dtype)
    q = quantize_input(x, qs, divide)
    pads = [same_pads(s, k, stride, dilation) for s, k in zip(x.shape[2:], q_w.shape[2:])]
    conv = F.conv2d if x.dim() == 4 else F.conv3d
    acc = conv(F.pad(q.double(), [p for lo_hi in reversed(pads) for p in lo_hi]),
               q_w.double(), stride=stride, dilation=dilation).float()
    y = epilogue(acc, sx, s_k, bias, 1, out_dtype)
    return y.contiguous(memory_format=memory_format(x.dim()))


def kernel_takes(cin: int, cout: int, kernel, stride: int, dilation: int,
                 x_dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether :func:`int8_conv` runs this conv on the card: Cout a multiple
    of 8, and either a square 2-D undilated kernel at stride 1 or 2 with
    Cin a multiple of 8 (the TMA path) or one of :data:`DENSE_CIN` (the
    dense path, checked bit for bit on the card at each), or, at stride 1
    with Cin a multiple of 8, a 3x3 kernel at a dilation up to
    :data:`MAX_DILATION` or an undilated 3x3x3 kernel; and a :func:`plan`
    for an ``x_dtype`` input fits in shared memory (its size does not
    depend on the batch or the image; a 32-channel conv at dilation 8 in
    float32 does not fit)."""
    kernel = tuple(kernel)
    if cout % 8:
        return False
    if kernel == (3, 3, 3) or (kernel == (3, 3) and dilation > 1):
        if stride != 1 or cin % 8 or dilation > (1 if len(kernel) == 3 else MAX_DILATION):
            return False
    elif not (len(kernel) == 2 and kernel[0] == kernel[1] and dilation == 1
              and stride in (1, 2) and (cin % 8 == 0 or cin in DENSE_CIN)):
        return False
    try:
        plan(1, cin, 16, 16, cout, kernel[0], stride, x_dtype, x_dtype, dilation,
             16 if len(kernel) == 3 else 0)
    except ValueError:
        return False
    return True


def padded_channels(cin: int, cout: int, kernel=(3, 3), dilation: int = 1):
    """(Cin, Cout) at which the kernel runs a conv zero padded to its
    channels: Cout up to a multiple of 8, and Cin up to a multiple of 8
    unless it is one of :data:`DENSE_CIN` and the conv is an undilated 2-D
    one (the dense path's).  Zero weights and zero input channels add
    nothing to the integer sums, and the padded outputs are dropped, so the
    conv's result is unchanged."""
    dense_ok = len(kernel) == 2 and dilation == 1 and cin in DENSE_CIN
    return (cin if cin % 8 == 0 or dense_ok else _up(cin, 8)), _up(cout, 8)


def int8_conv(x: torch.Tensor, q_w: torch.Tensor, packed: torch.Tensor, s_k: torch.Tensor,
              bias: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor, *,
              stride: int, divide: bool, out_dtype: torch.dtype,
              dilation: int = 1) -> torch.Tensor:
    """The w8a8 conv: the kernel of ``csrc/int8_conv.cu`` for CUDA tensors
    (the convs :func:`kernel_takes`), :func:`int8_conv_plain` for CPU
    tensors.
    ``packed`` is :func:`pack_weight` of ``q_w`` (the plain version does
    not read it); ``x`` must be channels-last.  The custom op
    ``hst::int8_conv``; devices other than these two raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    return torch.ops.hst.int8_conv(x, q_w, packed, s_k, bias, sx, qs, stride, dilation, divide,
                                   out_dtype)


@torch.library.custom_op("hst::int8_conv", mutates_args=(), device_types="cpu")
def _int8_conv_op(x: torch.Tensor, q_w: torch.Tensor, packed: torch.Tensor,
                  s_k: torch.Tensor, bias: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor,
                  stride: int, dilation: int, divide: bool,
                  out_dtype: torch.dtype) -> torch.Tensor:
    return int8_conv_plain(x, q_w, s_k, bias, sx, qs, stride=stride, divide=divide,
                           out_dtype=out_dtype, dilation=dilation)


@_int8_conv_op.register_fake
def _(x, q_w, packed, s_k, bias, sx, qs, stride, dilation, divide, out_dtype):
    _check(x, q_w, s_k, bias, sx, qs, out_dtype)
    out = [-(-s // stride) for s in x.shape[2:]]
    return x.new_empty((x.shape[0], q_w.shape[0], *out), dtype=out_dtype).contiguous(
        memory_format=memory_format(x.dim()))


@_int8_conv_op.register_kernel("cuda")
def _int8_conv_cuda(x: torch.Tensor, q_w: torch.Tensor, packed: torch.Tensor,
                    s_k: torch.Tensor, bias: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor,
                    stride: int, dilation: int, divide: bool,
                    out_dtype: torch.dtype) -> torch.Tensor:
    _check(x, q_w, s_k, bias, sx, qs, out_dtype)
    n, cin = x.shape[:2]
    cout, kernel = q_w.shape[0], tuple(q_w.shape[2:])
    k = kernel[0]
    if any(v != k for v in kernel) or stride not in (1, 2):
        raise ValueError(f"{NAME}: square or cubic kernels at stride 1 or 2 only, got "
                         f"{'x'.join(map(str, kernel))} stride {stride}")
    if not 1 <= dilation <= MAX_DILATION:
        raise ValueError(f"{NAME}: dilation 1 to {MAX_DILATION} only, got {dilation}")
    if packed.dtype != torch.int8 or tuple(packed.shape) != packed_shape(cout, cin, *kernel):
        raise ValueError(f"{NAME}: packed weights {tuple(packed.shape)} {packed.dtype} "
                         f"are not pack_weight of {tuple(q_w.shape)}")
    if cout % 8:
        raise ValueError(f"{NAME}: Cout must be a multiple of 8, got {cout}")
    if not x.is_contiguous(memory_format=memory_format(x.dim())):
        raise ValueError(f"{NAME}: the input must be channels-last contiguous")
    if not dense_input(cin) and x.data_ptr() % 16:
        raise ValueError(f"{NAME}: the input must be 16-byte aligned")
    tensors = (x, packed, s_k, bias, sx, qs)
    if any(t.device != x.device for t in tensors) or not all(
            t.is_contiguous() for t in tensors[1:]):
        raise ValueError(f"{NAME}: every tensor must be contiguous on {x.device}")
    depth = x.shape[2] if x.dim() == 5 else 0          # plan() raises for what it cannot run
    args = _plan_args(n, cin, *x.shape[-2:], cout, k, stride, x.dtype, out_dtype, dilation, depth)
    return _launch(x, packed, s_k, bias, sx, qs, divide, out_dtype, args)


def _launch(x: torch.Tensor, packed: torch.Tensor, s_k: torch.Tensor, bias: torch.Tensor,
            sx: torch.Tensor, qs: torch.Tensor, divide: bool, out_dtype: torch.dtype,
            args: PlanArgs) -> torch.Tensor:
    """One launch of the kernel on checked operands under the plan ``args``
    (``plan(...).args()``; its tile height may differ from the default)."""
    out = torch.empty((args.N, *x.shape[2:-2], args.Ho, args.Wo, args.Cout), dtype=out_dtype,
                      device=x.device).movedim(-1, 1)
    err = build.library().hst_int8_conv(
        x.data_ptr(), packed.data_ptr(), s_k.data_ptr(), bias.data_ptr(), sx.data_ptr(),
        qs.data_ptr(), out.data_ptr(), ctypes.addressof(args), int(sx.numel() != 1), int(divide),
        build.stream_handle(x))
    build.check(NAME, err)
    build.launch_counts[NAME] += 1
    return out
