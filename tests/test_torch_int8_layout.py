"""The int8 conv kernel's weight layout and launch plan, on the CPU.

``csrc/int8_conv.cu`` runs only on the card.  What it reads is chosen in
Python (``ops/kernels/int8_conv.py``): ``pack_weight``'s layout and the
launch plan.  These tests hold both to the kernel's contract, exactly:

* ``pack_weight``, read back in the order in which the kernel consumes it
  (slices of BN output channels, steps of 32 along k = tap * Cp + channel,
  core matrices addressed as the wgmma descriptor addresses them), is
  ``q_w`` again, with zeros in every pad, for 2-D and 3-D weights;
* every conv shape of the flagship (at batches 1, 8 and 32) and of CLASSIC
  in int8 (chunks of 1 and 8, dilated and 3-D convs included) has a plan
  that fits the 227 KB a block may use, slices that are wgmma widths and
  cover Cout, and a non-empty grid; undilated 2-D shapes keep the plan
  they had before dilation and 3-D taps were added, field for field; the
  plan crosses to C as the struct the kernel source declares, field for
  field;
* the TMA path's rings, driven through every order in which the copies may
  land (a stage in one box or in one box a plane), hand each consumer
  warpgroup exactly its own items;
* a mirror in numpy of the kernel's addressing (the tile walk over samples
  and planes, the TMA box or the dense path's aligned row copies, the int8
  tile with columns grouped by stride and planes stacked, the dilated and
  3-D tap table, each lane's A fragments, the B descriptor, the epilogue's
  masks) gives the integer conv of the quantized input, equal to
  ``int8_conv_plain``'s, on small shapes with ragged tiles.
"""

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hobot_stereonet_tpu_torch.config import Config
from hobot_stereonet_tpu_torch.ops.kernels import int8_conv as k8

LBO, SBO = 128, 256          # the B descriptor's leading and stride byte offsets


def flagship_shapes(b):
    """(Cin, Cout, k, stride, H, W, N) of the flagship's 8 conv shapes at 720p."""
    m = Config().model
    c, d = m.feature_channels, m.num_disparities_coarse
    agg, k = max(m.aggregation_channels, 64), m.cost_resolution_divisor
    h, w = 720 // k, 1280 // k
    tower = [(m.input_channels if i == 0 else c, c, 5, 2, 720 >> i, 1280 >> i, 2 * b)
             for i in range(m.downsample_factor)]
    return tower + [(c, c, 3, 1, h, w, 2 * b), (d + c, agg, 3, 1, h, w, b),
                    (agg, agg, 3, 1, h, w, b), (agg, d, 3, 1, h, w, b),
                    (64, 9 * k * k, 3, 1, h, w, b)]


def classic_shapes(b):
    """(Cin, Cout, k, stride, H, W, N, dilation, depth, convs) of CLASSIC's 53
    int8 conv shapes at 720p and a chunk of ``b`` frames, at the channels
    the kernel runs them at (``padded_channels``); depth 0 for a 2-D conv."""
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models.stereonet import REFINE_DILATIONS

    m = StereoNetConfig()
    c, k = m.feature_channels, m.cost_resolution_divisor
    h, w = 720 // k, 1280 // k
    shapes = [(m.input_channels if i == 0 else c, c, 5, 2, 720 >> i, 1280 >> i, 2 * b, 1, 0, 1)
              for i in range(m.downsample_factor)]
    shapes.append((c, c, 3, 1, h, w, 2 * b, 1, 0, 2 * m.num_feature_res_blocks + 1))
    agg, d = m.aggregation_channels, m.num_disparities_coarse
    shapes += [(c, agg, 3, 1, h, w, b, 1, d, m.num_aggregation_layers),
               (agg, 1, 3, 1, h, w, b, 1, d, 1)]
    for i, (rc, blocks) in enumerate(zip(m.refinement_scale_channels, m.refinement_scale_blocks)):
        s = 2 ** (m.downsample_factor - 1 - i)
        rh, rw = 720 // s, 1280 // s
        shapes.append((1 + m.input_channels, rc, 3, 1, rh, rw, b, 1, 0, 1))
        for blk in range(blocks):
            shapes.append((rc, rc, 3, 1, rh, rw, b, REFINE_DILATIONS[blk % 6], 0, 2))
        shapes.append((rc, 1, 3, 1, rh, rw, b, 1, 0, 1))
    convs: dict = {}
    for cin, cout, *rest, count in shapes:
        key = (*k8.padded_channels(cin, cout), *rest)
        convs[key] = convs.get(key, 0) + count
    return [(*key, count) for key, count in convs.items()]


def b_byte(kb, row, k, bn):
    """Byte offset of B[row, k] of k-step ``kb`` in a slice: the descriptor's
    layout (row stride 16 within a core matrix, LBO between the two k
    halves, SBO between groups of 8 rows)."""
    return kb * bn * 32 + (row // 8) * SBO + (k // 16) * LBO + (row % 8) * 16 + k % 16


def unpack(packed, cout, cin, *kernel):
    """The kernel's view of ``pack_weight``: [Cout, Cin, *kernel] from the
    bytes each slice, k-step and row address, and the pads; taps in
    (kd, kh, kw) order."""
    bn, slices = k8.output_slices(cout)
    cpt = k8.channels_per_tap(cin)
    flat = packed.numpy().reshape(slices, -1)
    kb_n = flat.shape[1] // (bn * 32)
    rows = np.arange(slices * bn)
    ks = np.arange(kb_n * 32)
    idx = b_byte(ks[None, :] // 32, rows[:, None] % bn, ks[None, :] % 32, bn)
    full = flat[rows[:, None] // bn, idx]                     # [slices * bn, K_pad]
    taps = int(np.prod(kernel))
    w = full[:cout, :taps * cpt].reshape(cout, *kernel, cpt)
    pads = (full[cout:], full[:, taps * cpt:], w[..., cin:])
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(w[..., :cin], -1, 1))), pads


ODD = [(3, 32, 5), (3, 8, 3), (16, 8, 3), (56, 64, 3), (64, 24, 3), (64, 576, 3),
       (32, 200, 3), (32, 40, 3), (8, 128, 5), (5, 16, 3)]


@pytest.mark.parametrize("cin,cout,k", sorted({s[:3] for s in flagship_shapes(1)}) + ODD)
def test_pack_weight_reads_back(cin, cout, k):
    rng = np.random.default_rng(cin * 1000 + cout + k)
    q_w = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8))
    packed = k8.pack_weight(q_w)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tuple(packed.shape) == k8.packed_shape(cout, cin, k, k)
    got, pads = unpack(packed, cout, cin, k, k)
    assert torch.equal(got, q_w)
    assert all(not p.any() for p in pads)


@pytest.mark.parametrize("cin,cout,k", [(32, 32, 3), (32, 1, 3), (32, 8, 3), (16, 16, 3),
                                        (64, 200, 3), (8, 24, 2)])
def test_pack_weight_reads_back_3d(cin, cout, k):
    """5-D weights [Cout, Cin, kd, kh, kw]: taps in (kd, kh, kw) order, the
    order of ``int8_gemm.gemm_weight`` and of the kernel's tap table."""
    from hobot_stereonet_tpu_torch.ops.int8_gemm import gemm_weight

    rng = np.random.default_rng(cin * 1000 + cout + k + 7)
    q_w = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k, k), dtype=np.int8))
    packed = k8.pack_weight(q_w)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tuple(packed.shape) == k8.packed_shape(cout, cin, k, k, k)
    got, pads = unpack(packed, cout, cin, k, k, k)
    assert torch.equal(got, q_w)
    assert all(not p.any() for p in pads)
    if cin % 32 == 0:                   # k = tap * Cin + channel, as the library route's rows
        bn, _ = k8.output_slices(cout)
        flat = packed.numpy().reshape(-1)
        ks = np.arange(k ** 3 * cin)
        rows = np.arange(cout)
        mine = flat[(rows[:, None] // bn) * (packed.numel() // packed.shape[0])
                    + b_byte(ks[None, :] // 32, rows[:, None] % bn, ks[None, :] % 32, bn)]
        assert np.array_equal(mine, gemm_weight(q_w)[:cout, :k ** 3 * cin].numpy())


def check_plan(p, n, cin, cout):
    assert p.smem <= k8.SMEM_MAX and 1 <= p.stages <= k8.MAX_STAGES
    assert p.rings == (1 if p.dense else 2) and p.rings * p.stages >= 2
    assert p.bn % 8 == 0 and p.bn <= 256
    assert p.bn in k8.N_SINGLE or p.bn % k8.N_WIDE == 0
    assert p.n_slices * p.bn >= cout > (p.n_slices - 1) * p.bn
    assert p.tiles_h * p.th >= p.Ho and p.tiles_w * p.tw >= p.Wo
    assert p.tiles == n * p.D * p.tiles_h * p.tiles_w >= 1 and p.n_slices >= 1
    assert p.dense == (cin % 8 != 0) and (p.dense or p.bc in (16, 32))
    assert p.taps == p.KD * p.KS * p.KS and p.KD in (1, p.KS)
    assert p.ih == (p.th - 1) * p.stride + (p.KS - 1) * p.dil + 1
    assert p.iw == (p.tw - 1) * p.stride + (p.KS - 1) * p.dil + 1
    # the regions of shared memory do not overlap, in this order
    assert p.w_bytes <= p.off_stage
    assert p.off_stage + p.rings * p.stages * p.stage_bytes <= p.off_aq
    assert p.off_aq + 2 * p.aq_bytes <= p.off_epi
    assert p.off_epi + (4 if p.dense else 8) * 16 * p.epi_pitch <= p.off_par
    assert p.off_par + 8 * p.bn <= p.off_tab
    assert p.off_tab + 4 * (8 * p.k_blocks if p.dense else p.taps) <= p.off_bar
    assert p.off_bar + 8 * (2 * p.rings * p.stages + 1) == p.smem
    assert all(v % 128 == 0 for v in (p.off_stage, p.stage_bytes, p.off_aq, p.aq_bytes))
    assert p.stage_bytes >= p.KD * p.ih * p.row_bytes and p.epi_pitch % 16 == 0
    assert p.aq_bytes >= p.KD * p.ih * p.aw * p.aq_pitch
    if not p.dense:               # the TMA box and the quantizer's mask (64 pixels a thread)
        assert max(p.ih, p.iw, p.KD) <= k8.BOX_MAX and p.KD * p.ih * p.iw <= 64 * 32


@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_plan_fits_every_flagship_shape(b, x_dtype):
    for cin, cout, k, stride, h, w, n in flagship_shapes(b):
        p = k8.plan(n, cin, h, w, cout, k, stride, x_dtype, torch.bfloat16)
        check_plan(p, n, cin, cout)
        assert (p.dil, p.D, p.KD, p.pad_f) == (1, 1, 1, 0)
    # the mask head keeps a third of its 576 channels resident per block
    assert k8.output_slices(576) == (192, 3)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_plan_fits_every_classic_shape(b, x_dtype):
    """Every CLASSIC int8 conv shape at 720p in a chunk of ``b``, at the
    channels the kernel runs it at: the kernel takes it, and its plan (and
    each tile height the kernel is built for) fits; the dilated ones at
    the slices built for it take 8-row tiles, the rest 4 (8 on the dense
    path up to 32 channels)."""
    shapes = classic_shapes(b)
    assert sum(s[-1] for s in shapes) == 53 and len(shapes) == 23
    for cin, cout, k, stride, h, w, n, dil, depth, _ in shapes:
        kernel = (k,) * (3 if depth else 2)
        assert k8.kernel_takes(cin, cout, kernel, stride, dil)
        if x_dtype == torch.float32 and (cin, dil) == (32, 8):
            # a float32 stage of the 24 x 32 halo is 96 KB: no plan fits two rings
            assert not k8.kernel_takes(cin, cout, kernel, stride, dil, x_dtype)
            with pytest.raises(ValueError, match="shared memory"):
                k8.plan(n, cin, h, w, cout, k, stride, x_dtype, torch.bfloat16, dil, depth)
            continue
        assert k8.kernel_takes(cin, cout, kernel, stride, dil, x_dtype)
        p = k8.plan(n, cin, h, w, cout, k, stride, x_dtype, torch.bfloat16, dil, depth)
        check_plan(p, n, cin, cout)
        assert (p.dil, p.D, p.KD) == (dil, max(depth, 1), 3 if depth else 1)
        assert p.pad_f == (1 if depth else 0)
        assert stride == 2 or (p.pad_t, p.pad_l) == (dil * (k // 2),) * 2
        assert p.th == k8.tile_rows(p.dense, p.bn, dil, depth)
        assert p.th == (8 if (dil > 1 and p.bn in k8.TALL_BN) or (p.dense and p.bn <= 32)
                        else 4)
        if (dil > 1 or depth) and p.bn in k8.TALL_BN:
            for rows in (4, 8):
                check_plan(k8.plan(n, cin, h, w, cout, k, stride, x_dtype, torch.bfloat16, dil,
                                   depth, rows), n, cin, cout)


# The plans of the flagship's conv shapes at a batch of 8 (bf16 input; the
# first conv also with the RGB ingest's float32 input) as they were before
# dilation and 3-D taps were added, field for field: (N, Cin, H, W, Cout, k,
# stride, input dtype) -> the fields of Plan from N to tiles.
FLAGSHIP_PLANS_B8 = {
    (16, 3, 720, 1280, 32, 5, 2, "bfloat16"): (
        16, 720, 1280, 3, 360, 640, 32, 5, 2, 1, 1, 1, 1, 1, 32, 1, 4, 1, 4, 25, 8, 16, 19, 35,
        18, 36, 0, 1, 2, 4608, 240, 4, 2816, 80, 4096, 4096, 13312, 18944, 24064, 24320, 24448,
        24488, 45, 40, 28800),
    (16, 3, 720, 1280, 32, 5, 2, "float32"): (
        16, 720, 1280, 3, 360, 640, 32, 5, 2, 1, 1, 0, 1, 1, 32, 1, 4, 1, 4, 25, 8, 16, 19, 35,
        18, 36, 0, 1, 3, 8576, 448, 4, 2816, 80, 4096, 4096, 29824, 35456, 40576, 40832, 40960,
        41016, 45, 40, 28800),
    (16, 32, 360, 640, 32, 5, 2, "bfloat16"): (
        16, 360, 640, 32, 180, 320, 32, 5, 2, 1, 1, 1, 1, 0, 32, 1, 32, 1, 25, 25, 4, 16, 11, 35,
        18, 36, 32, 2, 3, 24704, 2240, 48, 19072, 80, 25600, 25600, 173824, 211968, 222208,
        222464, 222568, 222672, 45, 20, 14400),
    (16, 32, 180, 320, 32, 5, 2, "bfloat16"): (
        16, 180, 320, 32, 90, 160, 32, 5, 2, 1, 1, 1, 1, 0, 32, 1, 32, 1, 25, 25, 4, 16, 11, 35,
        18, 36, 32, 2, 3, 24704, 2240, 48, 19072, 80, 25600, 25600, 173824, 211968, 222208,
        222464, 222568, 222672, 23, 10, 3680),
    (16, 32, 90, 160, 32, 3, 1, "bfloat16"): (
        16, 90, 160, 32, 90, 160, 32, 3, 1, 1, 1, 1, 1, 0, 32, 1, 32, 1, 9, 9, 4, 16, 6, 18, 18,
        18, 32, 2, 3, 6912, 1152, 48, 5248, 80, 9216, 9216, 50688, 61184, 71424, 71680, 71720,
        71824, 23, 10, 3680),
    (8, 56, 90, 160, 64, 3, 1, "bfloat16"): (
        8, 90, 160, 56, 90, 160, 64, 3, 1, 1, 1, 1, 1, 0, 64, 1, 64, 2, 18, 9, 4, 16, 6, 18, 18,
        18, 32, 2, 3, 6912, 1152, 48, 5248, 144, 36864, 36864, 78336, 88832, 107264, 107776,
        107816, 107920, 23, 10, 1840),
    (8, 64, 90, 160, 64, 3, 1, "bfloat16"): (
        8, 90, 160, 64, 90, 160, 64, 3, 1, 1, 1, 1, 1, 0, 64, 1, 64, 2, 18, 9, 4, 16, 6, 18, 18,
        18, 32, 2, 3, 6912, 1152, 48, 5248, 144, 36864, 36864, 78336, 88832, 107264, 107776,
        107816, 107920, 23, 10, 1840),
    (8, 64, 90, 160, 24, 3, 1, "bfloat16"): (
        8, 90, 160, 64, 90, 160, 24, 3, 1, 1, 1, 1, 1, 0, 24, 1, 64, 2, 18, 9, 4, 16, 6, 18, 18,
        18, 32, 2, 3, 6912, 1152, 48, 5248, 64, 13824, 13824, 55296, 65792, 73984, 74176, 74216,
        74320, 23, 10, 1840),
    (8, 64, 90, 160, 576, 3, 1, "bfloat16"): (
        8, 90, 160, 64, 90, 160, 576, 3, 1, 1, 1, 1, 1, 0, 192, 3, 64, 2, 18, 9, 4, 16, 6, 18, 18,
        18, 32, 2, 3, 6912, 1152, 48, 5248, 144, 110592, 110592, 152064, 162560, 180992, 182528,
        182568, 182672, 23, 10, 1840),
}
PLAN_FIELDS_BEFORE = ("N H W Cin Ho Wo Cout KS stride pad_t pad_l x_bf16 y_bf16 dense bn n_slices "
                      "cpt slices k_blocks taps th tw ih iw iwh aw bc rings stages stage_bytes "
                      "row_bytes aq_pitch aq_bytes epi_pitch w_bytes off_stage off_aq off_epi "
                      "off_par off_tab off_bar smem tiles_h tiles_w tiles").split()


@pytest.mark.parametrize("key", sorted(FLAGSHIP_PLANS_B8))
def test_undilated_2d_plans_are_unchanged(key):
    """At dilation 1 in 2-D, ``plan()`` returns the fields it returned before
    dilation and 3-D taps were added, so the flagship's convs keep their
    launch; the new fields read dilation 1, one plane, no depth padding."""
    n, cin, h, w, cout, k, stride, dt = key
    p = k8.plan(n, cin, h, w, cout, k, stride, getattr(torch, dt), torch.bfloat16)
    assert tuple(getattr(p, f) for f in PLAN_FIELDS_BEFORE) == FLAGSHIP_PLANS_B8[key]
    assert [f.name for f in dataclasses.fields(k8.Plan)][:len(PLAN_FIELDS_BEFORE)] == list(
        PLAN_FIELDS_BEFORE)
    assert (p.dil, p.D, p.KD, p.pad_f) == (1, 1, 1, 0)
    assert k8.plan(n, cin, h, w, cout, k, stride, getattr(torch, dt), torch.bfloat16, 1, 0,
                   p.th) == p


@pytest.mark.parametrize("args", [
    dict(cin=3, dilation=2), dict(cin=4, depth=4), dict(stride=2, dilation=2),
    dict(stride=2, depth=4), dict(cout=64, rows=8), dict(cin=32, dilation=64),
])
def test_plan_refuses_what_the_kernel_does_not_run(args):
    """A shape the kernel cannot run has no plan: dilated and 3-D convs off
    the TMA path or at stride 2, a tall tile at a slice not built for it,
    a halo wider than a TMA box."""
    a = dict(n=1, cin=32, h=64, w=64, cout=32, k=3, stride=1, dilation=1, depth=0, rows=None)
    a.update(args)
    with pytest.raises(ValueError, match="int8_conv"):
        k8.plan(a["n"], a["cin"], a["h"], a["w"], a["cout"], a["k"], a["stride"], torch.bfloat16,
                torch.bfloat16, a["dilation"], a["depth"], a["rows"])


def test_plan_args_match_the_kernel_struct():
    """``PlanArgs`` has the fields of ``struct PlanArgs`` in
    ``csrc/int8_conv.cu``, in order, all int32, and carries the version
    and size that the C entry checks."""
    src = (k8.build.CSRC_DIR / "int8_conv.cu").read_text()
    body = re.search(r"struct PlanArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    c_fields = [f for f in re.findall(r"\w+", body) if f != "int"]
    assert [name for name, _ in k8.PlanArgs._fields_] == c_fields
    assert all(t is ctypes.c_int for _, t in k8.PlanArgs._fields_)
    version = int(re.search(r"PLAN_VERSION = (\d+);", src).group(1))
    tall = re.search(r"constexpr bool TALL = ([^;]*);", src).group(1)
    assert tuple(int(v) for v in re.findall(r"BN == (\d+)", tall)) == k8.TALL_BN
    args = k8.plan(2, 32, 9, 17, 32, 3, 1, torch.bfloat16, torch.bfloat16).args()
    assert args.version == version == k8.PLAN_VERSION
    assert args.size == ctypes.sizeof(k8.PlanArgs) == 4 * len(c_fields)


def drive_rings(tiles, slices, stages, rng, boxes=(1,)):
    """The TMA path's producer and two consumer warpgroups as
    ``int8_conv_wgmma_kernel`` runs them, with mbarriers that count
    completed phases (``try_wait.parity`` passes when the phase count's
    parity differs from the one asked for) and copies that land in a
    random order.  Each step, one of the agents that can move does.  A
    stage is filled by one copy a box, ``boxes`` holding each box's bytes:
    the producer's ``expect_tx`` arms the full barrier with their sum and
    its phase completes when the last byte has landed.  Asserts that a
    consumer passes its full barrier only when its own item lies in the
    stage, every box of it, with no copy to it in flight; returns the items
    each warpgroup consumed."""
    rings = 2
    full, empty = [0] * (rings * stages), [0] * (rings * stages)
    pending = [0] * (rings * stages)              # transaction bytes still to land
    landed, flight = [None] * (rings * stages), []
    stage = lambda wg, i: wg * stages + i % stages          # noqa: E731
    # the walk's j-th tile goes to warpgroup j % 2 as items (j // 2) * slices + c
    produce = [(j & 1, (j >> 1) * slices + c) for j in range(tiles) for c in range(slices)]
    consume = {wg: [(wg, (j >> 1) * slices + c) for j in range(wg, tiles, 2)
                    for c in range(slices)] for wg in (0, 1)}
    done = {0: [], 1: []}
    passes = lambda phases, parity: (phases & 1) != parity   # noqa: E731
    pi = 0
    while True:
        moves = []
        if pi < len(produce):
            wg, i = produce[pi]
            if passes(empty[stage(wg, i)], ((i // stages) & 1) ^ 1):
                moves.append("produce")
        if flight:
            moves.append("land")
        for wg in (0, 1):
            if len(done[wg]) < len(consume[wg]):
                i = consume[wg][len(done[wg])][1]
                if passes(full[stage(wg, i)], (i // stages) & 1):
                    moves.append(wg)
        if not moves:
            break
        move = moves[rng.integers(len(moves))]
        if move == "produce":
            s = stage(*produce[pi])
            assert pending[s] == 0                       # the stage's last phase completed
            pending[s] = sum(boxes)                      # mbarrier.arrive.expect_tx
            landed[s] = [None] * len(boxes)
            flight += [(s, produce[pi], b) for b in range(len(boxes))]
            pi += 1
        elif move == "land":
            s, item, b = flight.pop(rng.integers(len(flight)))
            landed[s][b] = item
            pending[s] -= boxes[b]                       # complete_tx::bytes
            if pending[s] == 0:
                full[s] += 1
        else:
            item = consume[move][len(done[move])]
            s = stage(*item)
            assert landed[s] == [item] * len(boxes) and all(f[0] != s for f in flight), (
                item, landed[s])
            empty[s] += 1                       # the warpgroup's release after its quantize
            done[move].append(item)
    assert pi == len(produce)
    return done, consume


@pytest.mark.parametrize("slices,stages", [(1, 1), (1, 2), (1, 3), (2, 1), (2, 2), (3, 1)])
def test_rings_hand_each_warpgroup_its_own_items(slices, stages):
    rng = np.random.default_rng(100 * slices + stages)
    for tiles in (1, 2, 3, 7, 12):
        for _ in range(60):
            done, consume = drive_rings(tiles, slices, stages, rng)
            assert done == consume


@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_rings_with_a_stage_of_three_planes(stages, x_dtype):
    """A 3-D conv's stage holds the planes d - 1, d, d + 1: the full
    barrier's transaction bytes are the three planes' halos, the box the
    producer arms it with (``KD * ih * iw * bc`` elements), and fit in the
    stage.  Landed as one box or as one box a plane, in any order, each
    warpgroup gets exactly its items, whole."""
    p = k8.plan(8, 32, 90, 160, 32, 3, 1, x_dtype, torch.bfloat16, 1, 24)
    xb = 2 if x_dtype == torch.bfloat16 else 4
    plane = p.ih * p.iw * p.bc * xb
    box = p.KD * p.ih * p.iw * p.bc * xb               # the kernel's expect_tx
    assert p.KD == 3 and box == 3 * plane <= p.stage_bytes
    rng = np.random.default_rng(stages + 10 * xb)
    for boxes in ((box,), (plane,) * 3):
        for tiles in (1, 2, 5, 9):
            for _ in range(40):
                done, consume = drive_rings(tiles, 1, stages, rng, boxes)
                assert done == consume


# ---------------------------------------------------------------------------
# A mirror of the kernel's addressing in numpy.


def quant(v, qscale, divide):
    v = np.asarray(v, np.float32)
    t = v / np.float32(qscale) if divide else v * np.float32(qscale)
    return np.clip(np.rint(t), -127, 127).astype(np.int64)


def col_pos(p, col):
    return (col % p.stride) * p.iwh + col // p.stride


def tile_of(p, t):
    tw = t % p.tiles_w
    t //= p.tiles_w
    th, nd = t % p.tiles_h, t // p.tiles_h
    n = nd // p.D
    ho0, wo0 = th * p.th, tw * p.tw
    di0 = nd - n * p.D - p.pad_f
    return n, nd, ho0, wo0, di0, ho0 * p.stride - p.pad_t, wo0 * p.stride - p.pad_l


def fragments(p, aq, orow, taps_or_steps, pitch, unit):
    """A [16 pixels, 32 k] of one warp for each tap (TMA path) or k-step
    (dense path), read lane by lane as the kernel's lds32 calls read them;
    ``orow`` is the warp's row plus 4 for its second wgmma tile."""
    out = []
    for step in taps_or_steps:
        a = np.zeros((16, 32), np.int64)
        for lane in range(32):
            g8, t4 = lane // 4, lane % 4
            arow = ((orow % 4) * p.stride * p.aw + g8) * pitch + (orow // 4) * (
                4 * p.stride * p.aw * pitch)
            for j in range(4):                      # a0..a3: (pixel g | g+8) x (k half)
                addr = arow + unit(step, t4, j) + (8 * pitch if j % 2 else 0)
                px, k0 = g8 + 8 * (j % 2), 4 * t4 + 16 * (j // 2)
                a[px, k0:k0 + 4] = aq[addr:addr + 4]
        out.append(a)
    return out


def emulate(x, q_w, qs, stride, divide, base_offset=0, dilation=1, rows=None):
    """Integer accumulators [N, (D,) Ho, Wo, Cout] as the kernel computes
    them, for a 2-D or a 3-D conv (``x`` [N, Cin, (D,) H, W])."""
    n, cin = x.shape[:2]
    cout, k = q_w.shape[0], q_w.shape[-1]
    depth = x.shape[2] if x.dim() == 5 else 0
    h, w = x.shape[-2:]
    p = k8.plan(n, cin, h, w, cout, k, stride, x.dtype, torch.bfloat16, dilation, depth, rows)
    packed = k8.pack_weight(q_w).numpy().reshape(-1).astype(np.int64)
    xs = x.movedim(1, -1).float().numpy()
    xs = xs if depth else xs[:, None]              # [N, D, H, W, Cin]
    qsv = qs.numpy()
    acc = np.zeros((n, p.D, p.Ho, p.Wo, cout), np.int64)
    xb = 2 if x.dtype == torch.bfloat16 else 4
    for ns in range(p.n_slices):
        wblk = packed[ns * p.w_bytes:(ns + 1) * p.w_bytes]
        for t in range(p.tiles):
            img, nd, ho0, wo0, di0, hi0, wi0 = tile_of(p, t)
            qscale = qsv[img if qsv.size > 1 else 0]
            d = np.zeros((p.th, p.tw, p.bn), np.int64)
            for c in range(p.slices):
                if p.dense:
                    aq = np.zeros(p.ih * p.aw * p.cpt, np.int64)
                    lo, hi = max(wi0, 0), min(wi0 + p.iw, p.W)
                    for r in range(p.ih):
                        hh = hi0 + r
                        for col in range(p.iw):
                            ww = wi0 + col
                            # the aligned row copy: pixel ww lies (a & 15) + (ww - lo) * Cin * xb
                            # bytes into the stage row, a = the row's first valid byte
                            a = base_offset + ((img * p.H + hh) * p.W + lo) * cin * xb
                            assert (a % 16) + (p.iw * cin * xb) <= p.row_bytes
                            for grp in range(p.cpt // 4):
                                q = np.zeros(4, np.int64)
                                if 0 <= hh < p.H and lo <= ww < hi:
                                    ch = np.arange(4 * grp, min(4 * grp + 4, cin))
                                    q[:ch.size] = quant(xs[img, 0, hh, ww, ch], qscale, divide)
                                at = (r * p.aw + col_pos(p, col)) * p.cpt + 4 * grp
                                aq[at:at + 4] = q
                    cpg = p.cpt // 4

                    def unit(kb, t4, j):
                        u = 8 * kb + 4 * (j // 2) + t4
                        tap, grp = u // cpg, u % cpg
                        tap = 0 if tap >= p.taps else tap
                        r, s = divmod(tap, p.KS)
                        return (r * p.aw + col_pos(p, s)) * p.cpt + 4 * grp
                    steps = list(range(p.k_blocks))
                    kbs = steps
                    pitch = p.cpt
                else:
                    # the TMA box: KD planes x ih rows x iw columns x bc channels from
                    # (di0, hi0, wi0, 32 c), zero outside the tensor; stage row R = kd * ih + r
                    aq = np.zeros(p.KD * p.ih * p.aw * k8.PITCH, np.int64)
                    kd, r, col, ch = np.meshgrid(np.arange(p.KD), np.arange(p.ih),
                                                 np.arange(p.iw), np.arange(32), indexing="ij")
                    dd, hh, ww, cc = di0 + kd, hi0 + r, wi0 + col, 32 * c + ch
                    inside = ((ch < p.bc) & (dd >= 0) & (dd < p.D) & (hh >= 0) & (hh < p.H)
                              & (ww >= 0) & (ww < p.W) & (cc < cin))
                    v = np.where(inside, xs[img, dd.clip(0, p.D - 1), hh.clip(0, p.H - 1),
                                            ww.clip(0, p.W - 1), cc.clip(0, cin - 1)], 0.0)
                    at = ((kd * p.ih + r) * p.aw + col_pos(p, col)) * k8.PITCH + ch
                    aq[at.reshape(-1)] = quant(v.reshape(-1), qscale, divide)

                    def unit(tap, t4, j):
                        # the tap table: tap (kd, r, s) at row kd * ih + r * dil, column s * dil
                        kd, rs = divmod(tap, p.KS * p.KS)
                        r, s = divmod(rs, p.KS)
                        return (((kd * p.ih + r * p.dil) * p.aw + col_pos(p, s * p.dil)) * k8.PITCH
                                + 4 * t4 + (16 if j >= 2 else 0))
                    steps = list(range(p.taps))
                    kbs = [tap * p.slices + c for tap in steps]
                    pitch = k8.PITCH
                rows_ = np.arange(p.bn)
                kk = np.arange(32)
                for orow in range(p.th):
                    for a, kb in zip(fragments(p, aq, orow, steps, pitch, unit), kbs):
                        bmat = wblk[b_byte(kb, rows_[:, None], kk[None, :], p.bn)]
                        d[orow] += a @ bmat.T
            for orow in range(p.th):
                ho = ho0 + orow
                if ho >= p.Ho:
                    continue
                for px in range(p.tw):
                    wo = wo0 + px
                    if wo < p.Wo:
                        c0 = ns * p.bn
                        nv = min(p.bn, cout - c0)
                        # the epilogue's row m = (nd * Ho + ho) * Wo + wo
                        acc[img, nd - img * p.D, ho, wo, c0:c0 + nv] = d[orow, px, :nv]
    return acc if depth else acc[:, 0]


def integer_conv(x, q_w, qs, stride, divide, dilation=1):
    """``int8_conv_plain``'s integer conv of the quantized input, exact in
    float64: [N, (D,) Ho, Wo, Cout] int64."""
    qv = qs.view(-1, *([1] * (x.dim() - 1)))
    xq = torch.clamp(torch.round(x.float() / qv if divide else x.float() * qv), -127, 127)
    pads = [k8.same_pads(s, k, stride, dilation) for s, k in zip(x.shape[2:], q_w.shape[2:])]
    conv = F.conv2d if x.dim() == 4 else F.conv3d
    got = conv(F.pad(xq.double(), [p for lo_hi in reversed(pads) for p in lo_hi]), q_w.double(),
               stride=stride, dilation=dilation)
    return got.movedim(1, -1).numpy().astype(np.int64)


@pytest.mark.parametrize("n,cin,cout,k,stride,h,w,x_dtype,base_offset", [
    (2, 3, 32, 5, 2, 17, 30, torch.bfloat16, 0),       # dense, rows not 16-byte multiples
    (1, 3, 8, 3, 1, 9, 18, torch.float32, 4),          # dense, input not 16-byte aligned
    (2, 16, 8, 3, 1, 7, 9, torch.float32, 0),          # 16-channel box
    (1, 56, 64, 3, 1, 9, 17, torch.bfloat16, 0),       # two slices, zero channels 56..63
    (2, 32, 32, 5, 2, 19, 37, torch.bfloat16, 0),      # stride 2, ragged tiles
    (1, 32, 200, 3, 1, 9, 17, torch.bfloat16, 0),      # two output slices of 128, padded
])
@pytest.mark.parametrize("divide", [True, False])
def test_kernel_mirror_equals_the_integer_conv(n, cin, cout, k, stride, h, w, x_dtype,
                                               base_offset, divide):
    rng = np.random.default_rng(11)
    x = torch.from_numpy((2.0 * rng.standard_normal((n, cin, h, w))).astype(np.float32))
    x = x.to(x_dtype)
    q_w = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8))
    qs = torch.from_numpy(rng.uniform(0.01, 0.05, n).astype(np.float32))
    if not divide:
        qs = 1.0 / qs[:1]
    got = emulate(x, q_w, qs, stride, divide, base_offset)
    want = integer_conv(x, q_w, qs, stride, divide)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


# (N, Cin, Cout, depth (0: 2-D), H, W, dilation, tile rows (None: the plan's), input dtype)
DILATED_AND_3D = [
    (1, 32, 32, 0, 13, 21, 2, None, torch.bfloat16),   # 8-row tiles, ragged
    (2, 16, 16, 0, 11, 37, 4, None, torch.float32),    # 16-channel box, three tile columns
    (1, 32, 32, 0, 19, 35, 8, None, torch.bfloat16),   # a 24 x 32 halo, SAME pads of 8
    (1, 32, 32, 0, 10, 18, 8, 4, torch.bfloat16),      # 4-row tiles at dilation 8
    (1, 16, 8, 0, 9, 20, 2, None, torch.bfloat16),     # the narrowest slice, 8-row tiles
    (1, 64, 24, 0, 7, 19, 4, None, torch.bfloat16),    # two channel slices, 4-row tiles
    (1, 32, 32, 3, 6, 17, 1, None, torch.bfloat16),    # 3-D, D = 3: both depth edges a tile
    (2, 32, 8, 5, 5, 18, 1, None, torch.bfloat16),     # 3-D, D = 5, two samples
    (1, 16, 16, 5, 9, 16, 1, None, torch.float32),     # 3-D, Cin 16
    (1, 32, 16, 4, 10, 9, 1, 8, torch.bfloat16),       # 3-D, 8-row tiles
    (1, 8, 8, 3, 5, 17, 1, None, torch.bfloat16),      # 3-D, an 8-channel box
]


@pytest.mark.parametrize("n,cin,cout,depth,h,w,dil,rows,x_dtype", DILATED_AND_3D)
@pytest.mark.parametrize("divide", [True, False])
def test_kernel_mirror_dilated_and_3d(n, cin, cout, depth, h, w, dil, rows, x_dtype, divide):
    """The mirror at dilations 2, 4 and 8 (taller and shorter tiles) and 3-D
    taps (the depth edges' zero planes at D = 3 and 5, Cin 16) equals the
    integer conv of ``int8_conv_plain``."""
    rng = np.random.default_rng(12 + dil + depth)
    spatial = ((depth,) if depth else ()) + (h, w)
    x = torch.from_numpy((2.0 * rng.standard_normal((n, cin) + spatial)).astype(np.float32))
    x = x.to(x_dtype)
    kernel = (3,) * len(spatial)
    q_w = torch.from_numpy(rng.integers(-127, 128, (cout, cin) + kernel, dtype=np.int8))
    qs = torch.from_numpy(rng.uniform(0.01, 0.05, n).astype(np.float32))
    if not divide:
        qs = 1.0 / qs[:1]
    got = emulate(x, q_w, qs, 1, divide, dilation=dil, rows=rows)
    want = integer_conv(x, q_w, qs, 1, divide, dil)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_kernel_mirror_cout_1_padded_to_8():
    """CLASSIC's last 3-D conv (Cout 1) as the card runs it: its weights zero
    padded to 8 output channels (``Int8Conv.card_weight``); channel 0 is the
    conv of the unpadded weights, the padding's channels are zero."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy((2.0 * rng.standard_normal((1, 32, 4, 6, 19))).astype(np.float32))
    x = x.to(torch.bfloat16)
    q_w = torch.from_numpy(rng.integers(-127, 128, (1, 32, 3, 3, 3), dtype=np.int8))
    qs = torch.tensor([0.03])
    got = emulate(x, F.pad(q_w, (0, 0, 0, 0, 0, 0, 0, 0, 0, 7)), qs, 1, True)
    assert got.shape[-1] == 8 and not got[..., 1:].any()
    assert np.array_equal(got[..., :1], integer_conv(x, q_w, qs, 1, True))


MAGIC = np.float32(12582912.0)          # 1.5 * 2^23


def quotient_code(v, s, c):
    """``quotient_code`` of ``csrc/int8_conv.cu``: rint(RN(v / s)) placed
    against the half-integer h nearest c exactly, in float64, no division."""
    h = np.floor(c) + np.float32(0.5)
    d = v.astype(np.float64) - h.astype(np.float64) * np.float64(s)
    up = 0.5 * (np.nextafter(h, np.float32(np.inf)) - h).astype(np.float64) * np.float64(s)
    dn = 0.5 * (h - np.nextafter(h, np.float32(-np.inf))).astype(np.float64) * np.float64(s)
    return np.where(d > up, h + np.float32(0.5),
                    np.where(d < -dn, h - np.float32(0.5), np.rint(h))).astype(np.float32)


def kernel_quant(v, s, divide):
    """The kernel's quantizer (``quantize_n`` in ``csrc/int8_conv.cu``) in
    float32: c = clip(y, +-127) rounded by adding 1.5 * 2^23, y = v * s or,
    for the dynamic scheme, v * RN(1/s) unless c lies within 4e-5 of a
    half-integer, then ``quotient_code``.  Returns the codes and where the
    exact path ran."""
    v = np.asarray(v, np.float32)
    s = np.float32(s)
    lo, hi = np.float32(-127), np.float32(127)
    with np.errstate(over="ignore", invalid="ignore"):
        c = np.fmin(np.fmax(v * (np.float32(1) / s if divide else s), lo), hi)
        slow = np.abs(c - ((c + MAGIC) - MAGIC)) > np.float32(0.49996)
        if divide:
            c = np.where(slow, np.fmin(np.fmax(quotient_code(v, s, c), lo), hi), c)
        else:
            slow[:] = False
        return (c + MAGIC) - MAGIC, slow


@pytest.mark.parametrize("seed", range(4))
def test_kernel_division_shortcut_is_exact(seed):
    """The kernel's quantizer equals ``int8_conv_plain``'s, clip(rint(v /
    s)) with the true float32 division (and clip(rint(v * s)) in the static
    scheme), on random values, on values placed within a few ulps of every
    half-integer quotient, where the shortcut must fall back, and on zeros,
    subnormals, huge values and infinities.  NaN is where the two differ:
    the kernel reads it as -inf (code -127), the plain version keeps it."""
    rng = np.random.default_rng(seed)
    scales = rng.uniform(1e-4, 1.0, 8).astype(np.float32).tolist()
    for s in scales + [1e-12, 3e-3, 0.25, 1.0, 2**-20]:
        s = np.float32(s)
        v = (rng.uniform(-130, 130, 200_000).astype(np.float32) * s).astype(np.float32)
        half = (np.arange(-128, 128, dtype=np.float32) + np.float32(0.5)) * s
        near = np.concatenate([np.nextafter(half, np.float32(np.inf * d)) if i else half
                               for d in (1, -1) for i in range(2)] +
                              [half + np.float32(k) * np.spacing(half) for k in range(-6, 7)])
        odd = np.array([0.0, -0.0, 1e-45, -1e-40, 3e38, -3e38, np.inf, -np.inf, np.nan],
                       np.float32)
        v = np.concatenate([v, near.astype(np.float32), odd])
        nan = np.isnan(v)
        for divide, scale in ((True, s), (False, np.float32(1) / s)):
            got, slow = kernel_quant(v, scale, divide)
            assert np.array_equal(plain_quant(v[~nan], scale, divide), got[~nan])
            assert np.isnan(plain_quant(v[nan], scale, divide)).all()
            assert np.array_equal(plain_quant(np.where(nan, -np.inf, v), scale, divide), got)
            if divide:
                assert slow[:200_000].mean() < 1e-3      # random values rarely divide


def plain_quant(v, scale, divide):
    """``int8_conv_plain``'s quantizer on float32 values."""
    x = torch.from_numpy(np.asarray(v, np.float32))
    q = torch.tensor([scale], dtype=torch.float32)
    return torch.clamp(torch.round(x / q if divide else x * q), -k8.QMAX, k8.QMAX).numpy()
