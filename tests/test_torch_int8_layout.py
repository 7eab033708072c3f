"""The int8 conv kernel's weight layout and launch plan, on the CPU.

``csrc/int8_conv.cu`` runs only on the card.  What it reads is chosen in
Python (``ops/kernels/int8_conv.py``): ``pack_weight``'s layout and the
launch plan.  These tests hold both to the kernel's contract, exactly:

* ``pack_weight``, read back in the order in which the kernel consumes it
  (slices of BN output channels, steps of 32 along k = tap * Cp + channel,
  core matrices addressed as the wgmma descriptor addresses them), is
  ``q_w`` again, with zeros in every pad;
* every flagship conv shape, at batches 1, 8 and 32, has a plan that fits
  the 227 KB a block may use, slices that are wgmma widths and cover Cout,
  and a non-empty grid; the plan crosses to C as the struct the kernel
  source declares, field for field;
* the TMA path's rings, driven through every order in which the copies may
  land, hand each consumer warpgroup exactly its own items;
* a mirror in numpy of the kernel's addressing (the tile walk, the TMA box
  or the dense path's aligned row copies, the int8 tile with columns
  grouped by stride, each lane's A fragments, the B descriptor, the
  epilogue's masks) gives the integer conv of the quantized input, equal to
  ``int8_conv_plain``'s, on small shapes with ragged tiles.
"""

import ctypes
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


def b_byte(kb, row, k, bn):
    """Byte offset of B[row, k] of k-step ``kb`` in a slice: the descriptor's
    layout (row stride 16 within a core matrix, LBO between the two k
    halves, SBO between groups of 8 rows)."""
    return kb * bn * 32 + (row // 8) * SBO + (k // 16) * LBO + (row % 8) * 16 + k % 16


def unpack(packed, cout, cin, kh, kw):
    """The kernel's view of ``pack_weight``: [Cout, Cin, kh, kw] from the
    bytes each slice, k-step and row address, and the pads."""
    bn, slices = k8.output_slices(cout)
    cpt = k8.channels_per_tap(cin)
    flat = packed.numpy().reshape(slices, -1)
    kb_n = flat.shape[1] // (bn * 32)
    rows = np.arange(slices * bn)
    ks = np.arange(kb_n * 32)
    idx = b_byte(ks[None, :] // 32, rows[:, None] % bn, ks[None, :] % 32, bn)
    full = flat[rows[:, None] // bn, idx]                     # [slices * bn, K_pad]
    taps = kh * kw
    w = full[:cout, :taps * cpt].reshape(cout, kh, kw, cpt)
    pads = (full[cout:], full[:, taps * cpt:], w[..., cin:])
    return torch.from_numpy(np.ascontiguousarray(w[..., :cin].transpose(0, 3, 1, 2))), pads


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


@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_plan_fits_every_flagship_shape(b, x_dtype):
    for cin, cout, k, stride, h, w, n in flagship_shapes(b):
        p = k8.plan(n, cin, h, w, cout, k, stride, x_dtype, torch.bfloat16)
        assert p.smem <= k8.SMEM_MAX and 1 <= p.stages <= k8.MAX_STAGES
        assert p.rings == (1 if p.dense else 2) and p.rings * p.stages >= 2
        assert p.bn % 8 == 0 and p.bn <= 256
        assert p.bn in k8.N_SINGLE or p.bn % k8.N_WIDE == 0
        assert p.n_slices * p.bn >= cout > (p.n_slices - 1) * p.bn
        assert p.tiles_h * p.th >= p.Ho and p.tiles_w * p.tw >= p.Wo
        assert p.tiles == n * p.tiles_h * p.tiles_w >= 1 and p.n_slices >= 1
        assert p.dense == (cin % 8 != 0) and (p.dense or p.bc in (16, 32))
        # the regions of shared memory do not overlap, in this order
        assert p.w_bytes <= p.off_stage
        assert p.off_stage + p.rings * p.stages * p.stage_bytes <= p.off_aq
        assert p.off_aq + 2 * p.aq_bytes <= p.off_epi
        assert p.off_epi + (4 if p.dense else 8) * 16 * p.epi_pitch <= p.off_par
        assert p.off_par + 8 * p.bn <= p.off_tab
        assert p.off_tab + 4 * (8 * p.k_blocks if p.dense else p.taps) <= p.off_bar
        assert p.off_bar + 8 * (2 * p.rings * p.stages + 1) == p.smem
        assert all(v % 128 == 0 for v in (p.off_stage, p.stage_bytes, p.off_aq, p.aq_bytes))
        assert p.stage_bytes >= p.ih * p.row_bytes and p.epi_pitch % 16 == 0
    # the mask head keeps a third of its 576 channels resident per block
    assert k8.output_slices(576) == (192, 3)


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
    args = k8.plan(2, 32, 9, 17, 32, 3, 1, torch.bfloat16, torch.bfloat16).args()
    assert args.version == version == k8.PLAN_VERSION
    assert args.size == ctypes.sizeof(k8.PlanArgs) == 4 * len(c_fields)


def drive_rings(tiles, slices, stages, rng):
    """The TMA path's producer and two consumer warpgroups as
    ``int8_conv_wgmma_kernel`` runs them, with mbarriers that count
    completed phases (``try_wait.parity`` passes when the phase count's
    parity differs from the one asked for) and copies that land in a
    random order.  Each step, one of the agents that can move does.
    Asserts that a consumer passes its full barrier only when its own item
    lies in the stage with no copy to it in flight; returns the items each
    warpgroup consumed."""
    rings = 2
    full, empty = [0] * (rings * stages), [0] * (rings * stages)
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
            flight.append((stage(*produce[pi]), produce[pi]))
            pi += 1
        elif move == "land":
            s, item = flight.pop(rng.integers(len(flight)))
            landed[s] = item
            full[s] += 1
        else:
            item = consume[move][len(done[move])]
            s = stage(*item)
            assert landed[s] == item and all(f[0] != s for f in flight), (item, landed[s])
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
    th, n = t % p.tiles_h, t // p.tiles_h
    ho0, wo0 = th * p.th, tw * p.tw
    return n, ho0, wo0, ho0 * p.stride - p.pad_t, wo0 * p.stride - p.pad_l


def fragments(p, aq, orow, taps_or_steps, pitch, unit):
    """A [16 pixels, 32 k] of one warp for each tap (TMA path) or k-step
    (dense path), read lane by lane as the kernel's lds32 calls read them."""
    out = []
    for step in taps_or_steps:
        a = np.zeros((16, 32), np.int64)
        for lane in range(32):
            g8, t4 = lane // 4, lane % 4
            arow = (orow * p.stride * p.aw + g8) * pitch
            for j in range(4):                      # a0..a3: (pixel g | g+8) x (k half)
                addr = arow + unit(step, t4, j) + (8 * pitch if j % 2 else 0)
                px, k0 = g8 + 8 * (j % 2), 4 * t4 + 16 * (j // 2)
                a[px, k0:k0 + 4] = aq[addr:addr + 4]
        out.append(a)
    return out


def emulate(x, q_w, qs, stride, divide, base_offset=0):
    """Integer accumulators [N, Ho, Wo, Cout] as the kernel computes them."""
    n, cin, h, w = x.shape
    cout, _, k, _ = q_w.shape
    p = k8.plan(n, cin, h, w, cout, k, stride, x.dtype, torch.bfloat16)
    packed = k8.pack_weight(q_w).numpy().reshape(-1).astype(np.int64)
    xs = x.permute(0, 2, 3, 1).float().numpy()
    qsv = qs.numpy()
    acc = np.zeros((n, p.Ho, p.Wo, cout), np.int64)
    xb = 2 if x.dtype == torch.bfloat16 else 4
    for ns in range(p.n_slices):
        wblk = packed[ns * p.w_bytes:(ns + 1) * p.w_bytes]
        for t in range(p.tiles):
            img, ho0, wo0, hi0, wi0 = tile_of(p, t)
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
                                    q[:ch.size] = quant(xs[img, hh, ww, ch], qscale, divide)
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
                    aq = np.zeros(p.ih * p.aw * k8.PITCH, np.int64)
                    for r in range(p.ih):
                        hh = hi0 + r
                        for col in range(p.iw):
                            ww = wi0 + col
                            for ch in range(32):
                                cc = 32 * c + ch
                                v = 0.0
                                # the TMA box: bc channels, zero outside the tensor
                                if ch < p.bc and 0 <= hh < p.H and 0 <= ww < p.W and cc < cin:
                                    v = xs[img, hh, ww, cc]
                                aq[(r * p.aw + col_pos(p, col)) * k8.PITCH + ch] = quant(
                                    v, qscale, divide)

                    def unit(tap, t4, j):
                        r, s = divmod(tap, p.KS)
                        return ((r * p.aw + col_pos(p, s)) * k8.PITCH + 4 * t4
                                + (16 if j >= 2 else 0))
                    steps = list(range(p.taps))
                    kbs = [tap * p.slices + c for tap in steps]
                    pitch = k8.PITCH
                rows = np.arange(p.bn)
                kk = np.arange(32)
                for orow in range(p.th):
                    for a, kb in zip(fragments(p, aq, orow, steps, pitch, unit), kbs):
                        bmat = wblk[b_byte(kb, rows[:, None], kk[None, :], p.bn)]
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
                        acc[img, ho, wo, c0:c0 + nv] = d[orow, px, :nv]
    return acc


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
    qv = qs.view(-1, 1, 1, 1)
    xq = torch.clamp(torch.round(x.float() / qv if divide else x.float() * qv), -127, 127)
    ph, pw = k8.same_pads(h, k, stride), k8.same_pads(w, k, stride)
    want = F.conv2d(F.pad(xq.double(), (pw[0], pw[1], ph[0], ph[1])), q_w.double(),
                    stride=stride).permute(0, 2, 3, 1).numpy().astype(np.int64)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


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
