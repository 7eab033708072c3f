"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper GPU and ``nvcc``; elsewhere they skip.
They import neither JAX nor the JAX package, so they run on a machine
without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_kernels.py

Tolerances: the ingest is exact, in every colour space and with the input
quantization; so is the int8 conv (integer sums, the same float32
epilogue, one rounding).  The correlation in bf16: at least
99.9 % of values bit-equal to the plain version, and every value within
its Gram band (``correlation_gram_band``: the plain version with each
bf16 Gram value one representable step down or up) plus 1e-5 absolute;
in f32 within 1e-5; exact zeros in the margin.  The kernel and the plain
version round at the same points but sum the f32 Gram value in other
orders (the tensor cores in theirs), so a Gram value can land one step
away, which the division by bf16(sqrt C) and the second rounding carry
to up to two steps of the output; a sum near zero can differ in its
rounding far beyond its own size.  Soft-argmin, channel-last or over a
D-leading cost, at f32 rounding (rtol 1e-5); the D-leading one's vector route bit-equal to its
scalar route (the same arithmetic in the same order).  The backward kernels: in f32
within 1e-5 of the largest magnitude, in bf16 at least 99.9 % within one
bf16 step of the plain version and all within two (their sums run in
another order); the soft-argmin backward's plans (every L and T, and its
scalar route) bit-equal to each other, as they run one routine.  The CLASSIC StereoNet in
float32 on the card against the CPU: disparity 1e-3 px, confidence 1e-4
(the flagship's card-against-CPU bounds in chip_smoke.py; TF32 off).
"""

import numpy as np
import pytest
import torch

from hobot_stereonet_tpu_torch.ops.kernels import build
from hobot_stereonet_tpu_torch.ops.kernels import correlation as kc
from hobot_stereonet_tpu_torch.ops.kernels.correlation import (
    bf16_ulp_distance,
    correlation_gram_band,
    correlation_volume,
    correlation_volume_backward,
    correlation_volume_backward_plain,
    correlation_volume_plain,
    soft_argmin_confidence,
    soft_argmin_confidence_backward,
    soft_argmin_confidence_backward_plain,
    soft_argmin_confidence_plain,
    soft_argmin_cost,
    soft_argmin_cost_backward,
    soft_argmin_cost_backward_plain,
    soft_argmin_cost_plain,
    uses_vector_kernel,
)
from hobot_stereonet_tpu_torch.ops.kernels.int8_conv import (
    int8_conv,
    int8_conv_plain,
    pack_weight,
)
from hobot_stereonet_tpu_torch.ops.kernels.preprocess_kernel import (
    nv12_sbs_preprocess,
    nv12_sbs_preprocess_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.parametrize("b,h,w", [(1, 16, 32), (3, 18, 34), (2, 720, 1280)])
def test_ingest_kernel_exact(device, b, h, w):
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (b, 3 * h * w), dtype=np.uint8))
    n0 = build.launch_counts["nv12_ingest"]
    out = nv12_sbs_preprocess(frames.to(device), h, w)
    torch.cuda.synchronize()
    assert build.launch_counts["nv12_ingest"] == n0 + 1
    assert torch.equal(out.cpu(), nv12_sbs_preprocess_plain(frames, h, w))


@pytest.mark.parametrize("b,h,w,c,d,dtype", [
    (2, 3, 40, 8, 5, torch.float32),
    (4, 24, 33, 32, 24, torch.bfloat16),
    (1, 2, 20, 16, 40, torch.float32),
    (8, 90, 160, 32, 24, torch.bfloat16),      # the main path at B = 8
    (4, 24, 17, 32, 24, torch.bfloat16),       # W < D, a masked tail tile
    (4, 24, 17, 32, 24, torch.float32),
    (4, 24, 40, 32, 6, torch.bfloat16),
    (4, 24, 40, 32, 6, torch.float32),
    (2, 24, 160, 32, 6, torch.bfloat16),
    (2, 24, 160, 32, 24, torch.float32),
    (4, 24, 40, 16, 40, torch.bfloat16),       # D > 25: two chunks of n8 tiles
    (2, 16, 300, 64, 24, torch.bfloat16),      # two column tiles a row
])
def test_correlation_kernel(device, b, h, w, c, d, dtype):
    rng = np.random.default_rng(1)
    fl = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(dtype)
    fr = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(dtype)
    n0 = build.launch_counts["correlation"]
    got = correlation_volume(fl.to(device), fr.to(device), d)
    torch.cuda.synchronize()
    assert build.launch_counts["correlation"] == n0 + 1
    want = correlation_volume_plain(fl.to(device), fr.to(device), d)
    if dtype == torch.bfloat16:
        assert (got == want).float().mean().item() >= 0.999
        lo, hi = correlation_gram_band(fl.to(device), fr.to(device), d)
        assert bool(((got.float() >= lo.float() - 1e-5) & (got.float() <= hi.float() + 1e-5)).all())
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for k in range(min(d, w)):
        np.testing.assert_array_equal(got[:, :, :k, k], 0.0)


def test_correlation_kernel_refuses_what_the_tensor_cores_do_not_take(device):
    for c in (24, 272):
        fl = torch.zeros((1, 2, 16, c), dtype=torch.bfloat16, device=device)
        with pytest.raises(ValueError, match="C % 16"):
            correlation_volume(fl, fl, 4)
    flat = torch.zeros(1 + 2 * 16 * 32, dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="aligned"):
        correlation_volume(flat[1:].view(1, 2, 16, 32), flat[1:].view(1, 2, 16, 32), 4)


@pytest.mark.parametrize("b,h,w,d,dtype", [
    (2, 3, 5, 24, torch.bfloat16),
    (1, 2, 3, 7, torch.float32),
    (8, 90, 160, 24, torch.bfloat16),
    (2, 3, 5, 7, torch.bfloat16),
    (32, 90, 160, 24, torch.bfloat16),
])
def test_soft_argmin_kernel(device, b, h, w, d, dtype):
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(
        (3.0 * rng.standard_normal((b, h, w, d))).astype(np.float32)).to(dtype).to(device)
    assert uses_vector_kernel(logits) == (dtype == torch.bfloat16 and d == 24)
    disp, conf = soft_argmin_confidence(logits, scale=8.0)
    torch.cuda.synchronize()
    want_d, want_c = soft_argmin_confidence_plain(logits, scale=8.0)
    torch.testing.assert_close(disp, want_d, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(conf, want_c, rtol=1e-5, atol=1e-6)


def test_soft_argmin_kernel_on_rows_not_16_byte_aligned(device):
    """A D = 24 bf16 view that starts one element in takes the generic kernel."""
    rng = np.random.default_rng(3)
    shape = (2, 9, 13, 24)
    flat = torch.from_numpy((3.0 * rng.standard_normal(1 + int(np.prod(shape))))
                            .astype(np.float32)).bfloat16().to(device)
    logits = flat[1:].view(shape)
    assert logits.is_contiguous() and not uses_vector_kernel(logits)
    disp, conf = soft_argmin_confidence(logits, scale=8.0)
    torch.cuda.synchronize()
    want_d, want_c = soft_argmin_confidence_plain(logits, scale=8.0)
    torch.testing.assert_close(disp, want_d, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(conf, want_c, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,d,h,w,dtype", [
    (2, 24, 3, 5, torch.bfloat16),
    (2, 24, 3, 5, torch.float32),
    (8, 24, 90, 160, torch.bfloat16),          # the CLASSIC path at B = 8
    (32, 24, 90, 160, torch.bfloat16),
    (3, 7, 9, 13, torch.bfloat16),             # another D: two passes
    (3, 40, 9, 13, torch.float32),
])
def test_soft_argmin_cost_kernel(device, b, d, h, w, dtype):
    rng = np.random.default_rng(4)
    cost = torch.from_numpy(
        (3.0 * rng.standard_normal((b, d, h, w))).astype(np.float32)).to(dtype).to(device)
    n0 = build.launch_counts["soft_argmin_cost"]
    disp, conf = soft_argmin_cost(cost, scale=8.0)
    torch.cuda.synchronize()
    assert build.launch_counts["soft_argmin_cost"] == n0 + 1
    want_d, want_c = soft_argmin_cost_plain(cost, scale=8.0)
    torch.testing.assert_close(disp, want_d, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(conf, want_c, rtol=1e-5, atol=1e-6)


def test_soft_argmin_cost_kernel_refuses_a_strided_cost(device):
    cost = torch.zeros((2, 24, 9, 13), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        soft_argmin_cost(cost.transpose(2, 3), scale=8.0)
    with pytest.raises(ValueError, match="contiguous"):
        soft_argmin_cost(cost[:, ::2], scale=8.0)


@pytest.mark.parametrize("b,h,w,dtype,offset,route", [
    (8, 90, 160, torch.bfloat16, 0, "vector"),     # CLASSIC serving, B = 8
    (32, 90, 160, torch.bfloat16, 0, "vector"),
    (8, 45, 160, torch.bfloat16, 0, "vector"),     # a tile = 2 row tile
    (8, 16, 32, torch.bfloat16, 0, "vector"),      # the training shape
    (3, 13, 9, torch.bfloat16, 0, "scalar"),       # an odd plane
    (8, 90, 160, torch.bfloat16, 1, "scalar"),     # a view 2 bytes into its storage
    (8, 90, 160, torch.float32, 0, "vector"),
    (8, 16, 32, torch.float32, 0, "vector"),
    (3, 13, 9, torch.float32, 0, "scalar"),
    (8, 90, 160, torch.float32, 1, "scalar"),      # 4 bytes in: not 8-byte aligned
])
def test_soft_argmin_cost_kernel_routes(device, b, h, w, dtype, offset, route):
    """Each route where the plan puts it, within f32 rounding of the plain
    version, and the vector route bit-equal to the scalar one."""
    rng = np.random.default_rng(b + h + w)
    n = b * 24 * h * w
    flat = torch.from_numpy((3.0 * rng.standard_normal(n + offset)).astype(np.float32))
    cost = flat.to(dtype).to(device)[offset:].view(b, 24, h, w)
    assert cost.is_contiguous()
    key = f"soft_argmin_cost/{route}"
    n0, r0 = build.launch_counts["soft_argmin_cost"], build.route_counts[key]
    disp, conf = soft_argmin_cost(cost, scale=8.0)
    assert build.launch_counts["soft_argmin_cost"] == n0 + 1
    assert build.route_counts[key] == r0 + 1
    scalar = kc._soft_argmin_cost_launch(cost, 8.0, "scalar")
    torch.cuda.synchronize()
    want_d, want_c = soft_argmin_cost_plain(cost, scale=8.0)
    torch.testing.assert_close(disp, want_d, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(conf, want_c, rtol=1e-5, atol=1e-6)
    assert torch.equal(disp, scalar[0]) and torch.equal(conf, scalar[1])


def test_classic_stereonet_f32_on_the_card_equals_the_cpu(device):
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models import StereoNet
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params, random_flax_params

    cfg = StereoNetConfig(compute_dtype=torch.float32)
    params = random_flax_params(cfg, seed=0, model="classic")
    rng = np.random.default_rng(5)
    left = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 128, 3)).astype(np.float32))
    right = torch.roll(left, -3, dims=2)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        outs = []
        for dev in (device, torch.device("cpu")):
            net = StereoNet(cfg, device=dev)
            net.load_state_dict(from_flax_params(params, cfg, "classic"))
            n0 = build.launch_counts["soft_argmin_cost"]
            with torch.inference_mode():
                o = net.eval()(left.to(dev), right.to(dev))
            assert build.launch_counts["soft_argmin_cost"] == n0 + (dev.type == "cuda")
            outs.append((o["disparity"].cpu(), o["confidence"].cpu()))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (gd, gc), (cd, cc) = outs
    assert torch.isfinite(gd).all()
    torch.testing.assert_close(gd, cd, rtol=0, atol=1e-3)
    torch.testing.assert_close(gc, cc, rtol=0, atol=1e-4)


def _bwd_check(got, want):
    """float32: within 1e-5 of the largest magnitude; bf16: >= 99.9 % of the
    values within one bf16 step of the plain version's, all within two."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
    else:
        ulps = bf16_ulp_distance(got, want)
        assert (ulps <= 1).float().mean().item() >= 0.999 and ulps.max().item() <= 2


@pytest.mark.parametrize("b,h,w,c,d,dtype", [
    (2, 5, 40, 32, 24, torch.bfloat16),
    (1, 3, 17, 16, 24, torch.bfloat16),     # W < D: rows left of every candidate
    (8, 16, 32, 32, 24, torch.bfloat16),    # the training shape
    (8, 90, 160, 32, 24, torch.bfloat16),   # the serving shape
    (2, 5, 40, 32, 24, torch.float32),
    (1, 4, 70, 64, 5, torch.float32),       # two column tiles, another D and C
])
def test_correlation_backward_kernel(device, b, h, w, c, d, dtype):
    g = torch.Generator(device="cpu").manual_seed(b * h + w)
    fl, fr = (torch.randn((b, h, w, c), generator=g).to(device, dtype) for _ in range(2))
    dcorr = torch.randn((b, h, w, d), generator=g).to(device, dtype)
    n0 = build.launch_counts["correlation_bwd"]
    got = correlation_volume_backward(dcorr, fl, fr)
    want = correlation_volume_backward_plain(dcorr, fl, fr)
    torch.cuda.synchronize()
    assert build.launch_counts["correlation_bwd"] == n0 + 1
    for a, p in zip(got, want):
        _bwd_check(a, p)


@pytest.mark.parametrize("b,h,w,c,d,offset,route", [
    (8, 16, 32, 32, 24, 0, "mma"),         # the training shape
    (1, 4, 70, 64, 5, 0, "mma"),           # D % 8 != 0: dcorr staged by 2-byte loads
    (2, 3, 40, 48, 24, 0, "mma"),          # a 16-channel pass after a 32-channel one
    (1, 3, 17, 16, 24, 0, "mma"),          # W < D
    (2, 3, 40, 24, 24, 0, "simt"),         # C % 16 != 0
    (2, 3, 40, 32, 24, 1, "simt"),         # features 2 bytes into their storage
])
def test_correlation_backward_kernel_routes(device, b, h, w, c, d, offset, route):
    g = torch.Generator(device="cpu").manual_seed(w + c + d)

    def view(*shape):
        n = int(np.prod(shape))
        return torch.randn(n + offset, generator=g).to(device, torch.bfloat16)[offset:].view(shape)

    fl, fr, dcorr = view(b, h, w, c), view(b, h, w, c), view(b, h, w, d)
    key = f"correlation_bwd/{route}"
    r0 = build.route_counts[key]
    got = correlation_volume_backward(dcorr, fl, fr)
    torch.cuda.synchronize()
    assert build.route_counts[key] == r0 + 1
    for a, p in zip(got, correlation_volume_backward_plain(dcorr, fl, fr)):
        _bwd_check(a, p)


def test_correlation_backward_kernel_is_deterministic(device):
    """No atomics: two bf16 calls give the same bits."""
    g = torch.Generator(device="cpu").manual_seed(19)
    fl, fr = (torch.randn((8, 90, 160, 32), generator=g).to(device, torch.bfloat16)
              for _ in range(2))
    dcorr = torch.randn((8, 90, 160, 24), generator=g).to(device, torch.bfloat16)
    r0 = build.route_counts["correlation_bwd/mma"]
    first = correlation_volume_backward(dcorr, fl, fr)
    second = correlation_volume_backward(dcorr, fl, fr)
    torch.cuda.synchronize()
    assert build.route_counts["correlation_bwd/mma"] == r0 + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_cost_kernels_refuse_a_route_that_does_not_fit(device):
    """The wrappers pick each route; the C side only checks it: a vector
    soft-argmin on an odd plane and a tensor-core backward in float32 return
    cudaErrorInvalidValue (1) and launch nothing."""
    cost = torch.randn((2, 24, 3, 5), device=device).bfloat16()
    n0 = dict(build.route_counts)
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        kc._soft_argmin_cost_launch(cost, 8.0, "vector")
    assert dict(build.route_counts) == n0
    fl, fr = (torch.randn((2, 3, 40, 32), device=device) for _ in range(2))
    dcorr = torch.randn((2, 3, 40, 24), device=device)
    dfl, dfr = torch.empty_like(fl), torch.empty_like(fr)
    err = build.library().hst_correlation_backward(
        dcorr.data_ptr(), fl.data_ptr(), fr.data_ptr(), dfl.data_ptr(), dfr.data_ptr(),
        2, 3, 40, 32, 24, 1.0, 0, 1, build.stream_handle(fl))
    assert err == 1


@pytest.mark.parametrize("with_gc", [False, True])
@pytest.mark.parametrize("d,dtype", [(24, torch.bfloat16), (24, torch.float32),
                                     (4, torch.bfloat16), (33, torch.float32)])
def test_soft_argmin_backward_kernels(device, d, dtype, with_gc):
    """Both layouts, with ties in the max and with and without a confidence
    cotangent; D = 24 on the staged route, other D on the scalar one."""
    g = torch.Generator(device="cpu").manual_seed(d)
    b, h, w = 3, 9, 13
    logits = 3.0 * torch.randn((b, h, w, d), generator=g)
    logits[0, :, :, 1] = logits[0, :, :, d - 1] = logits[0].amax(-1) + 1.0
    logits = logits.to(device, dtype)
    gd = torch.randn((b, h, w), generator=g).to(device)
    gc = torch.randn((b, h, w), generator=g).to(device) if with_gc else None
    cost = -logits.permute(0, 3, 1, 2).contiguous()
    n0, r0 = dict(build.launch_counts), dict(build.route_counts)
    got = soft_argmin_confidence_backward(logits, gd, gc, 8.0)
    got_cost = soft_argmin_cost_backward(cost, gd, gc, 8.0)
    torch.cuda.synchronize()
    # D-leading at D = 24: the plane 9 x 13 = 117 takes no tile of whole 16-byte rows.
    routes = {"soft_argmin_bwd": "staged" if d == 24 else "scalar",
              "soft_argmin_cost_bwd": "scalar"}
    for name, route in routes.items():
        assert build.launch_counts[name] == n0.get(name, 0) + 1
        key = f"{name}/{route}"
        assert build.route_counts[key] == r0.get(key, 0) + 1
    _bwd_check(got, soft_argmin_confidence_backward_plain(logits, gd, gc, 8.0))
    _bwd_check(got_cost, soft_argmin_cost_backward_plain(cost, gd, gc, 8.0))


def _sa_bwd_inputs(b, h, w, dtype, device, seed):
    """Logits [b, h, w, 24] with ties in the max at every third pixel and
    near ties at every seventh, the matching cost [b, 24, h, w], and the
    cotangents gd, gc."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    logits = 3.0 * torch.randn((b, h, w, 24), generator=g)
    flat = logits.view(-1, 24)
    flat[::3, 2] = flat[::3, 17] = flat[::3].amax(-1) + 1.0
    near = flat[1::7]                   # a max of 1, candidates one and two float32 steps below
    near -= near.amax(-1, keepdim=True) + 2.0
    near[:, 5], near[:, 9], near[:, 20] = 1.0, 1.0 - 2.0 ** -24, 1.0 - 2.0 ** -23
    logits = logits.to(device, dtype)
    gd, gc = (torch.randn((b, h, w), generator=g).to(device) for _ in range(2))
    return logits, (-logits).permute(0, 3, 1, 2).contiguous(), gd, gc


# (B, h, w): the sharded training step's tiles, the training shape, a plane of
# 16-byte rows (D-leading staged) whose pixel count is not a multiple of the
# channel-last tile (a short last tile), and serving at B = 8.
SA_BWD_SHAPES = [(2, 16, 32), (4, 8, 32), (8, 16, 32), (3, 5, 40), (8, 90, 160)]


@pytest.mark.parametrize("with_gc", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w", SA_BWD_SHAPES)
def test_soft_argmin_backward_staged_route(device, b, h, w, dtype, with_gc):
    """Both layouts on the staged route at the main path's shapes and the
    sharded step's tiles, against the plain version, two calls bit-equal."""
    logits, cost, gd, gc = _sa_bwd_inputs(b, h, w, dtype, device, b + h + w)
    gc = gc if with_gc else None
    for name, fn, plain, x in (
            ("soft_argmin_bwd", soft_argmin_confidence_backward,
             soft_argmin_confidence_backward_plain, logits),
            ("soft_argmin_cost_bwd", soft_argmin_cost_backward, soft_argmin_cost_backward_plain,
             cost)):
        r0 = build.route_counts[f"{name}/staged"]
        first, second = fn(x, gd, gc, 8.0), fn(x, gd, gc, 8.0)
        torch.cuda.synchronize()
        assert build.route_counts[f"{name}/staged"] == r0 + 2
        assert torch.equal(first, second)
        _bwd_check(first, plain(x, gd, gc, 8.0))


def test_soft_argmin_backward_short_last_tile(device):
    """Channel-last: 105 pixels, so the last tile holds fewer rows than the
    others; its rows equal the plain version's and those of a batch where
    the same pixels lie inside a whole tile."""
    logits, _, gd, gc = _sa_bwd_inputs(3, 5, 7, torch.bfloat16, device, 5)
    plan = kc.soft_argmin_backward_plan(kc.CHANNEL_LAST, 3, 24, 35, logits.data_ptr(), 2, True)
    assert plan.route == "staged" and 105 % plan.pixels
    big = torch.full((4, 5, 7, 24), 7.0, dtype=torch.bfloat16, device=device)
    got = soft_argmin_confidence_backward(logits, gd, gc, 8.0)
    _bwd_check(got, soft_argmin_confidence_backward_plain(logits, gd, gc, 8.0))
    # A larger batch whose first three samples are the same: the same bits.
    big[:3] = logits
    gd4, gc4 = torch.cat([gd, gd[:1]]), torch.cat([gc, gc[:1]])
    assert torch.equal(soft_argmin_confidence_backward(big, gd4, gc4, 8.0)[:3], got)


@pytest.mark.parametrize("with_gc", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_soft_argmin_backward_every_plan_is_bit_equal(device, dtype, with_gc):
    """Every staged plan of L lanes and T pixels that fits, and the scalar
    route, give the default plan's bits: the same operations in the same
    order."""
    b, h, w = 2, 16, 32
    logits, cost, gd, gc = _sa_bwd_inputs(b, h, w, dtype, device, 11)
    gc = gc if with_gc else None
    for name, layout, x, fn in (
            ("soft_argmin_bwd", kc.CHANNEL_LAST, logits, soft_argmin_confidence_backward),
            ("soft_argmin_cost_bwd", kc.D_LEADING, cost, soft_argmin_cost_backward)):
        want = fn(x, gd, gc, 8.0)
        scalar = kc.BackwardPlan("scalar", 1, 256, 256, (4, 1) if layout == kc.CHANNEL_LAST
                                 else (2, b), 0)
        plans = [scalar]
        for lanes in kc.BWD_LANES:
            for t in kc.BWD_TILES:
                try:
                    plans.append(kc.soft_argmin_backward_plan(
                        layout, b, 24, h * w, x.data_ptr(), x.element_size(), with_gc,
                        lanes=lanes, pixels=t))
                except ValueError:
                    pass
        assert len(plans) > 10
        for plan in plans:
            got = kc._soft_argmin_backward_launch(name, x, gd, gc, 8.0, (b, h, w),
                                                  (b, 24, h * w), plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), plan


def test_soft_argmin_backward_refuses_a_plan_that_does_not_fit(device):
    """The wrapper plans; the C side only checks: a staged plan with the
    wrong grid, shared bytes or lanes, on D != 24, or on an input 2 bytes
    into its storage returns cudaErrorInvalidValue (1) and counts nothing."""
    logits, cost, gd, _ = _sa_bwd_inputs(2, 16, 32, torch.bfloat16, device, 3)
    plan = kc.soft_argmin_backward_plan(kc.D_LEADING, 2, 24, 512, cost.data_ptr(), 2, False)
    assert plan.route == "staged"
    odd = torch.zeros(cost.numel() + 1, dtype=torch.bfloat16, device=device)[1:].view(cost.shape)
    d4 = torch.zeros((2, 4, 16, 32), dtype=torch.bfloat16, device=device)
    bad = [(cost, plan._replace(grid=(plan.grid[0] + 1, plan.grid[1]))),
           (cost, plan._replace(smem=plan.smem + 16)), (cost, plan._replace(lanes=3)),
           (cost, plan._replace(threads=2 * plan.threads)), (odd, plan), (d4, plan)]
    n0 = dict(build.route_counts)
    for x, p in bad:
        with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
            kc._soft_argmin_backward_launch("soft_argmin_cost_bwd", x, gd, None, 8.0, (2, 16, 32),
                                            (2, x.shape[1], 512), plan=p)
    cl = kc.soft_argmin_backward_plan(kc.CHANNEL_LAST, 2, 24, 512, logits.data_ptr(), 2, False)
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        kc._soft_argmin_backward_launch("soft_argmin_bwd", logits, gd, None, 8.0, (2, 16, 32),
                                        (2, 24, 512), plan=cl._replace(pixels=cl.pixels // 2))
    assert dict(build.route_counts) == n0


@pytest.mark.parametrize("model", ["fast", "classic"])
def test_training_gradients_on_the_card_reach_every_parameter_and_equal_the_cpu(device, model):
    """``loss.backward()`` through the network on the card reaches every
    parameter through the kernels' backward and equals the CPU's gradients
    (float32, TF32 off; ``reference.grad_mismatches`` at 1e-3: a LeakyReLU
    input near zero may take the other branch on the other device)."""
    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models import build_model
    from hobot_stereonet_tpu_torch.runtime.training import multiscale_loss
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params, random_flax_params

    cfg = StereoNetConfig(compute_dtype=torch.float32, num_feature_res_blocks=2,
                          num_aggregation_layers=2)
    params = from_flax_params(random_flax_params(cfg, seed=3, model=model), cfg, model)
    rng = np.random.default_rng(9)
    left = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 128, 3)).astype(np.float32))
    right = torch.roll(left, -5, dims=2)
    gt = torch.from_numpy(rng.uniform(1, 40, (2, 64, 128)).astype(np.float32))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        grads = []
        for dev in (device, torch.device("cpu")):
            net = build_model(model, cfg, dev)
            net.load_state_dict(params)
            loss, _ = multiscale_loss(net(left.to(dev), right.to(dev)), gt.to(dev))
            loss.backward()
            grads.append({k: p.grad for k, p in net.named_parameters()})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    card, cpu = grads
    assert all(g is not None for g in card.values())
    tower = [k for k in card if k.startswith("FeatureTower_0")]
    assert tower and all(card[k].abs().max().item() > 0 for k in tower if "bias" not in k)
    bad = reference.grad_mismatches({k: v.cpu().numpy() for k, v in card.items()},
                                    {k: v.numpy() for k, v in cpu.items()}, 1e-3)
    assert not bad, bad


def test_serving_forward_launches_no_backward(device):
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models import FastStereoNet

    cfg = StereoNetConfig(num_feature_res_blocks=1, num_aggregation_layers=1)
    net = FastStereoNet(cfg, device=device).eval()
    x = torch.rand((2, 64, 128, 3), device=device)
    build.reset_launch_counts()
    with torch.inference_mode():
        net(x, x)
    torch.cuda.synchronize()
    from hobot_stereonet_tpu_torch.models.layers import GroupNorm

    groupnorms = sum(isinstance(m, GroupNorm) for m in net.modules())
    assert dict(build.launch_counts) == {"correlation": 1, "soft_argmin": 1,
                                         "group_norm": groupnorms}


def _small_engine(device, **engine):
    from hobot_stereonet_tpu_torch.config import (
        CameraConfig, Config, EngineConfig, PreprocessConfig, StereoNetConfig)
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine

    cfg = Config(camera=CameraConfig(width=128, height=64),
                 model=StereoNetConfig(feature_channels=16, num_feature_res_blocks=1,
                                       num_aggregation_layers=1, aggregation_channels=16,
                                       max_disparity=48, compute_dtype=torch.float32),
                 preprocess=PreprocessConfig(color_space="yuv"),
                 engine=EngineConfig(max_batch=4, batch_buckets=(1, 4), drop_on_full=False,
                                     **engine))
    return StereoEngine(cfg, emit_confidence=True, device=device)


def test_ring_gather_waits_for_the_rings_staging_copy(device):
    """The engine gathers on its own stream; a ring written late on the
    default stream must still be read after that write (``ring.ready``)."""
    from hobot_stereonet_tpu_torch.data.stream import DeviceFrameRing

    eng = _small_engine(device)
    ring = DeviceFrameRing(height=64, width=128, ring_size=2, device=device)
    new = torch.randint(0, 256, tuple(ring.data.shape), dtype=torch.uint8).to(device)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)             # the default stream is busy ~50 ms
    ring.data.copy_(new)
    ring.ready.record()
    with torch.cuda.stream(eng._stream):
        batch = eng._to_device((ring, [1, 0]))
    torch.cuda.synchronize()
    assert torch.equal(batch, new[[1, 0]])


def test_device_results_read_on_another_stream(device):
    from hobot_stereonet_tpu_torch.data.stream import DeviceFrameRing
    from hobot_stereonet_tpu_torch.runtime.engine import DeviceBatchView

    eng = _small_engine(device, fetch_results=False)
    ring = DeviceFrameRing(height=64, width=128, ring_size=3, device=device)
    res = sorted(eng.run_stream(list(ring.frames(4)), timeout=120.0), key=lambda r: r.index)
    assert [r.index for r in res] == [0, 1, 2, 3]
    want = eng.pipeline(ring.data[[0, 1, 2, 0]])[0].cpu()
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        rows = [r.disparity.device_array() * 1.0 for r in res]
    side.synchronize()
    for r, row in zip(res, rows):
        assert isinstance(r.disparity, DeviceBatchView)
        assert torch.equal(row.cpu(), want[r.index])
        assert np.array_equal(np.asarray(r.disparity), want[r.index].numpy())


def test_groupnorm_on_the_card_is_batch_independent_and_equals_the_cpu(device):
    from hobot_stereonet_tpu_torch.models.layers import GroupNorm

    torch.manual_seed(0)
    gn = GroupNorm(32)
    with torch.no_grad():
        gn.weight.uniform_(0.5, 1.5)
        gn.bias.uniform_(-0.5, 0.5)
    x = (torch.randn(32, 32, 90, 160) * 3 + 5).bfloat16().contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        cpu = gn(x)
        gpu = gn.to(device)
        xd = x.to(device)
        whole = gpu(xd)
        chunks = torch.cat([gpu(c) for c in xd.split(8)])
        single = gpu(xd[:1])
    assert torch.equal(whole, chunks) and torch.equal(whole[:1], single)
    assert (whole.cpu() == cpu).float().mean().item() >= 0.99999


@pytest.mark.parametrize("rgb,quantize", [(True, False), (True, True), (False, True)])
@pytest.mark.parametrize("b,h,w", [(3, 18, 34), (2, 720, 1280)])
def test_ingest_kernel_modes_exact(device, b, h, w, rgb, quantize):
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.integers(0, 256, (b, 3 * h * w), dtype=np.uint8))
    n0 = build.launch_counts["nv12_ingest"]
    out = nv12_sbs_preprocess(frames.to(device), h, w, rgb=rgb, quantize=quantize)
    torch.cuda.synchronize()
    assert build.launch_counts["nv12_ingest"] == n0 + 1
    want = nv12_sbs_preprocess_plain(frames, h, w, rgb=rgb, quantize=quantize)
    assert out.dtype == want.dtype and torch.equal(out.cpu(), want)


def _int8_case(rng, n, cin, cout, k, h, w, x_dtype, device):
    x = torch.from_numpy((2.0 * rng.standard_normal((n, h, w, cin))).astype(np.float32))
    x = x.to(x_dtype).to(device).permute(0, 3, 1, 2)
    q_w = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8)).to(device)
    s_k = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(device)
    return x, q_w, s_k, bias


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("n,cin,cout,k,stride,h,w,x_dtype,out_dtype", [
    (2, 3, 32, 5, 2, 72, 128, torch.float32, torch.bfloat16),     # the tower's first conv
    (2, 3, 32, 5, 2, 17, 30, torch.bfloat16, torch.float32),
    (2, 32, 32, 5, 2, 36, 64, torch.bfloat16, torch.bfloat16),
    (3, 32, 32, 3, 1, 18, 34, torch.bfloat16, torch.bfloat16),
    (2, 56, 64, 3, 1, 12, 20, torch.bfloat16, torch.bfloat16),    # aggregation's first
    (2, 64, 24, 3, 1, 12, 20, torch.bfloat16, torch.bfloat16),
    (2, 64, 576, 3, 1, 9, 16, torch.bfloat16, torch.bfloat16),    # the mask head
    (2, 16, 8, 3, 1, 7, 9, torch.float32, torch.float32),
])
def test_int8_conv_kernel_exact(device, n, cin, cout, k, stride, h, w, x_dtype, out_dtype,
                                static):
    rng = np.random.default_rng(5)
    x, q_w, s_k, bias = _int8_case(rng, n, cin, cout, k, h, w, x_dtype, device)
    if static:
        sx = torch.tensor([0.05], device=device)
        qs = torch.tensor([1.0], device=device) / sx
    else:
        sx = qs = torch.from_numpy(rng.uniform(0.01, 0.05, n).astype(np.float32)).to(device)
    n0 = build.launch_counts["int8_conv"]
    kw = dict(stride=stride, divide=not static, out_dtype=out_dtype)
    got = int8_conv(x, q_w, pack_weight(q_w), s_k, bias, sx, qs, **kw)
    torch.cuda.synchronize()
    assert build.launch_counts["int8_conv"] == n0 + 1
    want = int8_conv_plain(x, q_w, s_k, bias, sx, qs, **kw)
    assert got.shape == want.shape == (n, cout, -(-h // stride), -(-w // stride))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("n,cin,cout,k,stride,h,w,x_dtype,out_dtype,offset", [
    (1, 32, 32, 3, 1, 18, 34, torch.bfloat16, torch.bfloat16, 0),     # one image
    (40, 32, 32, 3, 1, 9, 12, torch.bfloat16, torch.bfloat16, 0),     # walks cross images
    (2, 32, 32, 3, 1, 45, 37, torch.bfloat16, torch.bfloat16, 0),     # ragged tiles
    (2, 32, 32, 5, 2, 45, 37, torch.bfloat16, torch.float32, 0),      # ragged, stride 2
    (1, 64, 576, 3, 1, 90, 160, torch.bfloat16, torch.bfloat16, 0),   # the mask head
    (2, 64, 24, 3, 1, 90, 160, torch.bfloat16, torch.bfloat16, 0),    # aggregation Conv_0
    (2, 56, 64, 3, 1, 45, 37, torch.bfloat16, torch.bfloat16, 0),     # zero-filled channels
    (2, 3, 32, 5, 2, 17, 30, torch.bfloat16, torch.bfloat16, 0),      # rows TMA cannot take
    (2, 3, 32, 5, 2, 17, 30, torch.float32, torch.bfloat16, 0),
    (2, 3, 32, 5, 2, 17, 30, torch.float32, torch.bfloat16, 1),       # input not 16-byte aligned
    (2, 32, 200, 3, 1, 12, 20, torch.bfloat16, torch.bfloat16, 0),    # slices of 128 past Cout
    (2, 32, 40, 3, 1, 12, 20, torch.float32, torch.float32, 0),       # a slice of 48 past Cout
    (2, 32, 32, 5, 2, 36, 64, torch.float32, torch.float32, 0),       # the largest stages
])
def test_int8_conv_kernel_edges(device, n, cin, cout, k, stride, h, w, x_dtype, out_dtype,
                                offset, static):
    """Cases the persistent, TMA-fed kernel could get wrong: one image, many
    images with a scale each, tiles past the output's edge, wide and narrow
    slices of output channels, zero-filled channels, the dense path's
    unaligned rows and input, float32 stages of a 5x5 stride-2 halo."""
    rng = np.random.default_rng(6)
    x, q_w, s_k, bias = _int8_case(rng, n, cin, cout, k, h, w, x_dtype, device)
    if offset:
        flat = torch.zeros(x.numel() + offset, dtype=x_dtype, device=device)
        flat[offset:] = x.permute(0, 2, 3, 1).reshape(-1)
        x = flat[offset:].view(n, h, w, cin).permute(0, 3, 1, 2)
        assert x.data_ptr() % 16 and x.is_contiguous(memory_format=torch.channels_last)
    if static:
        sx = torch.tensor([0.05], device=device)
        qs = torch.tensor([1.0], device=device) / sx
    else:
        sx = qs = torch.from_numpy(rng.uniform(0.01, 0.05, n).astype(np.float32)).to(device)
    n0 = build.launch_counts["int8_conv"]
    kw = dict(stride=stride, divide=not static, out_dtype=out_dtype)
    got = int8_conv(x, q_w, pack_weight(q_w), s_k, bias, sx, qs, **kw)
    torch.cuda.synchronize()
    assert build.launch_counts["int8_conv"] == n0 + 1
    want = int8_conv_plain(x, q_w, s_k, bias, sx, qs, **kw)
    assert got.shape == want.shape == (n, cout, -(-h // stride), -(-w // stride))
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("n,cin,cout,depth,h,w,dilation,rows,x_dtype", [
    (2, 32, 32, 0, 45, 37, 2, None, torch.bfloat16),     # 8-row tiles, ragged
    (2, 32, 32, 0, 45, 37, 2, 4, torch.bfloat16),        # 4-row tiles
    (2, 16, 16, 0, 30, 70, 4, None, torch.float32),      # 16-channel box
    (2, 32, 32, 0, 19, 35, 8, None, torch.bfloat16),     # SAME pads of 8 on every side
    (2, 32, 32, 0, 19, 35, 8, 4, torch.bfloat16),
    (3, 16, 8, 0, 9, 20, 8, None, torch.bfloat16),       # the narrowest slice, halo > image
    (2, 64, 24, 0, 12, 20, 4, None, torch.bfloat16),     # two channel slices, 4-row tiles
    (2, 32, 32, 3, 6, 17, 1, None, torch.bfloat16),      # 3-D, both depth edges a tile
    (2, 32, 8, 5, 9, 18, 1, None, torch.bfloat16),       # 3-D, Cout 8
    (2, 32, 32, 1, 6, 17, 1, None, torch.bfloat16),      # 3-D, one plane: two zero planes
    (3, 16, 16, 4, 10, 33, 1, None, torch.float32),      # 3-D, Cin 16, float32
    (2, 32, 16, 4, 10, 9, 1, 8, torch.bfloat16),         # 3-D, 8-row tiles
    (2, 8, 8, 3, 7, 21, 1, None, torch.bfloat16),        # 3-D, an 8-channel box
    (2, 8, 8, 0, 13, 21, 2, None, torch.bfloat16),       # dilated, an 8-channel box
])
def test_int8_conv_kernel_dilated_and_3d(device, n, cin, cout, depth, h, w, dilation, rows,
                                         x_dtype, static):
    """The kernel's dilated and 3-D taps against the plain version, bit for
    bit: wide halos past every edge, the depth edges' zero planes, both
    tile heights (``rows``: a plan other than the default, launched as the
    wrapper launches it)."""
    from hobot_stereonet_tpu_torch.ops.kernels import int8_conv as k8

    rng = np.random.default_rng(7 + depth + dilation)
    spatial = ((depth,) if depth else ()) + (h, w)
    kernel = (3,) * len(spatial)
    x = torch.from_numpy((2.0 * rng.standard_normal((n,) + spatial + (cin,))).astype(np.float32))
    x = x.to(x_dtype).to(device).movedim(-1, 1)
    q_w = torch.from_numpy(rng.integers(-127, 128, (cout, cin) + kernel, dtype=np.int8)).to(device)
    s_k = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(device)
    if static:
        sx = torch.tensor([0.05], device=device)
        qs = torch.tensor([1.0], device=device) / sx
    else:
        sx = qs = torch.from_numpy(rng.uniform(0.01, 0.05, n).astype(np.float32)).to(device)
    kw = dict(stride=1, dilation=dilation, divide=not static, out_dtype=torch.bfloat16)
    packed = pack_weight(q_w)
    n0 = build.launch_counts["int8_conv"]
    if rows is None:
        got = int8_conv(x, q_w, packed, s_k, bias, sx, qs, **kw)
    else:
        args = k8.plan(n, cin, h, w, cout, 3, 1, x_dtype, torch.bfloat16, dilation, depth,
                       rows).args()
        got = k8._launch(x, packed, s_k, bias, sx, qs, not static, torch.bfloat16, args)
    torch.cuda.synchronize()
    assert build.launch_counts["int8_conv"] == n0 + 1
    want = int8_conv_plain(x, q_w, s_k, bias, sx, qs, **kw)
    assert got.shape == want.shape == (n, cout) + spatial
    assert got.is_contiguous(memory_format=k8.memory_format(x.dim()))
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("cin,cout,k,stride", [(64, 64, 3, 1), (32, 32, 5, 2), (56, 576, 3, 1)])
def test_int8_conv_kernel_large_accumulators(device, cin, cout, k, stride):
    """Every code at +-127 against weights of +-127: accumulators past 2^22,
    where float32 no longer holds every integer, rounded as the plain
    version rounds them."""
    n, h, w = 2, 12, 20
    x = torch.full((n, h, w, cin), 10.0, device=device)
    x[1] = -10.0
    x = x.permute(0, 3, 1, 2)
    q_w = torch.full((cout, cin, k, k), 127, dtype=torch.int8, device=device)
    q_w[cout // 2:] = -127
    s_k = torch.full((cout,), 1e-3, device=device)
    bias = torch.zeros(cout, device=device)
    sx = qs = torch.tensor([0.01, 0.02], device=device)
    kw = dict(stride=stride, divide=True, out_dtype=torch.float32)
    got = int8_conv(x, q_w, pack_weight(q_w), s_k, bias, sx, qs, **kw)
    want = int8_conv_plain(x, q_w, s_k, bias, sx, qs, **kw)
    torch.cuda.synchronize()
    assert 127 * 127 * cin * k * k >= 1 << 22
    assert torch.equal(got, want), (got - want).abs().max().item()


def _identity_case(n, cin, k, h, w, x, device):
    """x [N, H, W, Cin] through the centre tap's identity (Cout = Cin
    rounded up to 8), s_k = sx = 1 and no bias: each output is the code of
    one input value, as float32."""
    cout = -(-cin // 8) * 8
    q_w = torch.zeros((cout, cin, k, k), dtype=torch.int8)
    q_w[torch.arange(cin), torch.arange(cin), k // 2, k // 2] = 1
    x = x.to(device).permute(0, 3, 1, 2)
    return x, q_w.to(device), torch.ones(cout, device=device), torch.zeros(cout, device=device)


QUOTIENT_CASES = [
    (32, 3, 1, torch.float32),      # the TMA path's quantize_stage
    (64, 3, 1, torch.bfloat16),
    (3, 3, 1, torch.float32),       # the dense path's quantize_rows
    (3, 5, 2, torch.bfloat16),      # the tower's first conv
]


@pytest.mark.parametrize("cin,k,stride,x_dtype", QUOTIENT_CASES)
def test_int8_conv_kernel_near_half_integer_quotients(device, cin, k, stride, x_dtype):
    """The dynamic scheme divides by multiplying with RN(1/s) and places a
    value whose quotient lies within 4e-5 of a half-integer exactly
    (``quantize_n``, ``quotient_code``).  Values at and within a few ulps
    (of the input's type) of every half-integer quotient, for a scale per
    sample (powers of two among them: exact ties), are coded as
    ``int8_conv_plain`` codes them, bit for bit."""
    rng = np.random.default_rng(7)
    scales = np.array([0.0123, 1 / 3, 2.0 ** -7, 7.77e-3, 1.0, 0.5 ** 20, 0.75 * 2.0 ** -5,
                       0.625 * 2.0 ** -3], np.float32)
    n, h, w = scales.size, 18, 34
    half = np.arange(-128, 128, dtype=np.float32) + np.float32(0.5)
    x = np.empty((n, h * w * cin), np.float32)
    for i, s in enumerate(scales):
        v = torch.from_numpy(half * s).to(x_dtype)
        near = [v]
        for d in (1, -1):
            u = v
            for _ in range(4):
                u = _step(u, d)
                near.append(u)
        x[i] = rng.permutation(np.resize(torch.cat(near).float().numpy(), x.shape[1]))
    q = x / scales[:, None]
    close = np.mean(np.abs(q - np.rint(q)) > 0.49996)
    assert close > (0.9 if x_dtype == torch.float32 else 0.1)    # they reach the exact path
    x = torch.from_numpy(x.reshape(n, h, w, cin)).to(x_dtype)
    x, q_w, s_k, bias = _identity_case(n, cin, k, h, w, x, device)
    sx = torch.ones(n, device=device)
    qs = torch.from_numpy(scales).to(device)
    kw = dict(stride=stride, divide=True, out_dtype=torch.float32)
    got = int8_conv(x, q_w, pack_weight(q_w), s_k, bias, sx, qs, **kw)
    want = int8_conv_plain(x, q_w, s_k, bias, sx, qs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


def _step(u, d):
    """The values of u's type next to u (nonzero) towards d * inf."""
    bits = u.view(torch.int16 if u.dtype == torch.bfloat16 else torch.int32)
    return torch.where((bits >= 0) == (d > 0), bits + 1, bits - 1).view(u.dtype)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("cin,k,stride,x_dtype", QUOTIENT_CASES)
def test_int8_conv_kernel_reads_nan_as_minus_inf(device, cin, k, stride, x_dtype, static):
    """NaN is the one input where the kernel and ``int8_conv_plain``
    differ: the kernel codes it -127, as it codes -inf (``fmaxf`` clips
    it), where the plain version carries NaN into the output.  So the
    kernel on x equals the plain version on x with NaN replaced by -inf."""
    rng = np.random.default_rng(8)
    n, h, w = 2, 12, 20
    x = (2.0 * rng.standard_normal((n, h, w, cin))).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[0, 0, 0, 0], x[1, 1, 1, 0] = np.inf, -np.inf
    x = torch.from_numpy(x).to(x_dtype)
    x, q_w, s_k, bias = _identity_case(n, cin, k, h, w, x, device)
    if static:
        sx, qs = torch.ones(1, device=device), torch.tensor([40.0], device=device)
    else:
        sx, qs = torch.ones(n, device=device), torch.tensor([0.02, 0.03], device=device)
    kw = dict(stride=stride, divide=not static, out_dtype=torch.float32)
    got = int8_conv(x, q_w, pack_weight(q_w), s_k, bias, sx, qs, **kw)
    plain = int8_conv_plain(x, q_w, s_k, bias, sx, qs, **kw)
    want = int8_conv_plain(x.masked_fill(x.isnan(), -np.inf), q_w, s_k, bias, sx, qs, **kw)
    torch.cuda.synchronize()
    assert plain.isnan().any() and not got.isnan().any()
    assert torch.equal(got, want), int((got != want).sum())


# ---------------------------------------------------------------------------
# GroupNorm (ops/kernels/group_norm.py, csrc/group_norm.cu): bit for bit
# ---------------------------------------------------------------------------

GN_CASES = [  # (N, C, spatial, dtype): the networks' channel counts, 2-D and
    # 3-D, odd spatial sizes (rows not 16-byte aligned), a size below 1024
    (3, 32, (90, 160), torch.bfloat16),
    (2, 64, (90, 160), torch.bfloat16),
    (5, 12, (45, 80), torch.bfloat16),
    (3, 12, (31, 33), torch.bfloat16),
    (3, 16, (33, 41), torch.bfloat16),
    (2, 32, (4, 18, 34), torch.bfloat16),
    (1, 8, (5, 7), torch.bfloat16),
    (2, 32, (30, 40), torch.float32),
    (3, 12, (31, 33), torch.float32),
]


def _gn_case(n, c, spatial, dtype, seed=0):
    from hobot_stereonet_tpu_torch.models.layers import num_groups

    rng = np.random.default_rng(seed)
    fmt = torch.channels_last_3d if len(spatial) == 3 else torch.channels_last
    x = torch.from_numpy((3 * rng.standard_normal((n, c) + spatial) + 5).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(np.float32))
    return x.to(dtype).contiguous(memory_format=fmt), num_groups(c), w, b


@pytest.mark.parametrize("n,c,spatial,dtype", GN_CASES)
def test_group_norm_kernel_equals_plain(device, n, c, spatial, dtype):
    from hobot_stereonet_tpu_torch.ops.kernels.group_norm import group_norm, group_norm_plain

    x, g, w, b = _gn_case(n, c, spatial, dtype)
    n0 = build.launch_counts["group_norm"]
    with torch.inference_mode():
        got = group_norm(x.to(device), g, w.to(device), b.to(device), 1e-6)
    torch.cuda.synchronize()
    assert build.launch_counts["group_norm"] == n0 + 1
    want, _, _ = group_norm_plain(x, g, w, b, 1e-6)
    assert got.dtype == dtype and got.stride() == x.stride()
    assert torch.equal(got.cpu(), want), float((got.cpu() != want).float().mean())


def test_group_norm_kernel_statistics_and_views(device):
    """mean and rstd bit for bit; a sample at an offset that is not 16-byte
    aligned (C = 12 bf16, odd size) gives the same bits as alone."""
    from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg

    x, g, w, b = _gn_case(4, 12, (31, 33), torch.bfloat16, seed=1)
    xd, wd, bd = x.to(device), w.to(device), b.to(device)
    y, mean, rstd = kg._group_norm_cuda(xd, g, wd, bd, 1e-6)
    tail, _, _ = kg._group_norm_cuda(xd[1:], g, wd, bd, 1e-6)
    torch.cuda.synchronize()
    _, m_plain, r_plain = kg.group_norm_plain(x, g, w, b, 1e-6)
    assert torch.equal(mean.cpu(), m_plain) and torch.equal(rstd.cpu(), r_plain)
    assert xd[1:].data_ptr() % 16 != 0 and torch.equal(tail, y[1:])


def test_group_norm_kernel_refuses_what_it_does_not_take(device):
    from hobot_stereonet_tpu_torch.ops.kernels.group_norm import group_norm

    x, g, w, b = _gn_case(2, 32, (8, 8), torch.bfloat16)
    x, w, b = x.to(device), w.to(device), b.to(device)
    with pytest.raises(ValueError, match="channels_last"):
        group_norm(x.contiguous(), g, w, b, 1e-6)
    with pytest.raises(TypeError):
        group_norm(x.half(), g, w, b, 1e-6)
    with pytest.raises(ValueError, match="divide"):
        group_norm(x, 3, w, b, 1e-6)


def test_group_norm_gradients_on_the_card(device):
    """The module's backward on the card against the CPU's (ATen's
    backward on both, fed the forward's identical statistics; its sums run
    in other orders on the two devices)."""
    from hobot_stereonet_tpu_torch.models.layers import GroupNorm

    x, _, w, b = _gn_case(2, 32, (24, 40), torch.float32, seed=2)
    dy = torch.from_numpy(np.random.default_rng(3).standard_normal(x.shape).astype(np.float32))
    grads = []
    for dev in (device, torch.device("cpu")):
        gn = GroupNorm(32).to(dev)
        with torch.no_grad():
            gn.weight.copy_(w)
            gn.bias.copy_(b)
        xi = x.to(dev).requires_grad_(True)
        gn(xi).backward(dy.to(dev).contiguous(memory_format=torch.channels_last))
        grads.append([t.cpu() for t in (xi.grad, gn.weight.grad, gn.bias.grad)])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


# ---------------------------------------------------------------------------
# GroupNorm: the fused entry and the scan's fallbacks, bit for bit
# ---------------------------------------------------------------------------

FUSED_CASES = [  # (N, C, spatial, dtype, conv bias dtype or None, skip, activate)
    (2, 32, (45, 80), torch.bfloat16, torch.float32, False, True),
    (2, 32, (45, 80), torch.bfloat16, torch.float32, True, True),
    (3, 12, (31, 33), torch.bfloat16, torch.bfloat16, True, True),
    (2, 16, (4, 18, 34), torch.bfloat16, torch.float32, False, True),
    (2, 64, (30, 40), torch.bfloat16, None, True, True),
    (2, 32, (30, 40), torch.float32, torch.float32, True, True),
    (3, 12, (31, 33), torch.float32, torch.float32, False, True),
    (2, 32, (30, 40), torch.bfloat16, torch.float32, True, False),
]


def _fused_case(n, c, spatial, dtype, bias_dtype, skip, seed=0):
    x, g, w, b = _gn_case(n, c, spatial, dtype, seed)
    rng = np.random.default_rng(seed + 100)
    cb = (torch.from_numpy(rng.uniform(-2, 2, c).astype(np.float32)).to(bias_dtype)
          if bias_dtype is not None else None)
    sk = None
    if skip:
        sk = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(dtype)
        sk = sk.contiguous(memory_format=torch.channels_last_3d if len(spatial) == 3
                           else torch.channels_last)
    return x - 5, g, w, b, cb, sk


@pytest.mark.parametrize("n,c,spatial,dtype,bias_dtype,skip,activate", FUSED_CASES)
def test_group_norm_fused_kernel_equals_plain(device, n, c, spatial, dtype, bias_dtype, skip,
                                              activate):
    from hobot_stereonet_tpu_torch.ops.kernels.group_norm import (
        group_norm_fused, group_norm_fused_plain)

    x, g, w, b, cb, sk = _fused_case(n, c, spatial, dtype, bias_dtype, skip)
    n0 = build.launch_counts["group_norm"]
    with torch.inference_mode():
        got = group_norm_fused(x.to(device), g, w.to(device), b.to(device), 1e-6,
                               conv_bias=None if cb is None else cb.to(device),
                               skip=None if sk is None else sk.to(device), activate=activate)
    torch.cuda.synchronize()
    assert build.launch_counts["group_norm"] == n0 + 1
    want = group_norm_fused_plain(x, g, w, b, 1e-6, cb, sk, activate)[0]
    assert got.dtype == dtype and got.stride() == x.stride()
    assert torch.equal(got.cpu(), want), float((got.cpu() != want).float().mean())


@pytest.mark.parametrize("sequential", [False, True])
@pytest.mark.parametrize("n,c,spatial,dtype,bias_dtype,skip,activate", FUSED_CASES + [
    (40, 32, (12, 20), torch.bfloat16, torch.float32, True, True),     # N * C past the
    (96, 12, (9, 11), torch.float32, torch.float32, False, True)])     # threshold
def test_group_norm_scan_and_walk_in_order_equal_plain(device, sequential, n, c, spatial, dtype,
                                                       bias_dtype, skip, activate):
    """The statistics by the scan and by the walk in order, whichever one
    N * C would choose: output, mean and rstd bit for bit the plain
    version's."""
    from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg

    x, g, w, b, cb, sk = _fused_case(n, c, spatial, dtype, bias_dtype, skip)
    got = kg._launch(x.to(device), g, w.to(device), b.to(device), 1e-6,
                     None if cb is None else cb.to(device), None if sk is None else sk.to(device),
                     activate, sequential=sequential)[:3]
    torch.cuda.synchronize()
    want, _, mean, rstd = kg.group_norm_fused_plain(x, g, w, b, 1e-6, cb, sk, activate)
    for t, u in zip(got, (want, mean, rstd)):
        assert torch.equal(t.cpu(), u), float((t.cpu() != u).float().mean())


@pytest.mark.parametrize("kind", ["walk", "ties", "octaves", "tiny", "huge", "nan", "zeros"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_scan_fallbacks_exact(device, kind, dtype):
    """Data that sends the scan down its fallbacks: sums that wander about
    zero, ties at every step, values over 16 octaves, sums below and above
    the binades it keys, NaN, all zeros; output and statistics bit for bit."""
    from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg

    rng = np.random.default_rng(11)
    shape = (2, 12, 96, 160)
    a = {"walk": lambda: rng.standard_normal(shape),
         "ties": lambda: rng.integers(-300, 301, shape) * 0.5,
         "octaves": lambda: rng.standard_normal(shape) * 2.0 ** rng.integers(-8, 8, shape),
         "tiny": lambda: rng.standard_normal(shape) * 1e-30,
         "huge": lambda: rng.standard_normal(shape) * 1e25,
         "nan": lambda: np.where(rng.random(shape) < 1e-5, np.nan, rng.standard_normal(shape)),
         "zeros": lambda: np.zeros(shape)}[kind]()
    x = torch.from_numpy(a.astype(np.float32)).to(dtype).contiguous(
        memory_format=torch.channels_last)
    w = torch.ones(12)
    b = torch.zeros(12)
    got, mean, rstd = kg._group_norm_cuda(x.to(device), 4, w.to(device), b.to(device), 1e-6)
    torch.cuda.synchronize()
    want, w_mean, w_rstd = kg.group_norm_plain(x, 4, w, b, 1e-6)
    for t, u in ((mean.cpu(), w_mean), (rstd.cpu(), w_rstd), (got.cpu(), want)):
        t, u = t.float().numpy(), u.float().numpy()       # NaN payloads differ by device
        assert np.array_equal(np.isnan(t), np.isnan(u))
        assert np.array_equal(np.where(np.isnan(t), 0, t).view(np.int32),
                              np.where(np.isnan(u), 0, u).view(np.int32))


def test_group_norm_scan_at_full_resolution(device):
    """One 720p sample, 12 channels, mean near zero (the s1 chains wander):
    many windows of segments and fallbacks; bit for bit the plain version."""
    from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg

    x, g, w, b = _gn_case(1, 12, (720, 1280), torch.bfloat16, seed=3)
    x = (x - 5).contiguous(memory_format=torch.channels_last)
    got, mean, rstd = kg._group_norm_cuda(x.to(device), g, w.to(device), b.to(device), 1e-6)
    torch.cuda.synchronize()
    want, w_mean, w_rstd = kg.group_norm_plain(x, g, w, b, 1e-6)
    assert torch.equal(mean.cpu(), w_mean) and torch.equal(rstd.cpu(), w_rstd)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skip", [False, True])
def test_group_norm_fused_gradients_on_the_card(device, dtype, skip):
    """The fused entry's backward on the card against the unfused ops'
    autograd on the CPU (ATen's GroupNorm backward on both, its sums in
    other orders on the two devices: 1e-5 in float32; bf16 to one bf16 step
    of the largest magnitude)."""
    from hobot_stereonet_tpu_torch.ops.kernels.group_norm import (
        group_norm, group_norm_fused, leaky_relu)

    x, g, w, b, cb, sk = _fused_case(2, 32, (24, 40), dtype, torch.float32, skip, seed=4)
    dy = torch.from_numpy(np.random.default_rng(5).standard_normal(x.shape).astype(np.float32))
    dy = dy.to(dtype).contiguous(memory_format=torch.channels_last)
    grads = []
    for dev, fused in ((device, True), (torch.device("cpu"), False)):
        leaves = [t.to(dev).requires_grad_(True) for t in (x, w, b, cb)]
        sk_d = sk.to(dev).requires_grad_(True) if skip else None
        xi, wi, bi, cbi = leaves
        if fused:
            out = group_norm_fused(xi, g, wi, bi, 1e-6, conv_bias=cbi, skip=sk_d, activate=True)
        else:
            h = group_norm(xi + cbi.to(dtype).view(1, -1, 1, 1), g, wi, bi, 1e-6)
            out = leaky_relu(h if sk_d is None else sk_d + h)
        out.backward(dy.to(dev))
        grads.append([t.grad.cpu().float() for t in leaves + ([sk_d] if skip else [])])
    for got, want in zip(*grads):
        tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5 if dtype == torch.float32 else 2 ** -7,
                                   atol=tol)


# CLASSIC's convs that took the library route before the int8 kernel took
# dilated and 3-D taps and zero padded channels, at their 720p shapes with a
# chunk of 2 frames: (N, Cin, Cout, kernel, dilation, spatial); a 3-D conv
# where the spatial shape has three axes.
CLASSIC_LIBRARY_SHAPES = [
    (2, 32, 32, 3, 1, (24, 90, 160)), (2, 32, 1, 3, 1, (24, 90, 160)),
    (2, 32, 32, 3, 2, (180, 320)), (2, 32, 32, 3, 4, (180, 320)), (2, 32, 32, 3, 8, (180, 320)),
    (2, 32, 1, 3, 1, (180, 320)),
    (2, 16, 16, 3, 2, (360, 640)), (2, 16, 16, 3, 4, (360, 640)), (2, 16, 16, 3, 8, (360, 640)),
    (2, 16, 1, 3, 1, (360, 640)),
    (2, 4, 12, 3, 1, (720, 1280)), (2, 12, 12, 3, 1, (720, 1280)), (2, 12, 12, 3, 2, (720, 1280)),
    (2, 12, 12, 3, 4, (720, 1280)), (2, 12, 1, 3, 1, (720, 1280)),
]


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("n,cin,cout,k,dilation,spatial", CLASSIC_LIBRARY_SHAPES)
def test_int8_library_route_exact_at_classic_shapes(device, n, cin, cout, k, dilation, spatial,
                                                    static):
    """The library route (im2col, ``torch._int_mm``, the kernel's epilogue;
    the yardstick ``chip_smoke.py`` times the kernel against, no network's
    route) equals the plain version bit for bit at every CLASSIC conv
    shape it once served; the kernel takes each of them, zero padded to
    its channels."""
    from hobot_stereonet_tpu_torch.ops import int8_gemm
    from hobot_stereonet_tpu_torch.ops.kernels.int8_conv import (
        kernel_takes, memory_format, padded_channels)

    rng = np.random.default_rng(9)
    kernel = (k,) * len(spatial)
    assert kernel_takes(*padded_channels(cin, cout), kernel, 1, dilation)
    x = torch.from_numpy((2.0 * rng.standard_normal((n,) + spatial + (cin,))).astype(np.float32))
    x = x.bfloat16().to(device).movedim(-1, 1)
    assert x.is_contiguous(memory_format=memory_format(x.dim()))
    q_w = torch.from_numpy(rng.integers(-127, 128, (cout, cin) + kernel, dtype=np.int8)).to(device)
    s_k = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(device)
    if static:
        sx = torch.tensor([0.05], device=device)
        qs = torch.tensor([1.0], device=device) / sx
    else:
        sx = qs = torch.from_numpy(rng.uniform(0.01, 0.05, n).astype(np.float32)).to(device)
    kw = dict(stride=1, dilation=dilation, divide=not static, out_dtype=torch.bfloat16)
    n0, e0 = int8_gemm.calls["cuda"], build.launch_counts["int8_epilogue"]
    got = int8_gemm.int8_conv_im2col(x, q_w, int8_gemm.gemm_weight(q_w), s_k, bias, sx, qs, **kw)
    torch.cuda.synchronize()
    assert int8_gemm.calls["cuda"] == n0 + 1
    assert build.launch_counts["int8_epilogue"] == e0 + 1
    want = int8_conv_plain(x, q_w, s_k, bias, sx, qs, **kw)
    assert got.shape == want.shape == (n, cout) + spatial
    assert got.is_contiguous(memory_format=memory_format(got.dim()))
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("n,cin,cout,k,dilation,spatial", CLASSIC_LIBRARY_SHAPES)
def test_int8_kernel_at_former_library_shapes(device, n, cin, cout, k, dilation, spatial, static):
    """``Int8Conv.on_card`` at every shape the library route once served:
    one ``int8_conv`` launch, no library call and no epilogue launch, the
    output unpadded in the input's channels-last format, bit for bit the
    plain conv of the unpadded weights."""
    from hobot_stereonet_tpu_torch.models.layers import SameConv2d, SameConv3d
    from hobot_stereonet_tpu_torch.ops import int8_gemm
    from hobot_stereonet_tpu_torch.ops.kernels.int8_conv import memory_format
    from hobot_stereonet_tpu_torch.ops.quant import Int8Conv, activation_scale

    torch.manual_seed(10)
    conv = SameConv3d(cin, cout, k) if len(spatial) == 3 else SameConv2d(cin, cout, k, 1,
                                                                         dilation)
    mod = Int8Conv(conv, torch.bfloat16, 0.05 if static else None).to(device)
    assert mod.route == "kernel"
    rng = np.random.default_rng(12)
    x = torch.from_numpy((2.0 * rng.standard_normal((n,) + spatial + (cin,))).astype(np.float32))
    x = x.bfloat16().to(device).movedim(-1, 1)
    sx, qs = (mod.act_scale, mod.act_mult) if static else (activation_scale(x),) * 2
    n0, c0 = build.launch_counts["int8_conv"], int8_gemm.calls["cuda"]
    e0 = build.launch_counts["int8_epilogue"]
    got = mod.on_card(x, sx, qs, divide=not static)
    torch.cuda.synchronize()
    assert build.launch_counts["int8_conv"] == n0 + 1 and int8_gemm.calls["cuda"] == c0
    assert build.launch_counts["int8_epilogue"] == e0
    want = int8_conv_plain(x, mod.q_weight, mod.weight_scale, mod.bias, sx, qs, stride=1,
                           dilation=dilation, divide=not static, out_dtype=torch.bfloat16)
    assert got.shape == want.shape == (n, cout) + spatial
    assert got.is_contiguous(memory_format=memory_format(x.dim()))
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


# CLASSIC's undilated 2-D convs the kernel takes only zero padded (Cout 1
# and 12 up to 8 and 16, Cin 12 up to 16), at their 720p shapes.
CLASSIC_PADDED_SHAPES = [(2, 32, 1, (180, 320)), (2, 16, 1, (360, 640)),
                         (2, 4, 12, (720, 1280)), (2, 12, 12, (720, 1280)),
                         (2, 12, 1, (720, 1280))]


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("n,cin,cout,spatial", CLASSIC_PADDED_SHAPES)
def test_int8_kernel_zero_padded_at_classic_shapes(device, n, cin, cout, spatial, static):
    """``Int8Conv.on_card`` of a conv the kernel takes zero padded: one
    kernel launch, the output unpadded and channels-last, bit for bit the
    plain conv of the unpadded weights."""
    from hobot_stereonet_tpu_torch.models.layers import SameConv2d
    from hobot_stereonet_tpu_torch.ops.quant import Int8Conv, activation_scale

    torch.manual_seed(3)
    mod = Int8Conv(SameConv2d(cin, cout, 3), torch.bfloat16, 0.05 if static else None)
    mod = mod.to(device)
    assert mod.route == "kernel" and mod.channels != (cin, cout)
    rng = np.random.default_rng(4)
    x = torch.from_numpy((2.0 * rng.standard_normal((n,) + spatial + (cin,))).astype(np.float32))
    x = x.bfloat16().to(device).movedim(-1, 1)
    sx, qs = (mod.act_scale, mod.act_mult) if static else (activation_scale(x),) * 2
    n0 = build.launch_counts["int8_conv"]
    got = mod.on_card(x, sx, qs, divide=not static)
    torch.cuda.synchronize()
    assert build.launch_counts["int8_conv"] == n0 + 1
    want = int8_conv_plain(x, mod.q_weight, mod.weight_scale, mod.bias, sx, qs, stride=1,
                           divide=not static, out_dtype=torch.bfloat16)
    assert got.shape == want.shape == (n, cout) + spatial
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,per,ld,cout", [(2 * 921600, 921600, 16, 12),
                                              (2 * 921600, 921600, 16, 1),
                                              (3 * 45, 45, 40, 33)])
def test_int8_epilogue_kernel_exact(device, rows, per, ld, cout, out_dtype, per_sample):
    """The library route's epilogue kernel against its plain version
    (``epilogue``, float64 with Knuth's TwoSum), bit for bit: random int32
    products padded past Cout and the rows, per-sample or one scale, and a
    value whose float64 sum lands on a float32 tie that the exact sum lies
    above (``__fmaf_rn`` rounds once)."""
    from hobot_stereonet_tpu_torch.ops.kernels.int8_conv import epilogue, int8_epilogue

    rng = np.random.default_rng(11)
    n = rows // per
    acc = torch.from_numpy(rng.integers(-(1 << 21), 1 << 21, (rows + 5, ld), dtype=np.int32))
    s_k = torch.from_numpy(rng.uniform(1e-7, 1e-3, cout).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    acc[0, 0], s_k[0], bias[0] = 4097, (1.0 + 2.0 ** -12) * 2.0 ** -12, 2.0 ** -60
    sx = torch.from_numpy(rng.uniform(0.01, 0.05, n if per_sample else 1).astype(np.float32))
    sx[0] = 1.0
    acc, s_k, bias, sx = (t.to(device) for t in (acc, s_k, bias, sx))
    e0 = build.launch_counts["int8_epilogue"]
    got = int8_epilogue(acc, rows, cout, per, sx, s_k, bias, out_dtype)
    want = epilogue(acc[:rows, :cout].float().view(n, per, cout), sx, s_k, bias, 2,
                    out_dtype).view(rows, cout)
    torch.cuda.synchronize()
    assert build.launch_counts["int8_epilogue"] == e0 + 1
    assert got.shape == (rows, cout) and got.is_contiguous()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("n,cout,h,w", [(2, 32, 180, 320), (2, 16, 360, 640), (3, 16, 17, 30)])
def test_int8_conv_dense_path_at_cin_4(device, n, cout, h, w, static):
    """The kernel's dense path at Cin 4 (CLASSIC's refinement inputs: the
    disparity and the guide image), which the route sends to it: bit for
    bit against the plain version."""
    from hobot_stereonet_tpu_torch.ops.kernels.int8_conv import dense_input, kernel_takes

    assert dense_input(4) and kernel_takes(4, cout, (3, 3), 1, 1)
    rng = np.random.default_rng(8)
    x, q_w, s_k, bias = _int8_case(rng, n, 4, cout, 3, h, w, torch.bfloat16, device)
    if static:
        sx = torch.tensor([0.05], device=device)
        qs = torch.tensor([1.0], device=device) / sx
    else:
        sx = qs = torch.from_numpy(rng.uniform(0.01, 0.05, n).astype(np.float32)).to(device)
    kw = dict(stride=1, divide=not static, out_dtype=torch.bfloat16)
    got = int8_conv(x, q_w, pack_weight(q_w), s_k, bias, sx, qs, **kw)
    want = int8_conv_plain(x, q_w, s_k, bias, sx, qs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


def test_classic_int8_on_the_card_takes_both_routes(device):
    """A small CLASSIC in int8 on the card: every conv (3-D and dilated
    included) through the int8 kernel, the library route never called and
    the epilogue kernel never launched, finite disparities, a frame alone
    equal to the same frame in the batch (per-sample scales, fixed
    summation orders)."""
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models import StereoNet
    from hobot_stereonet_tpu_torch.ops import int8_gemm
    from hobot_stereonet_tpu_torch.ops.quant import routes, serving_model

    cfg = StereoNetConfig(downsample_factor=2, feature_channels=8, num_feature_res_blocks=1,
                          num_aggregation_layers=1, aggregation_channels=8, max_disparity=16,
                          refinement_scale_channels=(8, 4), refinement_scale_blocks=(3, 2))
    torch.manual_seed(0)
    net = serving_model(StereoNet(cfg, device=device), int8=True)
    assert set(routes(net).values()) == {"kernel"}
    x = torch.rand((3, 64, 128, 3), device=device) * 2 - 1
    n0, c0 = build.launch_counts["int8_conv"], int8_gemm.calls["cuda"]
    e0 = build.launch_counts["int8_epilogue"]
    with torch.inference_mode():
        whole = net(x, torch.roll(x, -3, 2))["disparity"]
        alone = net(x[1:2], torch.roll(x, -3, 2)[1:2])["disparity"]
    torch.cuda.synchronize()
    assert build.launch_counts["int8_conv"] > n0 and int8_gemm.calls["cuda"] == c0
    assert build.launch_counts["int8_epilogue"] == e0
    assert torch.isfinite(whole).all() and torch.equal(whole[1:2], alone)


@pytest.mark.parametrize("sequential", [False, True])
@pytest.mark.parametrize("n,c,spatial,dtype,bias_dtype,skip,activate", FUSED_CASES)
def test_group_norm_split_entries_equal_the_fused_launch(device, sequential, n, c, spatial,
                                                         dtype, bias_dtype, skip, activate):
    """``group_norm_stats`` (the kernel in mode STATS), the statistics
    finished as the kernel's phase 5, then ``group_norm_apply`` (mode APPLY)
    over the whole tensor: the fused launch's output, mean and rstd bit for
    bit, by the scan and by the walk in order; each entry counts one launch
    under its own name; the sums equal the plain version's."""
    from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg

    x, g, w, b, cb, sk = _fused_case(n, c, spatial, dtype, bias_dtype, skip)
    xd, wd, bd = x.to(device), w.to(device), b.to(device)
    cbd = None if cb is None else cb.to(device)
    skd = None if sk is None else sk.to(device)
    want = kg._launch(xd, g, wd, bd, 1e-6, cbd, skd, activate, sequential=sequential)[:3]
    before = dict(build.launch_counts)
    sums = kg._launch(xd, g, wd, bd, 1e-6, cbd, None, False, sequential=sequential,
                      mode=kg.STATS)[0]
    count = c // g * int(np.prod(spatial))
    mean, rstd = kg.statistics_from_sums(sums, count, 1e-6)
    with torch.inference_mode():
        out = kg.group_norm_apply(xd, wd, bd, mean, rstd, conv_bias=cbd, skip=skd,
                                  activate=activate)
    torch.cuda.synchronize()
    assert build.launch_counts["group_norm_stats"] == before.get("group_norm_stats", 0) + 1
    assert build.launch_counts["group_norm_apply"] == before.get("group_norm_apply", 0) + 1
    assert out.stride() == x.stride()
    for t, u in zip((out, mean, rstd), want):
        assert torch.equal(t, u), float((t != u).float().mean())
    a = x if cb is None else x + cb.to(dtype).view((1, -1) + (1,) * len(spatial))
    assert torch.equal(sums.cpu(), kg.group_sums_plain(a, g))
    with torch.inference_mode():
        assert torch.equal(kg.group_norm_stats(xd, g, cbd), sums)


@pytest.mark.parametrize("n,c,spatial,dtype", [(2, 32, (90, 160), torch.bfloat16),
                                               (2, 32, (4, 18, 34), torch.bfloat16),
                                               (2, 12, (720, 1280), torch.bfloat16),
                                               (3, 12, (31, 33), torch.float32)])
def test_group_norm_split_entries_over_row_halves(device, n, c, spatial, dtype):
    """Two row halves' sums on the card: the plain version's halves' bits
    (every chain is the one-thread chain).  Combined in float64 in order,
    their statistics lie within 8 sqrt(n) float32 ulps of the scale (the
    values' RMS for the mean, rstd for rstd; n elements a group) of the
    whole tensor's: each side is a float32 chain off the exact value by
    about sqrt(n) ulps (measured at 720x1280, n = 921600: 1.1e-4 and 5.7e-5
    relative, the bound 4.6e-4); each half's output from them, and the value
    before its LeakyReLU kept for the tiled backward (``keep_r``), equal the
    plain version's from the same statistics, bit for bit."""
    from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg

    x, g, w, b, cb, sk = _fused_case(n, c, spatial, dtype, torch.float32, True)
    fmt = torch.channels_last_3d if len(spatial) == 3 else torch.channels_last
    dim = x.dim() - 2
    rows = x.shape[dim] // 2
    cut = [(0, rows), (rows, x.shape[dim] - rows)]
    halves = [x.narrow(dim, a, m).contiguous(memory_format=fmt) for a, m in cut]
    skips = [sk.narrow(dim, a, m).contiguous(memory_format=fmt) for a, m in cut]
    wd, bd, cbd = w.to(device), b.to(device), cb.to(device)
    with torch.inference_mode():
        parts = [kg.group_norm_stats(h.to(device), g, cbd) for h in halves]
        for p, h in zip(parts, halves):
            assert torch.equal(p.cpu(), kg.group_norm_stats(h, g, cb))
        count = c // g * int(np.prod(spatial))
        mean, rstd = kg.statistics_from_sums(kg.combine_sums(parts), count, 1e-6)
        whole = kg.group_norm_fused_plain(x, g, w, b, 1e-6, cb, sk, True)
        a = (x + cb.to(dtype).view((1, -1) + (1,) * len(spatial))).double().reshape(n, g, -1)
        ulps = 8 * count ** 0.5 * 2.0 ** -24
        for got, chain, scale in ((mean.cpu(), whole[2], (a ** 2).mean(2).sqrt()),
                                  (rstd.cpu(), whole[3], whole[3].double())):
            d = (got.double() - chain.double()).abs()
            assert bool((d <= ulps * scale).all()), float((d / scale).max())
        for h, s_, cpu_h, cpu_s in zip(halves, skips, halves, skips):
            got = kg.group_norm_apply(h.to(device), wd, bd, mean, rstd, conv_bias=cbd,
                                      skip=s_.to(device), activate=True, keep_r=True)
            want = kg.group_norm_apply(cpu_h, w, b, mean.cpu(), rstd.cpu(), conv_bias=cb,
                                       skip=cpu_s, activate=True, keep_r=True)
            for t, u in zip(got, want):                   # the output, then r
                assert torch.equal(t.cpu(), u), float((t.cpu() != u).float().mean())
