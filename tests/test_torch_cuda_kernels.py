"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper GPU and ``nvcc``; elsewhere they skip.
They import neither JAX nor the JAX package, so they run on a machine
without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_kernels.py

Tolerances: the ingest is exact; the correlation within 1 bf16 ulp
(relative 2**-7) plus 1e-5 absolute in bf16 and 1e-5 in f32, with exact
zeros in the margin (kernel and plain version sum in f32 in other orders,
so a sum near zero can differ in its rounding far beyond its own size);
soft-argmin at f32 rounding (rtol 1e-5).
"""

import numpy as np
import pytest
import torch

from hobot_stereonet_tpu_torch.ops.kernels import build
from hobot_stereonet_tpu_torch.ops.kernels.correlation import (
    correlation_volume,
    correlation_volume_plain,
    soft_argmin_confidence,
    soft_argmin_confidence_plain,
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
    (1, 2, 33, 32, 24, torch.bfloat16),
    (1, 2, 20, 16, 40, torch.float32),
    (8, 90, 160, 32, 24, torch.bfloat16),
])
def test_correlation_kernel(device, b, h, w, c, d, dtype):
    rng = np.random.default_rng(1)
    fl = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(dtype)
    fr = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(dtype)
    got = correlation_volume(fl.to(device), fr.to(device), d)
    torch.cuda.synchronize()
    want = correlation_volume_plain(fl.to(device), fr.to(device), d)
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for k in range(min(d, w)):
        np.testing.assert_array_equal(got[:, :, :k, k], 0.0)


@pytest.mark.parametrize("b,h,w,d,dtype", [
    (2, 3, 5, 24, torch.bfloat16),
    (1, 2, 3, 7, torch.float32),
    (8, 90, 160, 24, torch.bfloat16),
])
def test_soft_argmin_kernel(device, b, h, w, d, dtype):
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(
        (3.0 * rng.standard_normal((b, h, w, d))).astype(np.float32)).to(dtype).to(device)
    disp, conf = soft_argmin_confidence(logits, scale=8.0)
    torch.cuda.synchronize()
    want_d, want_c = soft_argmin_confidence_plain(logits, scale=8.0)
    torch.testing.assert_close(disp, want_d, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(conf, want_c, rtol=1e-5, atol=1e-6)
