"""The backward of the correlation and of both soft-argmins
(``ops/kernels/correlation.py``) against ``jax.vjp`` of the JAX package's
XLA functions and against ``torch.autograd`` of the plain forwards.

The JAX reference runs in a subprocess (this file as a script) under
``XLA_FLAGS=--xla_allow_excess_precision=false``, so that its bf16 rounds
where the code asks (tests/conftest.py sets ``XLA_FLAGS`` for the suite).
The soft-argmin reference casts the cost to float32 once and feeds both
``soft_argmin`` and ``disparity_confidence``, so that the two cotangents
sum in float32 and round once, as the port's fused backward does.  (The
networks call the two on one bf16 cost with a cast each; their confidence
gets no gradient in training, and then the two are the same.)

Tolerances:
  * float32: max |port - JAX| <= 1e-6 of the gradient's largest magnitude;
  * bf16: the correlation's gradients bit for bit (its products are exact
    in float32 and the reference sums in float32 and rounds once);
    the soft-argmin's within one bf16 step, or, where the gradient cancels
    (``p_j (j - E[d])`` near zero), within 1e-6 of the largest magnitude:
    there the value's bf16 step is below the float32 error of the terms
    that cancel, and XLA's exp and PyTorch's differ in their last bits;
  * against ``torch.autograd`` of the plain forward: 1e-6 relative in
    float32 (autograd divides by the divisor where XLA multiplies by its
    reciprocal), 1e-12 in float64.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hobot_stereonet_tpu_torch.ops.kernels import correlation as kc  # noqa: E402
from hobot_stereonet_tpu_torch.reference import XLA_FLAGS as NO_EXCESS  # noqa: E402

SCALE = 8.0
# (B, H, W, C, D): W < D puts whole rows left of the candidates (x < d).
CORR_SHAPES = ((2, 3, 40, 32, 24), (1, 2, 17, 16, 24))
SA_SHAPE = (2, 5, 7, 24)       # [B, H, W, D] logits; the cost is [B, D, H, W]


def _inputs(dtype_name: str) -> dict:
    """The cases' inputs (float32 arrays, exactly representable in bf16
    where ``dtype_name`` is bf16), made with numpy from a seed."""
    rng = np.random.default_rng(7)

    def rnd(shape, scale=1.0):
        a = (scale * rng.standard_normal(shape)).astype(np.float32)
        if dtype_name == "bf16":
            a = torch.from_numpy(a).bfloat16().float().numpy()
        return a

    out = {}
    for i, (b, h, w, c, d) in enumerate(CORR_SHAPES):
        out[f"corr{i}/fl"] = rnd((b, h, w, c))
        out[f"corr{i}/fr"] = rnd((b, h, w, c))
        out[f"corr{i}/dcorr"] = rnd((b, h, w, d))
    logits = rnd(SA_SHAPE, 3.0)
    flat = logits.reshape(-1, SA_SHAPE[-1])
    flat[::4, 5] = flat[::4, 11] = flat[::4].max(-1) + 1.0     # ties in the max
    flat[1::4, 3] = flat[1::4, 4] = flat[1::4, 9] = flat[1::4].max(-1) + 0.5
    out["sa/logits"] = logits
    out["sa/gd"] = rng.standard_normal(SA_SHAPE[:3]).astype(np.float32)
    out["sa/gc"] = rng.standard_normal(SA_SHAPE[:3]).astype(np.float32)
    return out


def _jax_reference(out_path: str) -> None:
    assert NO_EXCESS in os.environ.get("XLA_FLAGS", ""), "run under " + NO_EXCESS
    import jax
    import jax.numpy as jnp

    from hobot_stereonet_tpu.ops.cost_volume import build_correlation_volume
    from hobot_stereonet_tpu.ops.soft_argmin import disparity_confidence, soft_argmin

    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        x = _inputs(name)
        for i, (_, _, _, _, d) in enumerate(CORR_SHAPES):
            fl, fr = (jnp.asarray(x[f"corr{i}/{k}"], dt) for k in ("fl", "fr"))
            ct = jnp.asarray(x[f"corr{i}/dcorr"], dt).transpose(0, 3, 1, 2)   # [B, D, H, W]
            _, vjp = jax.vjp(lambda a, b: build_correlation_volume(a, b, d), fl, fr)
            dfl, dfr = jax.jit(vjp)(ct)
            out[f"{name}/corr{i}/dfl"] = np.asarray(dfl.astype(jnp.float32))
            out[f"{name}/corr{i}/dfr"] = np.asarray(dfr.astype(jnp.float32))
        logits = jnp.asarray(x["sa/logits"], dt)
        gd, gc = jnp.asarray(x["sa/gd"]), jnp.asarray(x["sa/gc"])

        def channel_last(l):
            c = (-l).astype(jnp.float32)
            return soft_argmin(c, axis=-1) * SCALE, disparity_confidence(c, axis=-1)

        def d_leading(cost):
            c = cost.astype(jnp.float32)
            return soft_argmin(c, axis=1) * SCALE, disparity_confidence(c, axis=1)

        cost = jnp.transpose(-logits, (0, 3, 1, 2))
        for tag, g in (("gd", (gd, jnp.zeros_like(gc))), ("both", (gd, gc))):
            out[f"{name}/sa_{tag}"] = np.asarray(jax.jit(
                lambda l, a, b: jax.vjp(channel_last, l)[1]((a, b))[0])(logits, *g)
                .astype(jnp.float32))
            out[f"{name}/cost_{tag}"] = np.asarray(jax.jit(
                lambda c, a, b: jax.vjp(d_leading, c)[1]((a, b))[0])(cost, *g)
                .astype(jnp.float32))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_vjp(tmp_path_factory):
    out_path = tmp_path_factory.mktemp("backward") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS=NO_EXCESS, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, "--reference", str(out_path)], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out_path) as data:
        return {k: data[k] for k in data.files}


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _close_f32(got: torch.Tensor, want: np.ndarray, rtol: float = 1e-6) -> None:
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= rtol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _within_bf16_step(got: torch.Tensor, want: np.ndarray) -> None:
    w = torch.from_numpy(want).bfloat16()
    ulps = kc.bf16_ulp_distance(got, w)
    near = (got.float() - w.float()).abs() <= 1e-6 * float(np.abs(want).max())
    bad = (ulps > 1) & ~near
    assert not bool(bad.any()), (int(ulps.max()), int(bad.sum()))


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(CORR_SHAPES)))
def test_correlation_backward_plain_matches_jax_vjp(jax_vjp, name, case):
    x, dt = _inputs(name), DTYPES[name]
    dfl, dfr = kc.correlation_volume_backward_plain(
        _t(x[f"corr{case}/dcorr"], dt), _t(x[f"corr{case}/fl"], dt), _t(x[f"corr{case}/fr"], dt))
    assert dfl.dtype == dfr.dtype == dt
    for got, key in ((dfl, "dfl"), (dfr, "dfr")):
        want = jax_vjp[f"{name}/corr{case}/{key}"]
        if name == "bf16":
            np.testing.assert_array_equal(got.float().numpy(), want)
        else:
            _close_f32(got, want)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("tag", ["gd", "both"])
def test_soft_argmin_backward_plain_matches_jax_vjp(jax_vjp, name, tag):
    x, dt = _inputs(name), DTYPES[name]
    logits = _t(x["sa/logits"], dt)
    gd = torch.from_numpy(x["sa/gd"])
    gc = torch.from_numpy(x["sa/gc"]) if tag == "both" else None
    got = kc.soft_argmin_confidence_backward_plain(logits, gd, gc, SCALE)
    got_cost = kc.soft_argmin_cost_backward_plain(-logits.permute(0, 3, 1, 2).contiguous(),
                                                  gd, gc, SCALE)
    assert got.dtype == got_cost.dtype == dt
    for g, key in ((got, f"{name}/sa_{tag}"), (got_cost, f"{name}/cost_{tag}")):
        if name == "bf16":
            _within_bf16_step(g, jax_vjp[key])
        else:
            _close_f32(g, jax_vjp[key])


@pytest.mark.parametrize("case", range(len(CORR_SHAPES)))
def test_correlation_backward_plain_matches_autograd(case):
    x = _inputs("f32")
    fl, fr = (_t(x[f"corr{case}/{k}"], torch.float32).requires_grad_() for k in ("fl", "fr"))
    dcorr = _t(x[f"corr{case}/dcorr"], torch.float32)
    out = kc.correlation_volume_plain(fl, fr, dcorr.shape[-1])
    want = torch.autograd.grad(out, (fl, fr), dcorr)
    got = kc.correlation_volume_backward_plain(dcorr, fl.detach(), fr.detach())
    for g, w in zip(got, want):
        _close_f32(g, w.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_soft_argmin_backward_plain_matches_autograd(dtype):
    """Both layouts, ties included: ``amax``'s autograd splits the
    cotangent equally over tied maxima, as ``jnp.max``'s VJP does."""
    x = _inputs("f32")
    logits = _t(x["sa/logits"], dtype)
    gd, gc = _t(x["sa/gd"], dtype), _t(x["sa/gc"], dtype)
    rtol = 1e-6 if dtype == torch.float32 else 1e-12
    for fwd, bwd, inp in (
            (kc.soft_argmin_confidence_plain, kc.soft_argmin_confidence_backward_plain, logits),
            (kc.soft_argmin_cost_plain, kc.soft_argmin_cost_backward_plain,
             -logits.permute(0, 3, 1, 2).contiguous())):
        leaf = inp.clone().requires_grad_()
        disp, conf = fwd(leaf, SCALE)
        (want,) = torch.autograd.grad((disp, conf), leaf, (gd, gc))
        got = bwd(inp, gd, gc, SCALE)
        err = float((got - want).abs().max())
        assert err <= rtol * float(want.abs().max()), err


def test_wrappers_differentiate_through_the_plain_backward():
    """On CPU tensors the differentiable wrappers' gradients are the plain
    backward's, bit for bit; a cotangent that is not given is zero."""
    x = _inputs("bf16")
    fl, fr = (_t(x[f"corr0/{k}"], torch.bfloat16).requires_grad_() for k in ("fl", "fr"))
    dcorr = _t(x["corr0/dcorr"], torch.bfloat16)
    corr = kc.correlation_volume(fl, fr, dcorr.shape[-1])
    got = torch.autograd.grad(corr, (fl, fr), dcorr)
    want = kc.correlation_volume_backward_plain(dcorr, fl.detach(), fr.detach())
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    logits = _t(x["sa/logits"], torch.bfloat16)
    gd = torch.from_numpy(x["sa/gd"])
    for fn, bwd, inp in ((kc.soft_argmin_confidence, kc.soft_argmin_confidence_backward_plain,
                          logits),
                         (kc.soft_argmin_cost, kc.soft_argmin_cost_backward_plain,
                          -logits.permute(0, 3, 1, 2).contiguous())):
        leaf = inp.clone().requires_grad_()
        disp, _ = fn(leaf, SCALE)
        (got,) = torch.autograd.grad(disp, leaf, gd)
        assert torch.equal(got, bwd(inp, gd, None, SCALE))
        assert torch.equal(got, bwd(inp, gd, torch.zeros_like(gd), SCALE))


def test_inference_forward_is_the_plain_forward():
    """Under ``inference_mode`` the wrappers return the plain forward's bits
    and record no graph."""
    x = _inputs("bf16")
    fl, fr = (_t(x[f"corr0/{k}"], torch.bfloat16) for k in ("fl", "fr"))
    logits = _t(x["sa/logits"], torch.bfloat16)
    cost = -logits.permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        corr = kc.correlation_volume(fl, fr, 24)
        sa = kc.soft_argmin_confidence(logits, SCALE)
        sc = kc.soft_argmin_cost(cost, SCALE)
    assert corr.grad_fn is None and sa[0].grad_fn is None and sc[0].grad_fn is None
    assert torch.equal(corr, kc.correlation_volume_plain(fl, fr, 24))
    for got, want in ((sa, kc.soft_argmin_confidence_plain(logits, SCALE)),
                      (sc, kc.soft_argmin_cost_plain(cost, SCALE))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_backward_rejects_a_cotangent_of_the_wrong_shape():
    fl = torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cotangent"):
        kc.correlation_volume_backward_plain(torch.zeros(1, 2, 8, 5), fl, fl)
    with pytest.raises(ValueError, match="one shape"):
        kc.correlation_volume_backward_plain(torch.zeros(1, 2, 8, 5, dtype=torch.bfloat16),
                                             fl, fl[..., :8])
    with pytest.raises(ValueError, match="cotangent"):
        kc.soft_argmin_confidence_backward(torch.zeros(1, 2, 8, 5), torch.zeros(1, 2, 7), None)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", metavar="NPZ", required=True,
                    help="compute the JAX vector-Jacobian products into NPZ (runs under "
                         + NO_EXCESS + ")")
    _jax_reference(ap.parse_args().reference)
