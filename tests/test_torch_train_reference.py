"""The stored JAX training steps (``reference/flagship_train_step.npz``,
``reference/classic_train_step.npz``) and the port's step against them on
the CPU, at full width.

The reference is one ``jax.value_and_grad`` of the JAX package's
``multiscale_loss`` from the committed weights, on the CPU under
``XLA_FLAGS=--xla_allow_excess_precision=false`` (so that bf16 rounds where
flax asks), in float32 and in bf16.  The flag is per process and
tests/conftest.py sets ``XLA_FLAGS`` for the suite, so it runs in a
subprocess (this file as a script) and hands its arrays back as an ``.npz``.

Tolerances:
  * the committed arrays are what the reference computes now: losses and
    norms within 1e-6 relative, each gradient within 1e-5 relative L2 (the
    same program on the same inputs; the margin covers another host CPU's
    vector width);
  * the port's float32 step: ``reference.TRAIN_F32_RTOL`` (loss),
    ``TRAIN_F32_NORM_RTOL`` (global norm) and ``TRAIN_F32_GRAD_RTOL`` (each gradient, 1e-3; the
    reason is there), the bounds ``chip_smoke.py`` holds the card to;
  * the port's bf16 step: ``reference.bf16_grad_check`` (no farther from
    JAX's bf16 gradient than JAX's bf16 is from its float32 one, over all
    gradients together; each gradient that JAX's bf16 resolves within 50 %
    of JAX's float32 one), and the loss at most four times as far from
    JAX's float32 loss as JAX's bf16 loss is.

Regenerate the committed data (about a minute on a CPU) with::

    python tests/test_torch_train_reference.py --write
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

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hobot_stereonet_tpu_torch import reference  # noqa: E402
from hobot_stereonet_tpu_torch.reference import XLA_FLAGS as NO_EXCESS  # noqa: E402

NETWORKS = {"fast": (reference.PARAMS_NPZ, "yuv"), "classic": (reference.CLASSIC_PARAMS_NPZ, "rgb")}


def _jax_reference(out_path: str) -> None:
    """Both networks' float32 and bf16 steps into ``out_path`` (keys
    ``<model>/<name>`` with the names of the committed files)."""
    assert NO_EXCESS in os.environ.get("XLA_FLAGS", ""), "run under " + NO_EXCESS
    import jax
    import jax.numpy as jnp
    import optax

    from hobot_stereonet_tpu.config import StereoNetConfig
    from hobot_stereonet_tpu.data.loader import BatchIterator, SyntheticStereoDataset
    from hobot_stereonet_tpu.models import FastStereoNet, StereoNet
    from hobot_stereonet_tpu.ops import colorspace as jcs
    from hobot_stereonet_tpu.runtime import training

    left_u8, right_u8, disp = next(iter(BatchIterator(
        SyntheticStereoDataset(**reference.TRAIN_STEP_SCENES), **reference.TRAIN_STEP_BATCH)))

    def to_in(u8, color_space):          # train_loop.py's step_u8
        x = jnp.asarray(u8).astype(jnp.float32)
        if color_space == "yuv":
            x = jnp.clip(jcs.rgb_to_yuv(x), 0.0, 255.0)
        return (x - 128.0) / 128.0

    out = {"xla_flags": np.array(os.environ["XLA_FLAGS"]),
           "jax_version": np.array(jax.__version__)}
    for model, (params_npz, color_space) in NETWORKS.items():
        params = reference.load_params(params_npz)
        left, right = jax.jit(to_in, static_argnums=1)(left_u8, color_space), \
            jax.jit(to_in, static_argnums=1)(right_u8, color_space)
        out.update({f"{model}/left_u8": left_u8, f"{model}/right_u8": right_u8,
                    f"{model}/disparity": disp, f"{model}/color_space": np.array(color_space),
                    f"{model}/left_input": np.asarray(left)})
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            cfg = StereoNetConfig(compute_dtype=dt)
            net = (FastStereoNet if model == "fast" else StereoNet)(cfg)

            def loss_fn(p):
                return training.multiscale_loss(net.apply(p, left, right), disp, None,
                                                cfg.max_disparity)

            (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
            out[f"{model}/{name}_loss"] = np.asarray(loss)
            out[f"{model}/{name}_epe"] = np.asarray(metrics["epe"])
            out[f"{model}/{name}_grad_norm"] = np.asarray(optax.global_norm(grads))
            for path, g in jax.tree_util.tree_flatten_with_path(grads["params"])[0]:
                key = "/".join(p.key for p in path)
                out[f"{model}/{name}_grad/{key}"] = np.asarray(g, np.float32)
    np.savez(out_path, **out)


def _run_reference(out_path: Path) -> dict:
    env = dict(os.environ, XLA_FLAGS=NO_EXCESS, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, "--reference", str(out_path)], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out_path) as data:
        return {k: data[k] for k in data.files}


def write_committed_data() -> None:
    import tempfile

    from hobot_stereonet_tpu_torch.runtime.weights import write_npz

    with tempfile.TemporaryDirectory() as tmp:
        ref = _run_reference(Path(tmp) / "ref.npz")
    for model, path in reference.TRAIN_STEP_NPZ.items():
        arrays = {k.split("/", 1)[1]: v for k, v in ref.items() if k.startswith(model + "/")
                  and not k.endswith("/left_input")}
        write_npz(str(path), {**arrays, "xla_flags": ref["xla_flags"],
                              "jax_version": ref["jax_version"]})
        print(f"wrote {path.relative_to(ROOT)}: {path.stat().st_size} bytes")


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    return _run_reference(tmp_path_factory.mktemp("train_reference") / "ref.npz")


@pytest.mark.parametrize("model", sorted(NETWORKS))
def test_committed_train_step_is_current(fresh, model):
    stored = reference.load_train_step(model)
    raw = reference.load_outputs(reference.TRAIN_STEP_NPZ[model])
    assert str(raw["xla_flags"]) == NO_EXCESS
    for key in ("left_u8", "right_u8", "disparity"):
        np.testing.assert_array_equal(stored[key], fresh[f"{model}/{key}"])
    for p in ("f32", "bf16"):
        for k in ("loss", "epe", "grad_norm"):
            np.testing.assert_allclose(stored[p][k], fresh[f"{model}/{p}_{k}"], rtol=1e-6)
        got = {k[len(f"{model}/{p}_grad/"):]: v for k, v in fresh.items()
               if k.startswith(f"{model}/{p}_grad/")}
        assert sorted(got) == sorted(stored[p]["grads"])
        assert not reference.grad_mismatches(got, stored[p]["grads"], 1e-5), p


def test_port_batch_and_input_are_the_reference_s(fresh):
    """The port's loader draws the stored batch, and its on-device cast
    (``train_loop.to_model_input``) gives JAX's model input bit for bit."""
    from hobot_stereonet_tpu_torch.runtime.train_loop import to_model_input

    left, right, disp = reference.train_step_batch()
    for model, (_, color_space) in NETWORKS.items():
        stored = reference.load_train_step(model)
        np.testing.assert_array_equal(left, stored["left_u8"])
        np.testing.assert_array_equal(right, stored["right_u8"])
        np.testing.assert_array_equal(disp, stored["disparity"])
        x = to_model_input(torch.from_numpy(left), color_space).numpy()
        np.testing.assert_array_equal(x, fresh[f"{model}/left_input"])


def port_step(model: str, dtype: torch.dtype, device="cpu"):
    """The port's gradients of one step from the committed weights on the
    stored batch: (loss, epe, grad_norm, {flax path: gradient})."""
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models import build_model
    from hobot_stereonet_tpu_torch.runtime import training
    from hobot_stereonet_tpu_torch.runtime.train_loop import to_model_input
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params, to_flax_params

    params_npz, color_space = NETWORKS[model]
    stored = reference.load_train_step(model)
    cfg = StereoNetConfig(compute_dtype=dtype)
    net = build_model(model, cfg, device)
    net.load_state_dict(from_flax_params(reference.load_params(params_npz), cfg, model))
    left, right = (to_model_input(torch.from_numpy(stored[k]).to(device), color_space)
                   for k in ("left_u8", "right_u8"))
    gt = torch.from_numpy(stored["disparity"]).to(device)
    loss, metrics = training.multiscale_loss(net(left, right), gt, None, cfg.max_disparity)
    loss.backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
    flat = to_flax_params(grads)["params"]

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from (leaves(v, prefix + k + "/") if isinstance(v, dict) else [(prefix + k, v)])

    return float(loss.detach()), float(metrics["epe"]), float(norm), dict(leaves(flat))


@pytest.mark.parametrize("model", sorted(NETWORKS))
def test_port_f32_step_matches_committed(model):
    loss, _, norm, grads = port_step(model, torch.float32)
    want = reference.load_train_step(model)["f32"]
    rtol = reference.TRAIN_F32_RTOL
    assert abs(loss - want["loss"]) <= rtol * abs(want["loss"]), (loss, want["loss"])
    assert abs(norm - want["grad_norm"]) <= reference.TRAIN_F32_NORM_RTOL[model] * \
        want["grad_norm"], (norm, want["grad_norm"])
    bad = reference.grad_mismatches(grads, want["grads"], reference.TRAIN_F32_GRAD_RTOL)
    assert not bad, bad


@pytest.mark.parametrize("model", sorted(NETWORKS))
def test_port_bf16_step_within_jax_bf16_error(model):
    loss, _, _, grads = port_step(model, torch.bfloat16)
    want = reference.load_train_step(model)
    l16, l32 = want["bf16"]["loss"], want["f32"]["loss"]
    assert abs(loss - l32) <= reference.BF16_LOSS_FACTOR * abs(l16 - l32), (loss, l16, l32)
    res = reference.bf16_grad_check(grads, want["bf16"]["grads"], want["f32"]["grads"])
    assert res["ok"], res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true", help="regenerate the committed steps")
    ap.add_argument("--reference", metavar="NPZ",
                    help="compute the reference arrays into NPZ (runs under " + NO_EXCESS + ")")
    args = ap.parse_args()
    if args.reference:
        _jax_reference(args.reference)
    elif args.write:
        write_committed_data()
    else:
        ap.print_help()
