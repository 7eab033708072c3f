"""Reference data the port carries: the trained weights of the flagship and
of the CLASSIC StereoNet and the JAX package's outputs on fixed inputs,
written with numpy so that a machine without JAX, flax or orbax can load
them.

  * ``flagship_params.npz``: ``checkpoints/flagship/params`` as a flax tree
    (``runtime.weights.load_flax_npz``), 106 arrays, 887 032 parameters;
  * ``flagship_outputs.npz``: the JAX package's ``FastStereoNet`` with
    those weights, on the CPU under ``XLA_FLAGS`` = :data:`XLA_FLAGS` (it
    rounds where the flax code does, as the port does):

      - ``f32_disparity``/``f32_confidence``, ``bf16_disparity``/
        ``bf16_confidence``: scenes :data:`SCENES` of the held-out set
        (:func:`heldout_dataset`), [2, 256, 512] and [2, 32, 64];
      - ``bf16_720p_disparity``: the frame of :func:`frame_720p`, [720, 1280];
      - ``heldout_epe`` (per scene, [120]) and ``heldout_d1``: the JAX
        ``evaluate_dataset`` in bf16 over the held-out set;
      - ``xla_flags`` and ``jax_version``: how they were made;

  * ``flagship_int8_outputs.npz``: the same network run w8a8 by the JAX
    package (``ops/quant.py``), in bf16, under the same ``XLA_FLAGS``, for
    each scheme ``dynamic`` (``quantized_apply``) and ``static``
    (``static_quantized_apply`` with :data:`CALIB_JSON`):

      - ``<scheme>_disparity`` [2, 256, 512] on scenes :data:`SCENES`;
      - ``<scheme>_heldout_epe`` (per scene, [120]) and
        ``<scheme>_heldout_d1``: the JAX ``evaluate_dataset`` over the
        held-out set.

  * ``classic_params.npz``: ``checkpoints/frontier_CLASSIC`` (the CLASSIC
    StereoNet, ``StereoNetConfig()`` read by ``StereoNet``), 202 arrays,
    428 156 parameters;
  * ``classic_outputs.npz``: the JAX package's ``StereoNet`` with those
    weights, under the same ``XLA_FLAGS``, with the default RGB
    preprocessing (as ``scripts/accuracy_stats.py`` evaluates CLASSIC):
    the same keys as ``flagship_outputs.npz``.
  * ``classic_calib.json``: the JAX package's ``calibrate_activation_scales``
    of CLASSIC with those weights over the calibration set of ``stereod
    calibrate`` (8 synthetic frames at 256x512, seed 4242, RGB), one scale a
    conv (53), keyed by flax path;
  * ``classic_int8_outputs.npz``: the JAX package's CLASSIC run w8a8 in bf16
    under the same ``XLA_FLAGS``, for each scheme ``dynamic`` and ``static``
    (with ``classic_calib.json``): ``<scheme>_disparity`` [2, 256, 512] on
    scenes :data:`SCENES`, ``<scheme>_720p_disparity`` on the frame of
    :func:`frame_720p`, ``<scheme>_heldout_epe`` ([120]) and
    ``<scheme>_heldout_d1`` over the held-out set.

  * ``flagship_train_step.npz`` and ``classic_train_step.npz``: one
    training step of the JAX package on the CPU under the same ``XLA_FLAGS``,
    from ``flagship_params.npz`` (YUV input) and ``classic_params.npz`` (RGB
    input), at full width on the batch of :func:`train_step_batch` (4 crops
    of 128x256): ``left_u8``, ``right_u8``, ``disparity``, then for each
    precision ``f32`` (``compute_dtype=float32``) and ``bf16``: ``<p>_loss``,
    ``<p>_epe``, ``<p>_grad_norm`` and every parameter's gradient
    ``<p>_grad/<flax path>`` (float32), as ``jax.value_and_grad`` of
    ``multiscale_loss`` gives them.

The flagship's files are written by ``python tests/test_torch_reference.py
--write``, CLASSIC's by ``python tests/test_torch_classic_reference.py
--write`` and (int8) ``python tests/test_torch_classic_int8.py --write``,
the training steps by ``python tests/test_torch_train_reference.py
--write``; the same files' tests check on every run that they are still
what the checkpoints and the JAX package give.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

REF_DIR = Path(__file__).resolve().parent
PARAMS_NPZ = REF_DIR / "flagship_params.npz"
OUTPUTS_NPZ = REF_DIR / "flagship_outputs.npz"
INT8_OUTPUTS_NPZ = REF_DIR / "flagship_int8_outputs.npz"
CLASSIC_PARAMS_NPZ = REF_DIR / "classic_params.npz"
CLASSIC_OUTPUTS_NPZ = REF_DIR / "classic_outputs.npz"
CLASSIC_CALIB_JSON = REF_DIR / "classic_calib.json"
CLASSIC_INT8_OUTPUTS_NPZ = REF_DIR / "classic_int8_outputs.npz"
# The flagship's calibrated activation scales, one per conv, keyed by flax path.
CALIB_JSON = REF_DIR.parents[1] / "checkpoints" / "flagship" / "calib.json"
INT8_SCHEMES = ("dynamic", "static")
XLA_FLAGS = "--xla_allow_excess_precision=false"

# The held-out set of scripts/accuracy_stats.py (the flagship's published
# EPE, accuracy_stats.json), the two of its scenes whose outputs are kept,
# and the scene seed of the 720p frame.
HELDOUT = dict(size=120, seed=777, height=256, width=512)
SCENES = (0, 1)
FRAME_SEED = 720
# The flagship's held-out EPE, mean and 95 % interval (accuracy_stats.json,
# YUV_ft.heldout).
HELDOUT_EPE_PX = 0.8689
HELDOUT_EPE_CI95_PX = 0.0754
# CLASSIC's held-out EPE, mean and 95 % interval (accuracy_stats.json,
# CLASSIC.heldout).
CLASSIC_HELDOUT_EPE_PX = 0.9374
CLASSIC_HELDOUT_EPE_CI95_PX = 0.0775


# The training step's batch: the first of BatchIterator over these scenes.
TRAIN_STEP_NPZ = {"fast": REF_DIR / "flagship_train_step.npz",
                  "classic": REF_DIR / "classic_train_step.npz"}
TRAIN_STEP_SCENES = dict(size=4, seed=0, height=256, width=512)
TRAIN_STEP_BATCH = dict(batch_size=4, crop_hw=(128, 256), seed=0)
# One float32 step at full width against the stored one: the loss within
# 1e-5 relative, the gradients' global norm within TRAIN_F32_NORM_RTOL, each gradient within 1e-3
# relative L2.  Not 1e-4 (which the small configs meet, tests/test_torch_training.py):
# a LeakyReLU input within float32 error of zero takes the other branch in
# another float32 run, and one such element of the 524 288 at the tower's
# 1/4 resolution moves the gradients of the blocks below it by about 1e-3
# relative (measured on the CPU: the port's float32 gradients of
# FeatureTower_0/ConvBlock_0-1 lie 2.5e-4 to 7.7e-4 from a float64 run,
# JAX's 2e-5; every other tensor within 1e-5 of float64).
# CLASSIC's global norm is held at its gradients' 1e-3: its float32 forward
# is already 2.3e-3 px off JAX's (ROADMAP C5), and the norm moved 1.1e-5 to
# 6.7e-5 from JAX's with the CPU's thread count.
TRAIN_F32_RTOL = 1e-5
TRAIN_F32_NORM_RTOL = {"fast": 1e-5, "classic": 1e-3}
TRAIN_F32_GRAD_RTOL = 1e-3
# The sharded float32 step on a row-tiled mesh (tile > 1) on the card: each
# gradient within TRAIN_F32_TILE_GRAD_RTOL of the stored step, and all of
# them together (grad_distance) within TRAIN_F32_GRAD_RTOL.  The tiles'
# statistics (float64 sums of each tile's float32 chains) round otherwise
# than one image's chain, so another LeakyReLU input near zero flips branch
# than in JAX's step and the one-rank step: on the H100 CLASSIC's (1, 2)
# step read 1.0225e-3 at RefinementNet_0/ConvBlock_0/Conv_0/kernel (the CPU
# 9.67e-4; there a float64 run puts JAX's and the one-rank step's float32
# gradient of that tensor 3.0e-4 from it, the tiled one's 9.2e-4), while
# over all tensors the tiled step lies nearer the float64 run than JAX's
# float32 step does (median per tensor 1.0e-4 against 2.5e-4; python
# tests/test_torch_sharded_training.py --accuracy).  Two flips' worth per
# tensor.
TRAIN_F32_TILE_GRAD_RTOL = 2e-3
# bf16: over all the gradients together, the port's bf16 gradient is no
# farther (relative L2) from JAX's bf16 one than JAX's bf16 is from JAX's
# float32 one.  Per tensor the two bf16 errors are of one size but
# independent (PyTorch's fused backward kernels round once where XLA
# without excess precision rounds after every operation), so per tensor the
# check only catches a missing or wrong gradient: each gradient that JAX's
# bf16 resolves (within BF16_RESOLVED of its float32 one) lies within
# BF16_TENSOR_RTOL of JAX's float32 gradient.  (Most conv biases' bf16
# gradients, sums over every pixel that cancel, are 15-100 % off float32 in
# JAX's own step; they count in the global bound only.)  The bf16 loss lies
# at most BF16_LOSS_FACTOR times as far from JAX's float32 loss as JAX's
# bf16 loss does.
BF16_RESOLVED = 0.1
BF16_TENSOR_RTOL = 0.5
BF16_LOSS_FACTOR = 4.0
# A gradient that cancels to zero in exact arithmetic (a conv bias under a
# GroupNorm of one channel a group; the last cost conv's bias, which the
# softmax ignores) is float32 noise on both sides: it is held within this
# share of the global gradient norm instead.
ZERO_GRAD_SHARE = 1e-6


def heldout_dataset():
    """The 120 held-out procedural scenes at 256x512."""
    from ..data.loader import SyntheticStereoDataset

    return SyntheticStereoDataset(**HELDOUT)


def frame_720p() -> np.ndarray:
    """The reference's 720p side-by-side NV12 frame: one procedural scene,
    encoded with the port's numpy/torch code (any machine makes the same)."""
    from ..data.stream import rgb_pair_to_sbs_nv12
    from ..data.synthetic import SyntheticConfig, generate_pair

    l, r, _ = generate_pair(np.random.default_rng(FRAME_SEED),
                            SyntheticConfig(height=720, width=1280))
    return rgb_pair_to_sbs_nv12(l, r)


def load_params(path: Path = PARAMS_NPZ) -> dict:
    """The flagship's weights (``path``: :data:`CLASSIC_PARAMS_NPZ` for
    CLASSIC's) as a flax variables dict."""
    from ..runtime.weights import load_flax_npz

    return load_flax_npz(str(path))


def load_outputs(path: Path = OUTPUTS_NPZ) -> dict:
    """The JAX outputs, ``{name: array}`` (``path``: :data:`INT8_OUTPUTS_NPZ`
    for the int8 ones, :data:`CLASSIC_OUTPUTS_NPZ` for CLASSIC's)."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def train_step_batch():
    """(left uint8 [4,128,256,3], right, disparity float32 [4,128,256]): the
    batch of the stored training steps, made with the port's numpy code."""
    from ..data.loader import BatchIterator, SyntheticStereoDataset

    return next(iter(BatchIterator(SyntheticStereoDataset(**TRAIN_STEP_SCENES),
                                   **TRAIN_STEP_BATCH)))


def load_train_step(model: str = "fast") -> dict:
    """The stored training step of ``model`` (``"fast"``, ``"classic"``):
    the batch's arrays, and per precision (``"f32"``, ``"bf16"``) a dict of
    ``loss``, ``epe``, ``grad_norm`` and ``grads`` ({flax path: array})."""
    raw = load_outputs(TRAIN_STEP_NPZ[model])
    out = {k: raw[k] for k in ("left_u8", "right_u8", "disparity", "color_space")}
    for p in ("f32", "bf16"):
        out[p] = {k: float(raw[f"{p}_{k}"]) for k in ("loss", "epe", "grad_norm")}
        out[p]["grads"] = {k[len(p) + 6:]: raw[k] for k in raw if k.startswith(f"{p}_grad/")}
    return out


def _norm(a) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64)))


def bf16_grad_check(got: dict, want16: dict, want32: dict) -> dict:
    """The port's bf16 gradients ``got`` against JAX's bf16 (``want16``) and
    float32 (``want32``) ones, {flax path: array} each: ``ratio``, the
    port's distance from JAX's bf16 over JAX's bf16 distance from float32,
    over all gradients together (must be <= 1); ``share``, the share of
    tensors that meet that bound alone; ``worst``, (path, relative L2
    distance from JAX's float32) of the farthest gradient among those JAX's
    bf16 resolves (must be <= :data:`BF16_TENSOR_RTOL`); ``ok``."""
    num = den = 0.0
    within, worst = 0, ("", 0.0)
    for path, w32 in want32.items():
        p, w16 = np.asarray(got[path], np.float64), np.asarray(want16[path], np.float64)
        d_port, d_jax = _norm(p - w16), _norm(w16 - w32)
        num, den = num + d_port ** 2, den + d_jax ** 2
        within += d_port <= d_jax
        if d_jax <= BF16_RESOLVED * _norm(w32):
            r = _norm(p - w32) / _norm(w32)
            if r > worst[1]:
                worst = (path, r)
    ratio = float(np.sqrt(num / den))
    return {"ratio": ratio, "share": within / len(want32), "worst": worst,
            "ok": ratio <= 1.0 and worst[1] <= BF16_TENSOR_RTOL}


def grad_distance(got: dict, want: dict) -> float:
    """The relative L2 distance of ``got`` from ``want`` ({flax path:
    array} each) over all gradients together."""
    num = sum(_norm(np.asarray(got[k], np.float64) - w) ** 2 for k, w in want.items())
    return float(np.sqrt(num / sum(_norm(w) ** 2 for w in want.values())))


def grad_mismatches(got: dict, want: dict, rtol: float) -> list:
    """[(path, relative L2 error)] of the gradients in ``got`` ({flax path:
    array}) farther than ``rtol`` from ``want``'s; one whose reference is
    below :data:`ZERO_GRAD_SHARE` of the global norm is held within that
    share of it (its error is reported as a share of the global norm)."""
    g = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64))) for v in want.values()))
    bad = []
    for path, w in want.items():
        diff = float(np.linalg.norm(np.asarray(got[path], np.float64) - w))
        ref = float(np.linalg.norm(np.asarray(w, np.float64)))
        if ref <= ZERO_GRAD_SHARE * g:
            if diff > ZERO_GRAD_SHARE * g:
                bad.append((path, diff / g))
        elif diff > rtol * ref:
            bad.append((path, diff / ref))
    return bad
