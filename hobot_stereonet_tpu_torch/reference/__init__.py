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

The flagship's files are written by ``python tests/test_torch_reference.py
--write``, CLASSIC's by ``python tests/test_torch_classic_reference.py
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
