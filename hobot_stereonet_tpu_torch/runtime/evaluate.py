"""Dataset evaluation: EPE and D1-all over an indexable dataset.

Counterpart of ``hobot_stereonet_tpu/runtime/evaluate.py``.  Each pair goes
through :func:`~..ops.preprocess.rgb_pair_to_model_input` and the port's
network on the model's device, so on the card it runs the network's
kernels (correlation and soft-argmin for ``FastStereoNet``, the D-leading
soft-argmin for the CLASSIC ``StereoNet``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..ops import disparity as dp
from ..ops import preprocess as pp


@dataclass
class EvalResult:
    epe: float
    d1_all: float
    n_frames: int
    fps: float
    per_frame_epe: list = field(default_factory=list)

    def to_dict(self) -> Dict:
        return {
            "epe_px": round(self.epe, 4),
            "d1_all": round(self.d1_all, 4),
            "n_frames": self.n_frames,
            "fps": round(self.fps, 2),
        }


def evaluate_dataset(
    model,
    params: Optional[Mapping],
    dataset: Sequence,
    cfg: Config = Config(),
    max_frames: int = 0,
    batch_compile_hw: Optional[tuple] = None,
    int8: bool = False,
    static_quant=None,
    device: "str | torch.device | None" = None,
) -> EvalResult:
    """Run the network over a dataset of ``StereoSample`` and return the
    EPE and D1-all over its valid pixels (0 < GT < max disparity), each
    frame weighted by its count of valid pixels.

    ``model`` is a port network, or ``"fast"``, ``"classic"`` or ``None``
    (``"fast"``) for one built from ``cfg.model`` on ``device`` (default
    ``cuda:0``); ``params``, a flax parameter tree, is loaded into it
    unless ``None``.  Each frame is padded
    at the bottom and right to the stride multiple (twice the cost-volume
    divisor), or to ``batch_compile_hw`` if larger, and the prediction is
    cropped back.  ``int8=True`` evaluates w8a8 with dynamic scales,
    ``static_quant`` (a calibration dict or ``calib.json`` path) with
    calibrated ones; ``model`` must then still hold float32 weights.
    """
    from ..models import build_model, model_name
    from ..ops.quant import serving_model
    from .weights import from_flax_params

    model = build_model(model or "fast", cfg.model, device)
    if params is not None:
        model.load_state_dict(from_flax_params(params, model.cfg, model_name(model)))
    model = serving_model(model, int8, static_quant)
    dev = next(model.parameters()).device

    k = cfg.model.cost_resolution_divisor * 2
    n = len(dataset) if max_frames == 0 else min(max_frames, len(dataset))
    if batch_compile_hw is None:
        first = dataset[0]
        batch_compile_hw = (-(-first.left.shape[0] // k) * k, -(-first.left.shape[1] // k) * k)
    H, W = batch_compile_hw

    epes, d1s, weights = [], [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i in range(n):
            s = dataset[i]
            h0, w0 = s.left.shape[:2]
            H = max(H, -(-h0 // k) * k)
            W = max(W, -(-w0 // k) * k)
            l = np.pad(s.left, [(0, H - h0), (0, W - w0), (0, 0)])
            r = np.pad(s.right, [(0, H - h0), (0, W - w0), (0, 0)])
            x = pp.rgb_pair_to_model_input(l, r, cfg.preprocess, dev)
            pred = model(*pp.split_model_input(x))["disparity"][0, :h0, :w0]

            gt = torch.from_numpy(np.ascontiguousarray(s.disparity)).to(dev)
            valid = (gt > 0) & (gt < cfg.model.max_disparity)
            nv = int(valid.sum())
            if nv == 0:
                continue
            epes.append(float(dp.end_point_error(pred, gt, valid)))
            d1s.append(float(dp.d1_all(pred, gt, valid)))
            weights.append(float(nv))
    dt = time.perf_counter() - t0

    return EvalResult(
        epe=float(np.average(epes, weights=weights)) if epes else float("nan"),
        d1_all=float(np.average(d1s, weights=weights)) if d1s else float("nan"),
        n_frames=n,
        fps=n / dt if dt > 0 else 0.0,
        per_frame_epe=epes,
    )
