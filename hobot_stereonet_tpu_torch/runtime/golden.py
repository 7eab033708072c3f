"""Golden-tensor dump and compare, for per-layer diffs against the reference.

Counterpart of ``hobot_stereonet_tpu/runtime/golden.py``.  A dump holds the
same keys as the reference's: ``input_normalized``, ``disparity``,
``confidence``, ``pyramid_<i>``, and ``inter/<flax module path>/__call__[0]``
for the output of every module (``inter/CorrelationAggregation2D_0/
__call__[0][0]`` and ``[0][1]`` for its two outputs).  The port's modules
carry the flax names, and their NCHW outputs are stored channel-last as the
reference's are, so a port dump and a JAX dump compare key by key.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.bintensor import load_bin_dir


def _nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dim() == 4:
        t = t.permute(0, 2, 3, 1)
    return t.float().cpu().numpy()


def _flax_output(module, args, kwargs, out):
    """The output of the flax module of ``module``'s name.  A block hands
    its conv's sum without the bias (``add_bias=False``) to its GroupNorm,
    which returns the block's output; flax's conv returns the sum plus its
    bias, and flax's GroupNorm the normalization alone, made here from the
    same input with the module's unfused call."""
    from ..models.layers import GroupNorm

    def channel(t):
        return t.view((1, -1) + (1,) * (args[0].dim() - 2))

    if kwargs.get("add_bias") is False:
        return out + channel(module.bias.to(out.dtype))
    if isinstance(module, GroupNorm) and kwargs:
        cb = kwargs.get("conv_bias")
        x = args[0] if cb is None else args[0] + channel(cb.to(args[0].dtype))
        return GroupNorm.forward(module, x)
    return out


def dump_pipeline(
    model,
    params: Optional[Mapping],
    left_rgb: np.ndarray,
    right_rgb: np.ndarray,
    cfg=None,
    path: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Run one stereo pair through a port network and capture every
    module's output.

    ``model`` is a ``FastStereoNet`` or ``StereoNet`` (its device and dtypes
    are used as they are); ``params``, a flax tree, is loaded into it unless
    ``None``.
    Returns ``{name: float32 array}``; writes a compressed ``.npz`` when
    ``path`` is given.
    """
    from ..config import Config
    from ..models import model_name
    from ..ops import preprocess as pp
    from .weights import from_flax_params

    cfg = cfg or Config()
    if params is not None:
        model.load_state_dict(from_flax_params(params, model.cfg, model_name(model)))
    dev = next(model.parameters()).device
    x = pp.rgb_pair_to_model_input(left_rgb, right_rgb, cfg.preprocess, dev)

    tensors: Dict[str, np.ndarray] = {}

    def hook(name):
        key = "inter/" + name.replace(".", "/") + "/__call__[0]"

        def store(module, args, kwargs, out):
            out = _flax_output(module, args, kwargs, out)
            if isinstance(out, tuple):
                for i, o in enumerate(out):
                    tensors[f"{key}[{i}]"] = _nhwc(o)
            else:
                tensors[key] = _nhwc(out)
        return store

    handles = [m.register_forward_hook(hook(name), with_kwargs=True)
               for name, m in model.named_modules() if name]
    try:
        with torch.inference_mode():
            out = model(*pp.split_model_input(x))
    finally:
        for h in handles:
            h.remove()

    tensors["input_normalized"] = x.float().cpu().numpy()       # already channel-last
    for name in ("disparity", "confidence"):
        tensors[name] = tensors[f"inter/__call__[0]/{name}"] = _nhwc(out[name])
    for i, lvl in enumerate(out["pyramid"]):
        tensors[f"pyramid_{i}"] = tensors[f"inter/__call__[0]/pyramid[{i}]"] = _nhwc(lvl)
    if path:
        np.savez_compressed(path, **tensors)
    return tensors


def compare(
    a: Dict[str, np.ndarray],
    b: Dict[str, np.ndarray],
    rtol: float = 1e-4,
    atol: float = 1e-4,
) -> Tuple[bool, Dict[str, Dict]]:
    """Diff two dumps.  Returns (all match, per-tensor report): per key its
    status, largest |a - b| and count of values beyond ``atol + rtol*|b|``.
    Keys in one dump only are "missing"; shapes that differ are "shape",
    unless one side is flat and the sizes agree (raw ``.bin`` dumps carry no
    shape), when the flat values are compared."""
    report = {}
    ok = True
    for k in sorted(set(a) | set(b)):
        if k not in a or k not in b:
            report[k] = {"status": "missing", "in_a": k in a, "in_b": k in b}
            ok = False
            continue
        ta, tb = np.asarray(a[k]), np.asarray(b[k])
        reshaped = False
        if ta.shape != tb.shape:
            if ta.size == tb.size and (ta.ndim == 1 or tb.ndim == 1):
                ta, tb = ta.ravel(), tb.ravel()
                reshaped = True
            else:
                report[k] = {"status": "shape", "a": ta.shape, "b": tb.shape}
                ok = False
                continue
        diff = np.abs(ta.astype(np.float64) - tb.astype(np.float64))
        max_abs = float(diff.max()) if diff.size else 0.0
        n_bad = int((diff > atol + rtol * np.abs(tb.astype(np.float64))).sum())
        report[k] = {"status": "ok" if n_bad == 0 else "mismatch",
                     "max_abs_diff": max_abs, "n_bad": n_bad,
                     **({"flat_compare": True} if reshaped else {})}
        ok = ok and n_bad == 0
    return ok, report


def load_dump(path: str) -> Dict[str, np.ndarray]:
    """Load a dump: an ``.npz``, a directory of raw ``.bin`` tensors
    (``data.bintensor.load_bin_dir``, which ``dump --bin-out`` writes for), or
    one raw ``.bin`` file (flat float32, keyed by its stem)."""
    if os.path.isdir(path):
        return load_bin_dir(path)
    if path.endswith(".bin"):
        raw = np.fromfile(path, dtype=np.uint8)
        arr = raw.view(np.float32) if raw.size % 4 == 0 else raw
        return {os.path.splitext(os.path.basename(path))[0]: arr}
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
