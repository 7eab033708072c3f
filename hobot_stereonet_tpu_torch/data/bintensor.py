"""Raw binary tensor exchange — the golden interface to external toolkits.

Counterpart of ``hobot_stereonet_tpu/data/bintensor.py`` (numpy only).

The reference's ``CvtBinData2Tensors`` (``stereonet_infer/src/
preprocess.cpp:429-583``, driven by ``RunBinFeedInfer``
``stereonet_node.cpp:441-590``) feeds a raw binary dump of the model's
*preprocessed input tensor* — float32 normalized values, or int8
already-quantized values, NCHW ``[1, 6, H, W]`` — straight into the
network, bypassing image decode and preprocessing entirely.  That is the
golden-exchange contract with the vendor training toolkit: the toolkit
dumps its exact input tensor, the deployment stack replays it, and the
outputs are diffed.

This module is the analog: load/save raw float/int tensor
dumps in either layout, with the same quantize/dequantize contract
(``Quantize`` scale 0.0078125 / zp 0.5 / floor / clamp,
``preprocess.cpp:1131-1136``), so ``stereod infer --input-bin`` replays a
foreign dump and ``stereod dump --bin-out`` produces one a foreign
toolkit can diff.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ..config import PreprocessConfig

#: channels in the model input tensor (stacked left/right 3-channel eyes,
#: reference merge order ``preprocess.cpp:998-1003``).
INPUT_CHANNELS = 6


def _infer_dtype(n_bytes: int, height: int, width: int) -> str:
    """'float32' or 'int8' from the file length (they differ 4x)."""
    n = INPUT_CHANNELS * height * width
    if n_bytes == 4 * n:
        return "float32"
    if n_bytes == n:
        return "int8"
    raise ValueError(
        f"bin file is {n_bytes} bytes; expected {4*n} (float32) or {n} "
        f"(int8) for a [{INPUT_CHANNELS},{height},{width}] input tensor — "
        f"set --bin-height/--bin-width to the dump's geometry"
    )


def load_input_tensor(
    path: str,
    height: int,
    width: int,
    dtype: str = "auto",
    layout: str = "nchw",
    cfg: PreprocessConfig = PreprocessConfig(),
) -> np.ndarray:
    """Read a raw input-tensor dump -> [1, H, W, 6] float32 normalized.

    ``dtype='auto'`` resolves float32 vs int8 from the file size (the
    reference hard-codes the choice at ``preprocess.cpp:507``; a length
    check is strictly more honest).  int8 dumps are dequantized with the
    input quant contract (q * scale, inverse of ``preprocess.cpp:
    1131-1136``); float dumps are taken as already-normalized values,
    exactly as the reference does.
    """
    raw = np.fromfile(path, dtype=np.uint8)
    if dtype == "auto":
        dtype = _infer_dtype(raw.size, height, width)
    n = INPUT_CHANNELS * height * width
    if dtype == "float32":
        if raw.size != 4 * n:
            raise ValueError(
                f"{path}: {raw.size} bytes != {4*n} for float32 "
                f"[{INPUT_CHANNELS},{height},{width}]"
            )
        x = raw.view(np.float32)
    elif dtype == "int8":
        if raw.size != n:
            raise ValueError(
                f"{path}: {raw.size} bytes != {n} for int8 "
                f"[{INPUT_CHANNELS},{height},{width}]"
            )
        x = raw.view(np.int8).astype(np.float32) * cfg.quant_scale
    else:
        raise ValueError(f"unknown bin dtype {dtype!r}")

    if layout == "nchw":
        x = x.reshape(INPUT_CHANNELS, height, width).transpose(1, 2, 0)
    elif layout == "nhwc":
        x = x.reshape(height, width, INPUT_CHANNELS)
    else:
        raise ValueError(f"unknown layout {layout!r} (nchw|nhwc)")
    return np.ascontiguousarray(x, dtype=np.float32)[None]


def quantize_input(x: np.ndarray, cfg: PreprocessConfig = PreprocessConfig()) -> np.ndarray:
    """Normalized float input -> int8 with the reference's input contract
    (floor(x/scale + zp), clamp — ``preprocess.cpp:1131-1136``)."""
    q = np.floor(x / cfg.quant_scale + cfg.quant_zero_point)
    return np.clip(q, cfg.quant_min, cfg.quant_max).astype(np.int8)


def save_input_tensor(
    path: str,
    x: np.ndarray,
    dtype: str = "float32",
    layout: str = "nchw",
    cfg: PreprocessConfig = PreprocessConfig(),
) -> None:
    """Write [1,H,W,6] (or [H,W,6]) normalized input as a raw dump in the
    exchange format (float32 normalized, or int8 quantized)."""
    x = np.asarray(x, np.float32)
    if x.ndim == 4:
        x = x[0]
    if layout == "nchw":
        x = x.transpose(2, 0, 1)
    elif layout != "nhwc":
        raise ValueError(f"unknown layout {layout!r} (nchw|nhwc)")
    if dtype == "int8":
        quantize_input(x, cfg).tofile(path)
    elif dtype == "float32":
        np.ascontiguousarray(x).tofile(path)
    else:
        raise ValueError(f"unknown bin dtype {dtype!r}")


# ---------------------------------------------------------------------------
# .bin dump directories (golden exchange with compare/load_dump)
# ---------------------------------------------------------------------------

META = "meta.json"


def save_bin_dir(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write {name: array} as <path>/<name>.bin raw files + meta.json
    (shape/dtype per tensor) — the loose-.bin-files habit of the
    reference's golden workflow (``preprocess.cpp:398-399,540-548``),
    with just enough metadata to read it back mechanically."""
    os.makedirs(path, exist_ok=True)
    meta = {}
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        if arr.dtype.kind not in "fiub":  # e.g. bfloat16: widen for exchange
            arr = arr.astype(np.float32)
        safe = name.replace("/", "__")
        arr.tofile(os.path.join(path, safe + ".bin"))
        meta[safe] = {"shape": list(arr.shape), "dtype": arr.dtype.name}
    with open(os.path.join(path, META), "w") as f:
        json.dump(meta, f, indent=1)


def load_bin_dir(path: str) -> Dict[str, np.ndarray]:
    """Read a .bin dump directory back to {name: array}.

    With meta.json, shapes/dtypes restore exactly.  Foreign directories
    without meta load each ``*.bin`` as a flat float32 vector — enough for
    ``compare`` (which flattens on size-equal shape mismatch)."""
    meta_path = os.path.join(path, META)
    meta = {}
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    out: Dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(path)):
        if not fn.endswith(".bin"):
            continue
        name = fn[: -len(".bin")]
        raw = np.fromfile(os.path.join(path, fn), dtype=np.uint8)
        m = meta.get(name)
        if m is not None:
            arr = raw.view(np.dtype(m["dtype"])).reshape(m["shape"])
        else:
            arr = raw.view(np.float32) if raw.size % 4 == 0 else raw
        out[name.replace("__", "/")] = arr
    return out
