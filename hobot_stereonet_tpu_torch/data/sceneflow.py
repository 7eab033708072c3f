"""SceneFlow (FlyingThings3D / Driving / Monkaa) dataset loader.

Counterpart of ``hobot_stereonet_tpu/data/sceneflow.py`` (numpy; images
through PIL, imported when an image is read).

Replaces the reference's training-data lineage: its model was trained on
SceneFlow with OpenExplorer HAT (``README.md:5``).  Standard layout:

  <root>/frames_cleanpass/.../left/XXXX.png   (RGB)
  <root>/frames_cleanpass/.../right/XXXX.png
  <root>/disparity/.../left/XXXX.pfm          (float disparity, left view)

Includes a self-contained PFM reader (SceneFlow GT format).  All functions
gate on path existence so the module imports cleanly without the dataset.
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

import numpy as np

from .loader import StereoSample


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file -> float32 array (H, W) or (H, W, 3).

    PFM spec: ASCII header (``PF``/``Pf``, dims, scale whose sign encodes
    endianness), then raw floats bottom-to-top.
    """
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        color = header == "PF"

        dims = f.readline().decode("latin-1")
        while dims.startswith("#"):  # comments
            dims = f.readline().decode("latin-1")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: bad PFM dims {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"

        data = np.fromfile(f, endian + "f4", count=w * h * (3 if color else 1))
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path: str, data: np.ndarray) -> None:
    data = np.asarray(data, np.float32)
    color = data.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        np.flipud(data).astype("<f4").tofile(f)


def _read_image(path: str) -> np.ndarray:
    """RGB uint8 via PIL (no OpenCV dependency)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def find_pairs(root: str, subset: str = "frames_cleanpass") -> List[Tuple[str, str, str]]:
    """Walk the SceneFlow layout -> [(left_png, right_png, left_pfm)]."""
    pairs = []
    img_root = os.path.join(root, subset)
    if not os.path.isdir(img_root):
        return pairs
    for dirpath, _dirnames, filenames in os.walk(img_root):
        if os.path.basename(dirpath) != "left":
            continue
        for fn in sorted(filenames):
            if not fn.endswith(".png"):
                continue
            left = os.path.join(dirpath, fn)
            right = os.path.join(os.path.dirname(dirpath), "right", fn)
            disp = left.replace(subset, "disparity").replace(".png", ".pfm")
            if os.path.exists(right) and os.path.exists(disp):
                pairs.append((left, right, disp))
    return pairs


class SceneFlowDataset:
    """Index-based access over the discovered pairs."""

    def __init__(self, root: str, subset: str = "frames_cleanpass"):
        self.pairs = find_pairs(root, subset)
        if not self.pairs:
            raise FileNotFoundError(
                f"no SceneFlow pairs under {root!r} (subset {subset!r})"
            )

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> StereoSample:
        l, r, d = self.pairs[i]
        disp = read_pfm(d)
        if disp.ndim == 3:
            disp = disp[..., 0]
        return StereoSample(_read_image(l), _read_image(r), np.abs(disp), name=l)
