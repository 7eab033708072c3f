"""Live-stream sources: side-by-side NV12 camera frames.

Counterpart of ``hobot_stereonet_tpu/data/stream.py``: the ``Frame`` the
engine takes, the host-side conversions between an RGB pair and the
camera's side-by-side NV12 buffer, a paced synthetic source, and the
device frame ring that the benchmark feeds from.

The ring stands in for a camera that writes frames into device memory: one
``[R, L]`` uint8 tensor on the device, staged once.  Frames carry
:class:`RingSlot` handles, and the engine turns a batch of slots of one
ring into a single gather on the device, with no host copy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..ops import colorspace as cs


@dataclass
class Frame:
    timestamp: float
    sbs_nv12: np.ndarray  # flat uint8, side-by-side NV12 (or a RingSlot)
    height: int
    full_width: int
    gt_disparity: Optional[np.ndarray] = None  # [H, W] when known
    index: int = 0


def rgb_pair_to_sbs_nv12(left_rgb: np.ndarray, right_rgb: np.ndarray) -> np.ndarray:
    """Two [H, W, 3] RGB uint8 images -> one flat side-by-side NV12 buffer
    (the camera's wire format), computed on the host."""
    sbs_rgb = np.concatenate([left_rgb, right_rgb], axis=1)
    bgr = torch.from_numpy(np.ascontiguousarray(sbs_rgb[..., ::-1]))
    return cs.bgr_to_nv12(bgr).numpy()


def sbs_nv12_to_left_rgb(sbs_nv12: np.ndarray, height: int, full_width: int) -> np.ndarray:
    """Host-side decode of the LEFT eye of a side-by-side NV12 buffer to RGB
    uint8 (numpy; the display path does not touch the device):
    nearest-neighbour chroma upsample and BT.601 full range."""
    h, fw = height, full_width
    w = fw // 2
    y = sbs_nv12[: h * fw].reshape(h, fw)[:, :w].astype(np.float32)
    uv = sbs_nv12[h * fw:].reshape(h // 2, fw // 2, 2)[:, : w // 2, :].astype(np.float32)
    u = uv[..., 0].repeat(2, axis=0).repeat(2, axis=1)
    v = uv[..., 1].repeat(2, axis=0).repeat(2, axis=1)
    b = y + (u - 128.0) / 0.492
    r = y + (v - 128.0) / 0.877
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    return np.clip(np.rint(np.stack([r, g, b], axis=-1)), 0, 255).astype(np.uint8)


class SyntheticStreamSource:
    """Yields paced side-by-side NV12 frames from the procedural generator."""

    def __init__(self, height: int = 720, width: int = 1280, fps: float = 15.0,
                 num_frames: int = 0, seed: int = 0, paced: bool = True):
        from .synthetic import SyntheticConfig, generate_pair

        self._cfg = SyntheticConfig(height=height, width=width)
        self._gen = generate_pair
        self.height, self.width = height, width
        self.fps = fps
        self.num_frames = num_frames  # 0 = endless
        self.seed = seed
        self.paced = paced

    def __iter__(self) -> Iterator[Frame]:
        period = 1.0 / self.fps if self.fps > 0 else 0.0
        i = 0
        next_t = time.monotonic()
        while self.num_frames == 0 or i < self.num_frames:
            rng = np.random.default_rng(self.seed * 7_000_003 + i)
            l, r, d = self._gen(rng, self._cfg)
            buf = rgb_pair_to_sbs_nv12(l, r)
            if self.paced:
                now = time.monotonic()
                if now < next_t:
                    time.sleep(next_t - now)
                next_t += period
            yield Frame(time.monotonic(), buf, self.height, 2 * self.width, d, i)
            i += 1


class RingSlot:
    """One frame's slot in a :class:`DeviceFrameRing`: a handle, not a copy.

    It has the ``dtype``/``size``/``shape`` the engine's feed check reads,
    and ``__array__`` for host consumers (a device-to-host copy of the slot).
    """

    __slots__ = ("ring", "slot")

    def __init__(self, ring: "DeviceFrameRing", slot: int):
        self.ring = ring
        self.slot = slot

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(np.uint8)

    @property
    def size(self) -> int:
        return self.ring.data.shape[1]

    @property
    def shape(self):
        return tuple(self.ring.data.shape[1:])

    def device_array(self) -> torch.Tensor:
        """The slot as a [L] view of the ring (no copy)."""
        return self.ring.data[self.slot]

    def __array__(self, dtype=None, copy=None):
        out = self.ring.data[self.slot].cpu().numpy()
        return out.astype(dtype) if dtype is not None else out


class DeviceFrameRing:
    """Side-by-side NV12 frames staged once on the device.

    ``data`` is one ``[ring_size, L]`` uint8 tensor on ``device`` (default
    ``cuda:0``), written by a copy on the device's current stream;
    ``ready`` is a CUDA event recorded after that copy (``None`` on the
    CPU), which a consumer on another stream waits for before it reads the
    ring.  ``frames(n)`` yields ``n`` frames that cycle through the slots.
    """

    def __init__(self, height: int = 720, width: int = 1280,
                 ring_size: int = 4, seed: int = 0, with_gt: bool = False,
                 device: "str | torch.device | None" = None):
        from ..config import resolve_device
        from .synthetic import SyntheticConfig, generate_pair

        self.device = resolve_device(device, "DeviceFrameRing")
        cfg = SyntheticConfig(height=height, width=width)
        self.height, self.width = height, width
        self._gt: List[Optional[np.ndarray]] = []
        bufs = []
        for i in range(ring_size):
            rng = np.random.default_rng(seed * 9_000_011 + i)
            l, r, d = generate_pair(rng, cfg)
            bufs.append(rgb_pair_to_sbs_nv12(l, r))
            self._gt.append(d if with_gt else None)
        self.data = torch.from_numpy(np.stack(bufs)).to(self.device)
        self.ready = None
        if self.device.type == "cuda":
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(self.device))

    def frames(self, n: int) -> Iterator[Frame]:
        k = self.data.shape[0]
        for i in range(n):
            yield Frame(time.monotonic(), RingSlot(self, i % k), self.height,
                        2 * self.width, self._gt[i % k], i)
