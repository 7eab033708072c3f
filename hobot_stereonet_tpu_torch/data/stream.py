"""Live-stream sources: side-by-side NV12 camera frames.

Counterpart of ``hobot_stereonet_tpu/data/stream.py``: the ``Frame`` the
engine takes, the host-side conversions between an RGB pair and the
camera's side-by-side NV12 buffer, a paced synthetic source, and the
device frame ring that the benchmark feeds from.

``ThreadedCaptureSource`` runs any source in a capture thread that hands
frames to the feed side through the native host ring
(``runtime/hostio.py``); ``ImageListStreamSource`` replays image lists.

The device ring stands in for a camera that writes frames into device memory: one
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


class ThreadedCaptureSource:
    """Capture-thread decoupling over any frame source, transported through
    the native SPSC :class:`~..runtime.hostio.FrameRing`.

    The reference runs the camera in its own process and ships frames to
    the inference node over hbmem zero-copy shared memory
    (``stereonet_node.h:95-97``) — capture pacing and image decode never
    block inference, and a slow consumer drops frames instead of stalling
    the camera.  This is that topology inside one process: a producer
    thread iterates the wrapped source (decode + pacing happen there) and
    pushes raw frame bytes into the lock-free C++ ring
    (``hobot_stereonet_tpu_torch/native/hostio.cpp``); the consuming
    iterator pops on the feed side.
    Frame metadata that can't ride the byte ring (GT disparity for
    eval-over-stream) travels in a bounded side map keyed by the frame
    index the ring does carry.

    Falls back to a plain deque ring (same drop-on-full semantics) when no
    C++ toolchain is available — the product path stays importable
    anywhere, just without the native transport.  ``native`` says which
    ring carried the frames of the last iteration.
    """

    def __init__(self, source, capacity: int = 8,
                 use_native: Optional[bool] = None):
        self.source = source
        self.capacity = capacity
        if use_native is None:
            from ..runtime import hostio

            use_native = hostio.available()
        self.use_native = use_native
        self.dropped = 0
        self.native = False

    def __iter__(self) -> Iterator[Frame]:
        import queue as _queue
        import threading

        self.native = False

        meta: dict = {}
        meta_lock = threading.Lock()
        done = threading.Event()
        stop = threading.Event()  # consumer closed early: stop capturing
        error: list = []  # producer exception, re-raised on the feed side
        geom: list = []  # [(height, full_width)] set by the first frame
        geom_ready = threading.Event()
        ring = None
        fallback: "_queue.Queue" = _queue.Queue(maxsize=self.capacity)

        def produce():
            nonlocal ring
            try:
                for frame in self.source:
                    if stop.is_set():
                        # Consumer closed the iterator early (max_frames,
                        # feed-side exception): stop promptly instead of
                        # decoding the wrapped source to exhaustion —
                        # forever for an unbounded paced source.
                        break
                    buf = np.ascontiguousarray(
                        np.asarray(frame.sbs_nv12), np.uint8
                    )
                    if not geom:
                        geom.append((frame.height, frame.full_width))
                        if self.use_native:
                            from ..runtime.hostio import FrameRing

                            ring = FrameRing(buf.nbytes, self.capacity)
                            self.native = True
                        geom_ready.set()
                    with meta_lock:
                        meta[frame.index] = (frame.gt_disparity,
                                             frame.timestamp)
                    if ring is not None:
                        ok = ring.push(buf, frame.timestamp, frame.index)
                    else:
                        try:
                            fallback.put_nowait(
                                (buf, frame.timestamp, frame.index)
                            )
                            ok = True
                        except _queue.Full:
                            ok = False
                    if not ok:
                        # Ring full: drop the newest frame, exactly the
                        # engine/reference drop policy — capture never
                        # blocks on a slow consumer.
                        self.dropped += 1
                        with meta_lock:
                            meta.pop(frame.index, None)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                # Capture-side failures (decode errors, missing files in a
                # replay list) must surface on the feed side, not die
                # silently in the thread (same policy as the serving
                # loops' worker-error surfacing).
                error.append(e)
            finally:
                geom_ready.set()
                done.set()

        t = threading.Thread(target=produce, daemon=True,
                             name="capture-producer")
        t.start()
        try:
            geom_ready.wait()
            if not geom:
                if error:
                    raise RuntimeError("capture thread died") from error[0]
                return  # empty source
            height, full_width = geom[0]
            while True:
                item = None
                if ring is not None:
                    item = ring.pop()
                else:
                    try:
                        item = fallback.get_nowait()
                    except _queue.Empty:
                        item = None
                if item is None:
                    if done.is_set() and (
                        len(ring) == 0 if ring is not None
                        else fallback.empty()
                    ):
                        break
                    time.sleep(0.001)
                    continue
                buf, ts, idx = item
                with meta_lock:
                    gt, ts0 = meta.pop(idx, (None, ts))
                yield Frame(ts0, buf, height, full_width, gt, int(idx))
            if error:
                raise RuntimeError("capture thread died") from error[0]
        finally:
            stop.set()
            done.wait(timeout=5.0)
            t.join(timeout=5.0)
            if ring is not None:
                self.dropped = max(self.dropped, ring.dropped)
                ring.close()


def read_list_file(path: str) -> List[str]:
    """One image path per line (the reference's .list files,
    ``stereonet_node.cpp:832-887``); blank lines and #-comments ignored;
    relative paths resolve against the list file's directory."""
    import os

    base = os.path.dirname(os.path.abspath(path))
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            out.append(line if os.path.isabs(line)
                       else os.path.join(base, line))
    return out


class ImageListStreamSource:
    """Replay of (left, right) image-file pairs at a fixed pace — the
    reference's image-list feedback mode, minus the 300 ms hard-coding."""

    def __init__(self, left_paths: List[str], right_paths: List[str],
                 fps: float = 3.33, paced: bool = True):
        if len(left_paths) != len(right_paths):
            raise ValueError("left/right list length mismatch")
        self.left_paths = left_paths
        self.right_paths = right_paths
        self.fps = fps
        self.paced = paced

    def __iter__(self) -> Iterator[Frame]:
        from .sceneflow import _read_image

        period = 1.0 / self.fps if self.fps > 0 else 0.0
        next_t = time.monotonic()
        for i, (lp, rp) in enumerate(zip(self.left_paths, self.right_paths)):
            l, r = _read_image(lp), _read_image(rp)
            buf = rgb_pair_to_sbs_nv12(l, r)
            if self.paced:
                now = time.monotonic()
                if now < next_t:
                    time.sleep(next_t - now)
                next_t += period
            yield Frame(time.monotonic(), buf, l.shape[0], 2 * l.shape[1], None, i)
