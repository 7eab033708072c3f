"""ctypes bindings for the native host-IO runtime (``native/hostio.cpp``).

Counterpart of ``hobot_stereonet_tpu/runtime/hostio.py``, over the port's
own copy of the C++ source (``hobot_stereonet_tpu_torch/native/hostio.cpp``).
It is built with ``g++ -O3`` on first use into
``build/hostio/libhostio-<source hash>.so`` under the checkout root (written
to a temporary name and renamed, so that processes building at once do not
clash), and exposes:

  * :class:`FrameRing`: the lock-free SPSC frame ring (the hbmem transport
    equivalent) for capture -> feed pipelines;
  * :func:`nv12_split_sbs`, :func:`nv12_to_yuv444`, :func:`bgr_to_nv12`:
    native host colour-space and split ops.

``available()`` is False where no compiler exists, and callers fall back
to their numpy paths (``data.stream.ThreadedCaptureSource``: a queue).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "hostio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hostio"

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source is built."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libhostio-{digest}.so"


def _build() -> Optional[Path]:
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                        str(SRC), "-o", str(tmp)], check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return lib
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_push.restype = ctypes.c_int
        lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double,
                                  ctypes.c_int64]
        lib.ring_pop.restype = ctypes.c_int
        lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
        lib.ring_size.restype = ctypes.c_size_t
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.ring_dropped.restype = ctypes.c_uint64
        lib.ring_dropped.argtypes = [ctypes.c_void_p]
        for name in ("nv12_split_sbs", "nv12_to_yuv444", "bgr_to_nv12"):
            getattr(lib, name).restype = None
        lib.nv12_split_sbs.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_int, ctypes.c_int]
        lib.nv12_to_yuv444.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int]
        lib.bgr_to_nv12.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _buf(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_char_p)


class FrameRing:
    """Lock-free SPSC ring of fixed-size frames (native storage)."""

    def __init__(self, frame_bytes: int, capacity: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native hostio unavailable (no compiler?)")
        self._lib = lib
        self.frame_bytes = frame_bytes
        self.capacity = capacity
        self._handle = lib.ring_create(frame_bytes, capacity)

    def push(self, frame: np.ndarray, timestamp: float = 0.0, index: int = 0) -> bool:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.nbytes != self.frame_bytes:
            raise ValueError(f"frame of {frame.nbytes} bytes, ring of {self.frame_bytes}")
        return bool(self._lib.ring_push(self._handle, _buf(frame), float(timestamp), int(index)))

    def pop(self) -> Optional[Tuple[np.ndarray, float, int]]:
        out = np.empty(self.frame_bytes, np.uint8)
        ts = ctypes.c_double()
        idx = ctypes.c_int64()
        if not self._lib.ring_pop(self._handle, _buf(out), ctypes.byref(ts), ctypes.byref(idx)):
            return None
        return out, ts.value, idx.value

    def __len__(self) -> int:
        return int(self._lib.ring_size(self._handle))

    @property
    def dropped(self) -> int:
        return int(self._lib.ring_dropped(self._handle))

    def close(self):
        if self._handle:
            self._lib.ring_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def _require_lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("native hostio unavailable (no C++ compiler?): use the torch ops in "
                           "hobot_stereonet_tpu_torch.ops.colorspace instead")
    return lib


def nv12_split_sbs(sbs: np.ndarray, height: int, full_width: int):
    lib = _require_lib()
    sbs = np.ascontiguousarray(sbs, np.uint8)
    n = height * (full_width // 2) * 3 // 2
    left = np.empty(n, np.uint8)
    right = np.empty(n, np.uint8)
    lib.nv12_split_sbs(_buf(sbs), _buf(left), _buf(right), height, full_width)
    return left, right


def nv12_to_yuv444(nv12: np.ndarray, height: int, width: int) -> np.ndarray:
    lib = _require_lib()
    nv12 = np.ascontiguousarray(nv12, np.uint8)
    out = np.empty((height, width, 3), np.uint8)
    lib.nv12_to_yuv444(_buf(nv12), _buf(out), height, width)
    return out


def bgr_to_nv12(bgr: np.ndarray) -> np.ndarray:
    lib = _require_lib()
    bgr = np.ascontiguousarray(bgr, np.uint8)
    h, w = bgr.shape[:2]
    out = np.empty(h * w * 3 // 2, np.uint8)
    lib.bgr_to_nv12(_buf(bgr), _buf(out), h, w)
    return out
