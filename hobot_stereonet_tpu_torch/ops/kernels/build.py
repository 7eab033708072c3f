"""Build and load the port's CUDA kernels.

Each source in ``hobot_stereonet_tpu_torch/csrc/*.cu`` compiles in its own
``nvcc`` process, all started together, and one more ``nvcc`` links the
objects into ``build/kernels/libhst_kernels.so`` (under the checkout root).
That happens the first time a kernel is launched, and again whenever a
source's hash changes.  Each source exports ``extern "C"`` functions that take raw
pointers, sizes and a ``cudaStream_t`` and return ``cudaGetLastError()``;
they are bound here with ``ctypes``.  No PyTorch headers are compiled, so
the build takes seconds.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libhst_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

# Kernel launches on CUDA tensors, by kernel name.  Each wrapper adds one
# where it launches its kernel and nowhere else; plain-version calls on CPU
# tensors do not count.
launch_counts: "collections.Counter[str]" = collections.Counter()
# The same launches by route, for kernels that take one of several by shape
# ("soft_argmin_cost/vector", "correlation_bwd/mma", ...).
route_counts: "collections.Counter[str]" = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of every exported function: (argtypes), restype is int.
_SIGNATURES = {
    # src, dst, B, H, W, rgb, quantize, stream
    "hst_nv12_ingest": (_P, _P, _I, _I, _I, _I, _I, _P),
    # fl, fr, out, B, H, W, C, D, divisor, is_bf16, stream
    "hst_correlation": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    # logits, disp, conf, N, D, scale, is_bf16, vector, stream
    "hst_soft_argmin": (_P, _P, _P, _I, _I, _F, _I, _I, _P),
    # cost, disp, conf, B, D, H*W, scale, is_bf16, vector (else the scalar route), stream
    "hst_soft_argmin_dlead": (_P, _P, _P, _I, _I, _I, _F, _I, _I, _P),
    # dcorr, fl, fr, dfl, dfr, B, H, W, C, D, 1/divisor, is_bf16, mma (else SIMT), stream
    "hst_correlation_backward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    # x, gd, gc, dx, B, D, H*W, scale, is_bf16, then the plan
    # (correlation.soft_argmin_backward_plan): staged (else scalar), lanes, pixels,
    # threads, grid x, grid y, shared bytes; stream.  x: logits [B, H*W, D] or
    # a cost [B, D, H*W].
    "hst_soft_argmin_backward": (_P, _P, _P, _P, _I, _I, _I, _F, _I) + (_I,) * 7 + (_P,),
    "hst_soft_argmin_dlead_backward": (_P, _P, _P, _P, _I, _I, _I, _F, _I) + (_I,) * 7 + (_P,),
    # x, w, s_k, bias, sx, qs, y, plan (int8_conv.PlanArgs), per_sample, divide, stream
    "hst_int8_conv": (_P,) * 8 + (_I, _I, _P),
    # acc, its row stride, rows, Cout, rows a sample, sx, per_sample, s_k, bias, y, is_bf16,
    # stream
    "hst_int8_epilogue": (_P, _L, _L, _I, _L, _P, _I, _P, _P, _P, _I, _P),
    # x, conv bias, bias is bf16, skip, activate, gamma, beta, y, r, mean, rstd,
    # workspace, its bytes, phase clock, sequential, mode, group sums, N, C, P, G, R, eps,
    # is_bf16, stream
    "hst_group_norm": (_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _L, _P,
                       _I, _I, _P, _I, _I, _I, _I, _I, ctypes.c_double, _I, _P),
}

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    launch_counts.clear()
    route_counts.clear()


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _run(cmds: list) -> list:
    """Run the commands at once; return (cmd, returncode, output) for each."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    results = []
    try:
        for cmd, proc in procs:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            results.append((cmd, proc.returncode, out))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def build() -> Path:
    """Compile the kernels if the library is missing or out of date.

    Returns the library's path.  Prints the build's wall time and writes
    the compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) to ``build/kernels/build.log``.
    """
    digest = _source_hash()
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "source.sha256"
    if lib_path.is_file() and stamp.is_file() and stamp.read_text().strip() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [BUILD_DIR / f".{src.stem}.{pid}.o" for src in sources()]
    tmp = BUILD_DIR / f".{LIB_NAME}.{pid}.tmp"
    t0 = time.monotonic()
    try:
        steps = [_run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                       for src, obj in zip(sources(), objs)])]
        if all(rc == 0 for _, rc, _ in steps[0]):
            steps.append(_run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]]))
        wall = time.monotonic() - t0
        results = [r for step in steps for r in step]
        (BUILD_DIR / "build.log").write_text(
            "".join(" ".join(cmd) + "\n" + out for cmd, _, out in results))
        failed = [(cmd, rc, out) for cmd, rc, out in results if rc != 0]
        if failed:
            cmd, rc, out = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}) after {wall:.1f} s: "
                               f"{' '.join(cmd)}\n{out[-4000:]}")
        os.replace(tmp, lib_path)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    stamp.write_text(digest + "\n")
    print(f"[kernels] built {lib_path.name} from {len(objs)} sources "
          f"in {wall:.2f} s", flush=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(name: str, err: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_handle(t) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
