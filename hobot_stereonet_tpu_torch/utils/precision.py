"""float32 that stays float32 on the card.

PyTorch runs float32 convolutions through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits of each operand.  The reference is JAX's float32 on the
CPU, so a float32 network of the port runs its convolutions and matrix
products in full float32: :func:`float32_exact` turns TF32 off for cuDNN
and for matrix products and restores both settings on exit.  The
networks' forward (so the engine and the evaluation) and the train step
enter it through :func:`exact_float32` whenever they compute in float32 on
CUDA; bf16 and int8 leave the settings alone.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch

_lock = threading.Lock()
_depth = 0
_saved = (True, False)


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _set(cudnn: bool, matmul: bool) -> None:
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """TF32 off for cuDNN and matrix products inside; the settings found at
    the outermost entry restored at its exit (nested and concurrent entries
    keep TF32 off until the last one leaves)."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = _flags()
        _depth += 1
        _set(False, False)
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                _set(*_saved)


def on_card(device: "str | torch.device") -> bool:
    return torch.device(device).type == "cuda"


def exact_float32(dtype: torch.dtype, device: "str | torch.device"):
    """:func:`float32_exact` where ``dtype`` is float32 and ``device`` a
    CUDA device, else a context that changes nothing."""
    if dtype == torch.float32 and on_card(device):
        return float32_exact()
    return contextlib.nullcontext()
