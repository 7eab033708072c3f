"""PyTorch/CUDA port of ``hobot_stereonet_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here mirrors
the module of the same name there and is held against it by the tests in
``tests/test_torch_*.py``.  This package imports ``torch`` and numpy only,
never JAX or anything of the JAX package.

Entry points:

  * :class:`runtime.engine.StereoEngine` — the streaming server, and
    :class:`models.FastStereoNet` — the flagship network: both are built on
    ``cuda:0`` unless the caller passes ``device="cpu"``;
  * :func:`ops.preprocess.nv12_ingest` — side-by-side NV12 -> model input,
    on the device of the frames it is given.

The three Pallas kernels of the JAX package are CUDA kernels here
(``csrc/*.cu``), and so is the int8 convolution that the JAX package leaves
to XLA (``ops/quant.py``); all are built with ``nvcc`` into one shared
library at first use (``ops/kernels/build.py``).  Each has a plain PyTorch
version beside it, which runs for CPU tensors only.
"""

from .config import (
    CameraConfig,
    Config,
    EngineConfig,
    PreprocessConfig,
    StereoNetConfig,
)

__version__ = "0.1.0"
