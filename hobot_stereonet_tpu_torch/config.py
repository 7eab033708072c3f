"""Configuration tree of the port: a copy of ``hobot_stereonet_tpu/config.py``.

The same frozen dataclasses load the same JSON files
(``checkpoints/flagship/config.json``).  Differences from the reference:

  * ``StereoNetConfig.compute_dtype`` is a ``torch.dtype``; JSON keeps its
    name (``"bfloat16"``);
  * ``CameraConfig.depth_from_disparity`` takes tensors.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple

import torch


@dataclass(frozen=True)
class CameraConfig:
    """Stereo rig calibration (ZED 2i constants by default)."""

    focal_px: float = 527.1931762695312
    baseline_mm: float = 119.89382172
    width: int = 1280
    height: int = 720

    @property
    def baseline_m(self) -> float:
        return self.baseline_mm / 1000.0

    def depth_from_disparity(self, disparity_px: torch.Tensor) -> torch.Tensor:
        """Metric depth (m) from disparity (px): ``Z = f*B / max(d, 1e-6) / 1000``
        with B in mm (``hobot_stereonet_tpu/config.py:44-51``)."""
        d = torch.clamp(disparity_px, min=1e-6)
        fb = torch.tensor(self.focal_px * self.baseline_mm, dtype=d.dtype,
                          device=d.device)
        return fb / d / 1000.0


@dataclass(frozen=True)
class StereoNetConfig:
    """Architecture of the stereo network (see the reference's docstrings)."""

    downsample_factor: int = 3
    feature_channels: int = 32
    num_feature_res_blocks: int = 6
    max_disparity: int = 192
    num_aggregation_layers: int = 4
    aggregation_channels: int = 32
    hierarchical_refinement: bool = True
    num_refinement_res_blocks: int = 6
    refinement_channels: int = 32
    refinement_scale_channels: Optional[Tuple[int, ...]] = (32, 16, 12)
    refinement_scale_blocks: Optional[Tuple[int, ...]] = (6, 4, 3)
    upsample_mode: str = "convex"
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    input_channels: int = 3

    @property
    def cost_resolution_divisor(self) -> int:
        return 2 ** self.downsample_factor

    @property
    def num_disparities_coarse(self) -> int:
        """Disparity candidates at cost-volume resolution (192/8 = 24)."""
        return self.max_disparity // self.cost_resolution_divisor


@dataclass(frozen=True)
class PreprocessConfig:
    """Input normalization contract: ``(x - mean) / std`` of each byte."""

    mean: float = 128.0
    std: float = 128.0
    quant_scale: float = 0.0078125
    quant_zero_point: float = 0.5
    quant_min: int = -128
    quant_max: int = 127
    quantize: bool = False
    color_space: str = "rgb"

    def __post_init__(self):
        if self.color_space not in ("rgb", "yuv"):
            raise ValueError(
                f"color_space must be 'rgb' or 'yuv', got {self.color_space!r}"
            )


@dataclass(frozen=True)
class MeshConfig:
    """Logical (data, tile) mesh of ``torch.distributed`` ranks, one a card:
    ``data`` shards the batch of stereo pairs, ``tile`` the image rows with
    a halo exchange (``parallel/``)."""

    data: int = 1
    tile: int = 1

    def __post_init__(self):
        if self.data < 1 or self.tile < 1:
            raise ValueError(f"mesh axes must be >= 1, got data={self.data} tile={self.tile}")

    @property
    def num_devices(self) -> int:
        return self.data * self.tile


@dataclass(frozen=True)
class EngineConfig:
    """Streaming engine: in-flight depth, feed queue, batch buckets."""

    inflight: int = 4
    feed_queue_depth: int = 64
    drop_on_full: bool = True
    max_batch: int = 32
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    stage_timing: bool = False
    fetch_results: bool = True
    nan_guard: bool = True
    device_microbatch: int = 0

    def __post_init__(self):
        buckets = tuple(sorted(set(self.batch_buckets) | {1}))
        object.__setattr__(self, "batch_buckets", buckets)
        if self.max_batch not in buckets:
            raise ValueError(
                f"max_batch={self.max_batch} must be one of batch_buckets={buckets}"
            )


@dataclass(frozen=True)
class SLAMConfig:
    """The SLAM back end's settings (``hobot_stereonet_tpu/config.py``'s)."""

    max_keyframes: int = 256
    max_points_per_keyframe: int = 512
    keyframe_translation_m: float = 0.3
    keyframe_rotation_deg: float = 10.0
    ba_iterations: int = 10
    ba_damping: float = 1e-4
    huber_delta_px: float = 3.0
    # Minimum soft-argmin peak probability (the network's confidence,
    # StereoResult.confidence) for a keypoint's disparity to be
    # triangulated into the map; 0 disables the gate.
    min_confidence: float = 0.0


@dataclass(frozen=True)
class Config:
    camera: CameraConfig = field(default_factory=CameraConfig)
    model: StereoNetConfig = field(default_factory=StereoNetConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    slam: SLAMConfig = field(default_factory=SLAMConfig)

    def __post_init__(self):
        if isinstance(self.mesh, Mapping):          # the old {"data": .., "tile": ..} dicts
            object.__setattr__(self, "mesh", MeshConfig(**self.mesh))

    def to_dict(self) -> dict:
        def enc(obj):
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                return {f.name: enc(getattr(obj, f.name))
                        for f in dataclasses.fields(obj)}
            if isinstance(obj, torch.dtype):
                return str(obj).removeprefix("torch.")
            if isinstance(obj, Mapping):
                return dict(obj)
            return obj

        return enc(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        sub_types = {
            "camera": CameraConfig,
            "model": StereoNetConfig,
            "preprocess": PreprocessConfig,
            "engine": EngineConfig,
            "mesh": MeshConfig,
            "slam": SLAMConfig,
        }
        kwargs = {}
        for name, klass in sub_types.items():
            if name in d:
                sub = dict(d[name])
                dt = sub.get("compute_dtype")
                if name == "model" and isinstance(dt, str):
                    sub["compute_dtype"] = _dtype_from_name(dt)
                for k, v in sub.items():
                    if isinstance(v, list):
                        sub[k] = tuple(v)
                kwargs[name] = klass(**sub)
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _dtype_from_name(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown compute_dtype {name!r}")
    return dt


def resolve_device(device: "str | torch.device | None", who: str) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` unless the caller names
    another.  Raises if CUDA is asked for and not available."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA is not available; pass device='cpu'")
    return dev
