"""Indexable datasets for the evaluation.

Counterpart of ``SyntheticStereoDataset`` in
``hobot_stereonet_tpu/data/loader.py`` and of ``StereoSample`` in
``hobot_stereonet_tpu/data/sceneflow.py``.  Numpy only: scenes are made on
the host, one per index, from the procedural generator (``synthetic.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class StereoSample:
    left: np.ndarray       # [H, W, 3] uint8 RGB
    right: np.ndarray
    disparity: np.ndarray  # [H, W] float32, left view
    name: str = ""


class SyntheticStereoDataset:
    """Procedural generator -> indexable dataset, deterministic per index
    (scene ``i`` comes from ``default_rng(seed * 1_000_003 + i)``), so
    evaluation sets are reproducible.  Up to ``cache_items`` rendered scenes
    are kept.
    """

    def __init__(self, size: int = 1000, seed: int = 0,
                 cache_items: int = 512, **cfg_kwargs):
        from .synthetic import SyntheticConfig, generate_pair

        self._gen = generate_pair
        self._cfg = SyntheticConfig(**cfg_kwargs)
        self._seed = seed
        self._size = size
        self._cache_items = cache_items
        self._cache: dict = {}

    def __len__(self) -> int:
        return self._size

    def __getitem__(self, i: int) -> StereoSample:
        hit = self._cache.get(i)
        if hit is not None:
            return hit
        rng = np.random.default_rng(self._seed * 1_000_003 + i)
        l, r, d = self._gen(rng, self._cfg)
        s = StereoSample(l, r, d, name=f"synthetic/{i}")
        if len(self._cache) < self._cache_items:
            self._cache[i] = s
        return s
