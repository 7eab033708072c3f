"""Carry the JAX package's flax parameters into the port's modules.

A flax parameter path maps one to one onto a ``state_dict`` key, because
the port's submodules carry the flax module names
(``FeatureTower_0/ConvBlock_0/Conv_0/kernel`` ->
``FeatureTower_0.ConvBlock_0.Conv_0.weight``):

  * conv ``kernel`` HWIO -> ``weight`` OIHW, DHWIO -> OIDHW (3-D);
  * GroupNorm ``scale`` -> ``weight``; ``bias`` stays ``bias``.

The trees come as nested mappings of numpy arrays.  ``from_flax_params``
also takes the variables dict ``{"params": ...}`` and a train state, whose
weights sit under ``["params"]["params"]`` beside ``opt_state``.

A tree also travels as an ``.npz`` file, written and read with numpy alone
(:func:`save_flax_npz`, :func:`load_flax_npz`): one array per leaf, keyed by
its flax path (``FeatureTower_0/ConvBlock_0/Conv_0/kernel``).  The writer
is deterministic, so the same tree gives the same bytes.
"""

from __future__ import annotations

import io
import zipfile
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..config import StereoNetConfig


def _expected_state(cfg: StereoNetConfig, model: str) -> Dict[str, Tuple[int, ...]]:
    from ..models import build_model

    net = build_model(model, cfg, device="meta")
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def _unwrap(tree: Mapping) -> Mapping:
    if "opt_state" in tree and "params" in tree:        # train state
        tree = tree["params"]
    while set(tree.keys()) == {"params"}:               # variables dict
        tree = tree["params"]
    return tree


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for name, value in tree.items():
        path = prefix + (str(name),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def flax_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax parameter tree (of any module of the port) onto ``state_dict``
    keys and layouts, without checking it against a model."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(_unwrap(tree)):
        arr = np.array(value, dtype=np.float32)             # a writable copy
        leaf = path[-1]
        if leaf == "kernel":
            if arr.ndim not in (4, 5):
                raise ValueError(f"{'/'.join(path)}: expected a 2D or 3D conv kernel, "
                                 f"got {arr.shape}")
            arr = arr.transpose(arr.ndim - 1, arr.ndim - 2, *range(arr.ndim - 2))
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
        state[".".join(path[:-1] + (leaf,))] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def from_flax_params(tree: Mapping, cfg: StereoNetConfig = StereoNetConfig(),
                     model: str = "fast") -> Dict[str, torch.Tensor]:
    """Flax parameter tree of the network ``model`` (``"fast"``:
    ``FastStereoNet(cfg)``, ``"classic"``: ``StereoNet(cfg)``) -> the
    port's ``state_dict``.

    Raises ``KeyError`` on a missing or an extra parameter and
    ``ValueError`` on a shape that does not match ``cfg``.
    """
    expected = _expected_state(cfg, model)
    state = flax_to_state_dict(tree)
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        raise KeyError(f"flax parameters do not match the {model} network: "
                       f"missing {missing}, extra {extra}")
    for key, shape in expected.items():
        if tuple(state[key].shape) != shape:
            raise ValueError(f"{key}: expected shape {shape}, got {tuple(state[key].shape)}")
    return state


def random_flax_params(cfg: StereoNetConfig = StereoNetConfig(), seed: int = 0,
                       model: str = "fast") -> dict:
    """Seeded random parameters of the network ``model`` (as
    :func:`from_flax_params` names it) in the flax tree's layout and shapes.

    Conv kernels follow flax's default ``lecun_normal`` (normal with std
    ``1/sqrt(fan_in)``, clipped at two std), biases are zero, GroupNorm
    scales one.  Made with numpy, so any machine gives the same weights.
    """
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for key, shape in _expected_state(cfg, model).items():
        *mods, leaf = key.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        if leaf == "bias":
            node["bias"] = np.zeros(shape, np.float32)
        elif len(shape) in (4, 5):                      # conv OI(D)HW -> (D)HWIO
            o, i, *taps = shape
            std = 1.0 / np.sqrt(i * np.prod(taps))
            w = np.clip(rng.standard_normal((*taps, i, o)), -2.0, 2.0) * std
            node["kernel"] = w.astype(np.float32)
        else:                                           # GroupNorm scale
            node["scale"] = np.ones(shape, np.float32)
    return {"params": tree}


# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that the truncated distribution has variance 1 / fan_in (the constant is
# the standard deviation of a unit normal truncated to [-2, 2]).
TRUNCATED_NORMAL_STD = 0.87962566103423978


def init_params(cfg: StereoNetConfig = StereoNetConfig(), model="fast",
                generator: "torch.Generator | None" = None) -> Dict[str, torch.Tensor]:
    """Fresh float32 weights of the network ``model`` (``"fast"``,
    ``"classic"`` or a built network) as a ``state_dict`` on the CPU, drawn
    from ``generator`` in flax's default distributions: conv kernels
    ``lecun_normal`` (a normal truncated at +-2 sigma, sigma =
    ``1/sqrt(fan_in)/0.87962566``, fan_in = Cin x kernel taps), conv biases
    zero, GroupNorm scales one and biases zero.  The JAX package draws the
    same distributions from ``jax.random``; the values differ.
    """
    from ..models import model_name

    name = model if isinstance(model, str) else model_name(model)
    state: Dict[str, torch.Tensor] = {}
    for key, shape in _expected_state(cfg, name).items():
        if key.endswith(".bias"):
            t = torch.zeros(shape)
        elif len(shape) in (4, 5):                      # conv O, I, *taps
            fan_in = int(np.prod(shape[1:]))
            t = torch.empty(shape)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            t *= float(1.0 / np.sqrt(fan_in) / TRUNCATED_NORMAL_STD)
        else:                                           # GroupNorm scale
            t = torch.ones(shape)
        state[key] = t
    return state


def to_flax_params(state: Mapping[str, torch.Tensor]) -> dict:
    """A network's ``state_dict`` -> the flax variables dict ``{"params":
    tree}`` of numpy float32 arrays, the inverse of :func:`flax_to_state_dict`:
    conv ``weight`` OIHW -> ``kernel`` HWIO (OIDHW -> DHWIO), GroupNorm
    ``weight`` -> ``scale``."""
    tree: dict = {}
    for key, value in state.items():
        *mods, leaf = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight" and arr.ndim in (4, 5):
            arr, leaf = arr.transpose(*range(2, arr.ndim), 1, 0), "kernel"
        elif leaf == "weight":
            leaf = "scale"
        elif leaf != "bias":
            raise KeyError(f"unexpected parameter {key}")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


# A fixed member timestamp, so that the same arrays give the same file.
_NPZ_DATE = (1980, 1, 1, 0, 0, 0)


def write_npz(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    """Write ``{key: array}`` as a compressed ``.npz`` that ``np.load``
    reads, byte for byte the same for the same arrays (sorted keys, fixed
    timestamps)."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        for key in sorted(arrays):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arrays[key]), allow_pickle=False)
            info = zipfile.ZipInfo(key + ".npy", date_time=_NPZ_DATE)
            info.compress_type = zipfile.ZIP_DEFLATED
            info.external_attr = 0o644 << 16
            zf.writestr(info, buf.getvalue())


def save_flax_npz(tree: Mapping, path: str) -> None:
    """Write a flax parameter tree (or variables dict, or train state) as
    ``.npz``, one float32 array per leaf keyed by its flax path."""
    write_npz(path, {"/".join(p): np.asarray(v, dtype=np.float32)
                     for p, v in _flatten(_unwrap(tree))})


def load_flax_npz(path: str) -> dict:
    """Read an ``.npz`` of :func:`save_flax_npz` back into the variables
    dict ``{"params": nested tree}``."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            *mods, leaf = key.split("/")
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = data[key]
    return {"params": tree}
