"""Checkpoints of the weights and of the training state.

Counterpart of ``hobot_stereonet_tpu/runtime/checkpoint.py``, which writes
orbax directories.  The port writes the weights as the flax-layout ``.npz``
of ``reference/*_params.npz`` (``weights.save_flax_npz``, read back with
``weights.load_flax_npz``), so ``StereoEngine`` serves what the port
trained and the JAX package loads it with numpy.  The optimizer's state and
the step go beside them in ``opt_state.pt`` (``torch.save``).

A checkpoint path is a directory holding ``params.npz`` (and, for a
training state, ``opt_state.pt``) or, for the weights alone, an ``.npz``
file.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping, Optional

import torch
import torch.nn as nn

from .weights import _flatten, _unwrap, load_flax_npz, save_flax_npz, to_flax_params

PARAMS_FILE = "params.npz"
OPT_STATE_FILE = "opt_state.pt"


def _params_file(path: str) -> Path:
    p = Path(path)
    return p if p.suffix == ".npz" else p / PARAMS_FILE


def _flax_tree(params: Any) -> Mapping:
    """A network, a ``state_dict`` (or any mapping of names to tensors) or a
    flax tree -> the flax variables dict."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    if all(isinstance(v, torch.Tensor) for v in params.values()):
        return to_flax_params(params)
    return params


def save_params(path: str, params: Any) -> None:
    """Write ``params`` (a network, its ``state_dict`` or a flax tree) as
    the flax-layout ``.npz``: ``path`` itself if it ends in ``.npz``, else
    ``path/params.npz`` (the directory is created)."""
    out = _params_file(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_flax_npz(_flax_tree(params), str(out))


def load_params(path: str, like: Optional[Any] = None) -> dict:
    """The flax variables dict ``{"params": tree}`` of a checkpoint written
    by :func:`save_params` or :func:`save_train_state`.  ``like`` (a network,
    a ``state_dict`` or a flax tree) validates the restored structure:
    ``ValueError`` if the parameter paths or shapes differ."""
    restored = load_flax_npz(str(_params_file(path)))
    if like is not None:
        def shapes(tree):
            return {"/".join(k): tuple(v.shape) for k, v in _flatten(_unwrap(tree))}

        want, got = shapes(_flax_tree(like)), shapes(restored)
        if want != got:
            missing = sorted(set(want) - set(got))
            extra = sorted(set(got) - set(want))
            wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])
            raise ValueError(f"checkpoint structure mismatch: missing {missing}, extra {extra}, "
                             f"other shapes {wrong}")
    return restored


def save_train_state(path: str, state) -> None:
    """Write a ``TrainState`` into the directory ``path``: the weights as
    ``params.npz``, the optimizer state and the step as ``opt_state.pt``."""
    os.makedirs(path, exist_ok=True)
    save_params(path, state.params)
    opt = state.opt_state
    torch.save({"step": state.step, "count": opt["count"],
                "mu": {k: v.detach().cpu() for k, v in opt["mu"].items()},
                "nu": {k: v.detach().cpu() for k, v in opt["nu"].items()}},
               os.path.join(path, OPT_STATE_FILE))


@torch.no_grad()
def load_train_state(path: str, like):
    """Restore a ``TrainState`` written by :func:`save_train_state` into
    ``like`` (one of the same network and optimizer): its parameters are
    overwritten in place; returns the restored state."""
    from .training import TrainState
    from .weights import flax_to_state_dict

    state = flax_to_state_dict(load_params(path, like=like.params))
    for k, p in like.params.items():
        p.copy_(state[k])
    saved = torch.load(os.path.join(path, OPT_STATE_FILE), map_location="cpu")
    opt = {"count": int(saved["count"]),
           "mu": {k: saved["mu"][k].to(p) for k, p in like.params.items()},
           "nu": {k: saved["nu"][k].to(p) for k, p in like.params.items()}}
    return TrainState(like.params, opt, int(saved["step"]))
