"""``--debug-nans``: the port's analog of ``jax_debug_nans``.

:func:`raise_on_nonfinite` hooks every module of a network so that a
forward raises ``FloatingPointError`` at the first module whose output holds
a NaN or an Inf, naming it (a forward hook runs when its module returns, so
the innermost producer reports first).  Each hook reads its output's
finiteness back to the host, which serializes the device: a debug mode,
not a serving one.  Training uses ``torch.autograd.set_detect_anomaly``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def raise_on_nonfinite(model: nn.Module) -> List:
    """Hook every module of ``model``; returns the hooks' handles."""
    def hook(name):
        def check(_module, _args, out):
            for t in _tensors(out):
                if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                    raise FloatingPointError(f"non-finite output of {name or 'the network'} "
                                             f"{type(_module).__name__} {tuple(t.shape)}")
        return check

    return [m.register_forward_hook(hook(name)) for name, m in model.named_modules()]
