from typing import Union

import torch.nn as nn

from .fast_stereonet import CorrelationAggregation2D, FastStereoNet
from .stereonet import CostAggregation, FeatureTower, RefinementNet, StereoNet

# The networks by the name the JAX package's CLI gives them (``--model``).
MODELS = {"fast": FastStereoNet, "classic": StereoNet}


def build_model(model: Union[str, nn.Module], cfg, device=None) -> nn.Module:
    """``"fast"`` or ``"classic"`` -> that network built from ``cfg`` on
    ``device``; a built module is returned as it is."""
    if isinstance(model, nn.Module):
        return model
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; expected one of {sorted(MODELS)}")
    return MODELS[model](cfg, device=device)


def model_name(module: nn.Module) -> str:
    """The name (:data:`MODELS`) of a built network."""
    return next(name for name, cls in MODELS.items() if isinstance(module, cls))
