"""Carrying the JAX package's checkpoints into the port (runtime/weights.py)."""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu.runtime.checkpoint import load_params
from hobot_stereonet_tpu_torch.config import Config, StereoNetConfig
from hobot_stereonet_tpu_torch.models import FastStereoNet, StereoNet
from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params, random_flax_params

torch.set_num_threads(1)

# Architectures of the fast-model checkpoints (scripts/frontier.py).
FAST = {
    "fast_synth_v1": {},
    "flagship": {},
    "frontier_A_base": {},
    "frontier_A_ft": {},
    "frontier_B_wider": dict(feature_channels=48, aggregation_channels=96,
                             num_aggregation_layers=6),
    "frontier_C_big": dict(feature_channels=64, aggregation_channels=128,
                           num_aggregation_layers=8, num_feature_res_blocks=8),
    "matrix_A_base_layered": {},
    "yuv_ft": {},
}
# The CLASSIC StereoNet's checkpoints (scripts/frontier.py, "CLASSIC").
CLASSIC = ("frontier_CLASSIC", "matrix_CLASSIC_layered")


def _load(name):
    path = os.path.join("checkpoints", name)
    if os.path.isdir(os.path.join(path, "params")):
        path = os.path.join(path, "params")
    return jax.tree_util.tree_map(np.asarray, load_params(path))


def test_every_fast_checkpoint_is_listed():
    assert set(os.listdir("checkpoints")) == set(FAST) | set(CLASSIC)


@pytest.mark.parametrize("name", sorted(FAST))
def test_checkpoint_carries_across(name):
    cfg = StereoNetConfig(**FAST[name])
    tree = _load(name)
    state = from_flax_params(tree, cfg)
    flat = jax.tree_util.tree_leaves(tree)
    assert len(state) == len(flat)
    model = FastStereoNet(cfg, device="cpu")
    model.load_state_dict(state, strict=True)
    conv = tree["params"]["FeatureTower_0"]["ConvBlock_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        model.FeatureTower_0.ConvBlock_0.Conv_0.weight.detach().numpy(),
        np.transpose(conv, (3, 2, 0, 1)))
    gn = tree["params"]["FeatureTower_0"]["ConvBlock_0"]["GroupNorm_0"]["scale"]
    np.testing.assert_array_equal(
        model.FeatureTower_0.ConvBlock_0.GroupNorm_0.weight.detach().numpy(), gn)


@pytest.mark.parametrize("name", CLASSIC)
def test_classic_checkpoint_carries_across(name):
    """Both CLASSIC checkpoints convert with exact shapes into the port's
    StereoNet; a 3-D kernel DHWIO -> OIDHW, a dilated one HWIO -> OIHW."""
    tree = _load(name)
    state = from_flax_params(tree, StereoNetConfig(), model="classic")
    assert len(state) == len(jax.tree_util.tree_leaves(tree)) == 202
    model = StereoNet(device="cpu")
    model.load_state_dict(state, strict=True)
    p = tree["params"]
    conv3d = p["CostAggregation_0"]["ConvBlock3D_0"]["Conv_0"]["kernel"]
    assert conv3d.shape == (3, 3, 3, 32, 32)
    np.testing.assert_array_equal(
        model.CostAggregation_0.ConvBlock3D_0.Conv_0.weight.detach().numpy(),
        np.transpose(conv3d, (4, 3, 0, 1, 2)))
    dilated = model.RefinementNet_2.ResBlock2D_1.Conv_0
    assert dilated.dilation == (2, 2) and dilated.weight.shape == (12, 12, 3, 3)
    np.testing.assert_array_equal(
        dilated.weight.detach().numpy(),
        np.transpose(p["RefinementNet_2"]["ResBlock2D_1"]["Conv_0"]["kernel"], (3, 2, 0, 1)))
    with pytest.raises(KeyError, match="the fast network"):
        from_flax_params(tree)


def test_random_classic_weights_match_the_jax_init_tree():
    from hobot_stereonet_tpu.models.stereonet import init_params

    want = jax.tree_util.tree_map(np.shape, init_params(jax.random.PRNGKey(0)))
    got = random_flax_params(seed=3, model="classic")
    assert jax.tree_util.tree_map(np.shape, got) == want
    StereoNet(device="cpu").load_state_dict(from_flax_params(got, model="classic"))


def test_train_state_and_bare_trees():
    tree = _load("flagship")
    want = from_flax_params(tree)
    train_state = {"params": tree, "opt_state": {"mu": 0}, "step": np.int32(3)}
    for t in (train_state, tree["params"]):
        got = from_flax_params(t)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_missing_extra_and_misshapen_parameters_fail_loudly():
    tree = _load("flagship")
    missing = copy.deepcopy(tree)
    del missing["params"]["upsample_mask"]["bias"]
    with pytest.raises(KeyError, match="upsample_mask.bias"):
        from_flax_params(missing)
    extra = copy.deepcopy(tree)
    extra["params"]["FeatureTower_0"]["ResBlock2D_6"] = extra["params"]["FeatureTower_0"]["ResBlock2D_5"]
    with pytest.raises(KeyError, match="ResBlock2D_6"):
        from_flax_params(extra)
    with pytest.raises(ValueError, match="shape"):
        from_flax_params(_load("frontier_B_wider"),
                         StereoNetConfig(num_aggregation_layers=6))
    odd = copy.deepcopy(tree)
    odd["params"]["upsample_mask"]["gamma"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="gamma"):
        from_flax_params(odd)


def test_random_weights_are_seeded_and_flax_shaped():
    a, b = random_flax_params(seed=0), random_flax_params(seed=0)
    c = random_flax_params(seed=1)
    flagship = _load("flagship")
    shapes = jax.tree_util.tree_map(np.shape, flagship)
    assert jax.tree_util.tree_map(np.shape, a) == shapes
    la, lb, lc = (jax.tree_util.tree_leaves(t) for t in (a, b, c))
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    assert not all(np.array_equal(x, y) for x, y in zip(la, lc))
    FastStereoNet(device="cpu").load_state_dict(from_flax_params(a))


def test_flagship_config_loads():
    cfg = Config.from_json("checkpoints/flagship/config.json")
    assert cfg.model.compute_dtype == torch.bfloat16
    assert cfg.model.num_disparities_coarse == 24
    assert cfg.preprocess.color_space == "yuv"
    assert cfg.engine.batch_buckets == (1, 2, 4, 8, 16, 32) and cfg.engine.inflight == 4
    assert (cfg.camera.width, cfg.camera.height) == (1280, 720)
    again = Config.from_dict(cfg.to_dict())
    assert again == cfg
    d = torch.tensor([0.0, 1.0, 100.0])
    z = cfg.camera.depth_from_disparity(d)
    f_b = cfg.camera.focal_px * cfg.camera.baseline_mm
    np.testing.assert_allclose(z.numpy(), [f_b / 1e-6 / 1000, f_b / 1000, f_b / 100 / 1000],
                               rtol=1e-6)
