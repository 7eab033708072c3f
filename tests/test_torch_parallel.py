"""The port's scale-out layer (``hobot_stereonet_tpu_torch/parallel/``) on the CPU.

Ranks are processes with gloo (``tests/torch_mesh_workers.py``: a
``FileStore`` under the test's temporary directory, one thread a rank,
timeouts on every process and on the group's set-up); the JAX references
run in this process on the JAX package's 8 virtual devices.  Also here: the
bilinear resize at any factor against ``jax.image.resize`` (ROADMAP A6), the
GroupNorm's entries split at its statistics against the fused one, and
``bench-scaling``.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hobot_stereonet_tpu.config import MeshConfig as JMeshConfig
from hobot_stereonet_tpu.ops import upsample as jup
from hobot_stereonet_tpu.parallel import halo as jhalo
from hobot_stereonet_tpu.parallel import mesh as jmesh
from hobot_stereonet_tpu_torch.config import Config, MeshConfig
from hobot_stereonet_tpu_torch.ops import upsample as tup
from hobot_stereonet_tpu_torch.ops.kernels import build
from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg
from hobot_stereonet_tpu_torch.parallel import distributed, tiling
from hobot_stereonet_tpu_torch.parallel.mesh import auto_mesh_config, make_mesh
from tests.torch_mesh_workers import spawn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The collectives scenario on 4 ranks (each rank's results)."""
    return spawn("collectives", 4, tmp_path_factory.mktemp("collectives"))


def test_mesh_config_reads_the_old_dicts():
    cfg = Config.from_dict({"mesh": {"data": 2, "tile": 4}})
    assert cfg.mesh == MeshConfig(data=2, tile=4) and cfg.mesh.num_devices == 8
    assert Config().mesh == MeshConfig() and Config().to_dict()["mesh"] == {"data": 1, "tile": 1}
    assert Config.from_dict(Config(mesh=MeshConfig(2, 1)).to_dict()).mesh == MeshConfig(2, 1)
    with pytest.raises(ValueError):
        MeshConfig(data=0)


def test_make_mesh_shapes(four):
    for r, res in enumerate(four):
        assert res["shapes"][(2, 2)] == ((2, 2), ("data", "tile"), (r // 2, r % 2))
        assert res["shapes"][(4, 1)] == ((4, 1), ("data", "tile"), (r, 0))
        assert res["shapes"][(1, 4)] == ((1, 4), ("data", "tile"), (0, r))
        assert res["too_big"] == "mesh 8x1 needs 8 devices, have 4"
        assert res["auto"] == MeshConfig(data=4, tile=1)
        assert res["info"]["process_count"] == 4 and res["info"]["process_index"] == r
        assert res["info"]["multi_process"] and res["info"]["backend"] == "gloo"


def test_shard_batch_and_replicate(four):
    x = torch.arange(4 * 16 * 8 * 3, dtype=torch.float32).reshape(4, 16, 8, 3)
    for r, res in enumerate(four):
        d, t = divmod(r, 2)
        assert torch.equal(res["shard"], x[2 * d:2 * d + 2, 8 * t:8 * t + 8])
        assert torch.equal(res["shard_rows8"], x[2 * d:2 * d + 2, 4 * t:4 * t + 4])
        assert torch.equal(res["replicated"], torch.zeros(4, 3, 3, 3))     # rank 0's


def test_halo_exchange_matches_jax(eight_devices, four):
    """The neighbours' rows, zeros at the image's edge: the same rows as the
    JAX package's ``exchange_row_halos`` on a 4-tile mesh."""
    from jax import shard_map

    m = jmesh.make_mesh(JMeshConfig(data=1, tile=4))
    x = jnp.arange(16, dtype=jnp.float32).reshape(1, 16, 1).repeat(4, axis=2)
    want = np.asarray(shard_map(lambda p: jhalo.exchange_row_halos(p, halo=1), mesh=m,
                                in_specs=(P(None, "tile", None),),
                                out_specs=P(None, "tile", None))(x))
    for r, res in enumerate(four):
        np.testing.assert_array_equal(res["halo1"].numpy(), want[:, 6 * r:6 * r + 6])
    assert four[0]["halo1"][0, :, 0].tolist() == [0, 0, 1, 2, 3, 4]
    assert four[3]["halo1"][0, :, 0].tolist() == [11, 12, 13, 14, 15, 0]


def test_halo_reach_wider_than_a_neighbour(four):
    """A halo of 6 rows over tiles of 4 takes rows from two ranks each way:
    the zero-padded (or edge-repeated) image's rows."""
    g = np.arange(16, dtype=np.float32)
    zero = np.pad(g, 6)
    edge = np.pad(g, 6, mode="edge")
    for r, res in enumerate(four):
        np.testing.assert_array_equal(res["halo6"][0, :, 0].numpy(), zero[4 * r:4 * r + 16])
        np.testing.assert_array_equal(res["halo6_edge"][0, :, 0].numpy(), edge[4 * r:4 * r + 16])


def test_halo_uneven_shards(four):
    g = np.pad(np.arange(7, dtype=np.float32), 2)
    starts = [0, 3, 4, 5]
    counts = [3, 1, 1, 2]
    for r, res in enumerate(four):
        want = g[starts[r]:starts[r] + counts[r] + 4]
        np.testing.assert_array_equal(res["uneven"][0, :, 0].numpy(), want)


def test_halo_map_matches_padded_stencil(four):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 8)))
    up = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
    down = torch.nn.functional.pad(x, (0, 0, 0, 1))[:, 1:]
    want = (up + x + down) / 3.0
    got = torch.cat([res["halo_map"] for res in four], 1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_initialize_single_process(monkeypatch, tmp_path):
    """One process and no address forms no group (as the JAX package's);
    with an address it forms a one-rank group, over which a (1, 1) mesh is
    built."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    info = distributed.initialize(device="cpu")
    assert info["multi_process"] is False and info["process_count"] == 1
    assert info["global_devices"] == 1 and not torch.distributed.is_initialized()
    assert auto_mesh_config() == MeshConfig(1, 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(MeshConfig(data=2))
    info = distributed.initialize(f"file://{tmp_path / 'store'}", device="cpu", timeout_s=30)
    try:
        assert info["multi_process"] and info["backend"] == "gloo"
        mesh = distributed.global_mesh(tile=1)
        assert tuple(mesh.shape) == (1, 1) and info["global_devices"] == 1
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            distributed.initialize()


def test_two_process_all_reduce(tmp_path):
    """tests/test_multiprocess.py's psum: two ranks' rows (1s and 2s) sum to
    12 on both, over the data group of a (2, 1) global mesh."""
    outs = spawn("allreduce", 2, tmp_path)
    for r, o in enumerate(outs):
        assert o["total"] == 12.0 and o["mesh"] == (2, 1)
        assert o["info"]["process_index"] == r and o["info"]["global_devices"] == 2


@pytest.mark.parametrize("kernel,stride,dilation", [(5, 2, 1), (3, 1, 1), (3, 1, 8), (3, 1, 4),
                                                    (3, 2, 1)])
@pytest.mark.parametrize("height,tiles,scale", [(40, 4, 1), (40, 2, 2), (720, 4, 1), (64, 3, 4)])
def test_conv_rows_give_the_whole_images_rows(kernel, stride, dilation, height, tiles, scale):
    """Every tile's extended "SAME" conv, cropped, equals the whole image's
    conv at its rows (a 1-D conv of distinct values along the rows)."""
    rows = height // scale
    g = torch.arange(1.0, rows + 1, dtype=torch.float64)
    w = torch.arange(1.0, kernel + 1, dtype=torch.float64)

    def same(x):
        lo, hi = tiling.same_pads(len(x), kernel, stride, dilation)
        xp = torch.nn.functional.pad(x, (lo, hi))
        n = -(-len(x) // stride)
        return torch.stack([sum(w[k] * xp[o * stride + k * dilation] for k in range(kernel))
                            for o in range(n)])

    whole = same(g)
    for t in range(tiles):
        geo = tiling.RowTiles(height, 8, None, index=t, size=tiles)
        starts, counts, total = geo.layout(geo.coarse[t] * 8 // scale)
        assert total == rows
        top, bottom, first = geo.conv_rows(counts[t], kernel, stride, dilation)
        a, b = starts[t] - top, starts[t] + counts[t] + bottom
        ext = torch.stack([g[i] if 0 <= i < rows else torch.tensor(0.0, dtype=g.dtype)
                           for i in range(a, b)])
        got = same(ext)[first:first + counts[t] // stride]
        assert torch.equal(got, whole[starts[t] // stride:(starts[t] + counts[t]) // stride])


def test_row_split_refuses_more_tiles_than_coarse_rows():
    assert tiling.split_rows(90, 4) == [23, 23, 22, 22]           # 720p at 1/8
    with pytest.raises(ValueError, match="tile count"):
        tiling.split_rows(5, 6)
    with pytest.raises(ValueError, match="tile count"):
        tiling.RowTiles(40, 8, None, index=0, size=6)


@pytest.mark.parametrize("hw,out", [((5, 7), (15, 21)), ((6, 8), (9, 20)), ((10, 12), (7, 5)),
                                    ((9, 11), (31, 13)), ((16, 16), (5, 3)), ((4, 6), (4, 17)),
                                    ((8, 8), (24, 24))])
def test_upsample_bilinear_at_any_factor_matches_jax_resize(hw, out):
    """2x stencils where both sides double, then ``jax.image.resize``'s
    bilinear (antialiased when shrinking, taps outside the input dropped):
    within float32 rounding (1e-6) at odd factors up and down."""
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jup.upsample_bilinear(jnp.asarray(x), *out))
    got = tup.upsample_bilinear(torch.from_numpy(x), *out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _gn_case(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    fmt = torch.channels_last if len(shape) == 4 else torch.channels_last_3d

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype).contiguous(memory_format=fmt)

    c = shape[1]
    return (t(rng.standard_normal(shape) * 3 + 1), t(rng.standard_normal(shape)),
            *(torch.from_numpy(rng.standard_normal(c).astype(np.float32)) for _ in range(3)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 12, 20), (2, 16, 4, 6, 10)])
@pytest.mark.parametrize("form", ["plain", "fused"])
def test_split_group_norm_plain_entries(shape, dtype, form):
    """``group_norm_stats``, then ``statistics_from_sums``, then
    ``group_norm_apply`` over the whole tensor: ``group_norm_fused``'s bits.
    Over two row halves, their sums combined: the statistics within 8
    sqrt(n) float32 ulps of the scale (the values' RMS for the mean, rstd
    for rstd; n elements a group) of the whole's, each a float32 chain off
    the exact value by about sqrt(n) ulps, and within 1e-5 (relative) at
    these sizes; the output
    within 1e-5 of (|out| + 1) in float32, one bf16 step in bf16 (measured:
    5e-7 and 1e-6; bf16 equal)."""
    x, skip, w, b, cb = _gn_case(shape, dtype)
    kw = dict(conv_bias=cb, skip=skip, activate=True) if form == "fused" else {}
    groups, eps = 8, 1e-6
    want, _, wmean, wrstd = kg.group_norm_fused_plain(x, groups, w, b, eps, **kw)
    count = shape[1] // groups * int(np.prod(shape[2:]))
    mean, rstd = kg.statistics_from_sums(kg.group_norm_stats(x, groups, kw.get("conv_bias")),
                                         count, eps)
    assert torch.equal(mean, wmean) and torch.equal(rstd, wrstd)
    assert torch.equal(kg.group_norm_apply(x, w, b, mean, rstd, **kw), want)
    assert sum(build.launch_counts.values()) == 0          # the plain versions on the CPU

    dim = len(shape) - 2                                    # rows: H
    n = shape[dim] // 2
    fmt = torch.channels_last if len(shape) == 4 else torch.channels_last_3d

    def half(t, i):
        return t.narrow(dim, 0, n) if i == 0 else t.narrow(dim, n, shape[dim] - n)

    parts = [kg.group_norm_stats(half(x, i).contiguous(memory_format=fmt), groups,
                                 kw.get("conv_bias")) for i in (0, 1)]
    mean2, rstd2 = kg.statistics_from_sums(kg.combine_sums(parts), count, eps)
    assert torch.allclose(mean2, wmean, rtol=1e-5, atol=1e-5 * float(wmean.abs().max()))
    assert torch.allclose(rstd2, wrstd, rtol=1e-5, atol=0)
    a = x if "conv_bias" not in kw else x + cb.to(dtype).view((1, -1) + (1,) * (x.dim() - 2))
    a = a.double().reshape(shape[0], groups, -1)
    ulps = 8 * count ** 0.5 * 2.0 ** -24
    for got, chain, scale in ((mean2, wmean, (a ** 2).mean(2).sqrt()),
                              (rstd2, wrstd, wrstd.double())):
        assert bool(((got.double() - chain.double()).abs() <= ulps * scale).all())
    out = torch.cat([kg.group_norm_apply(
        half(x, i).contiguous(memory_format=fmt), w, b, mean2, rstd2,
        **({**kw, "skip": half(skip, i).contiguous(memory_format=fmt)} if kw else {}))
        for i in (0, 1)], dim)
    err = (out.float() - want.float()).abs()
    if dtype == torch.float32:
        assert bool((err <= 1e-5 * (want.abs() + 1)).all()), float(err.max())
    else:
        assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-30).all()), float(err.max())
    assert torch.equal(kg.combine_sums(parts[:1]), parts[0])


def test_bench_scaling_on_the_cpu():
    """``bench-scaling --device cpu`` spawns gloo ranks and prints the JAX
    package's keys."""
    proc = subprocess.run(
        [sys.executable, "-m", "hobot_stereonet_tpu_torch.cli", "bench-scaling", "--devices",
         "2", "--height", "32", "--width", "64", "--iters", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(line) == {"backend", "fps_1dev", "fps_2dev", "scaling_efficiency", "note"}
    assert line["backend"] == "gloo (cpu)" and line["fps_1dev"] > 0 and line["fps_2dev"] > 0
    # The line rounds each figure from the unrounded ones.
    assert abs(line["scaling_efficiency"] - line["fps_2dev"] / (2 * line["fps_1dev"])) < 2e-3
