"""The port's readers, writers, host ring and display against the JAX
package's, on the CPU, on fixtures built in the test (no dataset needed):
``data/bintensor.py``, ``data/sceneflow.py``, ``data/kitti.py``,
``data/loader.py::LayeredSceneDataset``, ``data/stream.py``
(``read_list_file``, ``ImageListStreamSource``, ``ThreadedCaptureSource``),
``runtime/hostio.py``, ``viz/colormap.py`` and ``viz/server.py``.  Each
equals its counterpart exactly (the same numpy operations).
"""

from __future__ import annotations

import json
import os
import subprocess
import time
import urllib.request

import numpy as np
import pytest
from PIL import Image

from hobot_stereonet_tpu.data import bintensor as jbin
from hobot_stereonet_tpu.data import kitti as jkitti
from hobot_stereonet_tpu.data import sceneflow as jsf
from hobot_stereonet_tpu.data import stream as jstream
from hobot_stereonet_tpu.data.loader import LayeredSceneDataset as JLayered
from hobot_stereonet_tpu.viz import colormap as jcm
from hobot_stereonet_tpu_torch.data import bintensor as tbin
from hobot_stereonet_tpu_torch.data import kitti as tkitti
from hobot_stereonet_tpu_torch.data import sceneflow as tsf
from hobot_stereonet_tpu_torch.data import stream as tstream
from hobot_stereonet_tpu_torch.data.loader import LayeredSceneDataset
from hobot_stereonet_tpu_torch.runtime import hostio
from hobot_stereonet_tpu_torch.viz import colormap as tcm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _save(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _same_sample(a, b):
    np.testing.assert_array_equal(a.left, b.left)
    np.testing.assert_array_equal(a.right, b.right)
    np.testing.assert_array_equal(a.disparity, b.disparity)
    assert a.name == b.name


# ---------------------------------------------------------------------------
# bintensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_input_tensor_round_trip_equals_jax(tmp_path, rng, layout, dtype):
    """A tensor written by either package reads back the same through
    either; int8 dumps quantize and dequantize with the reference's contract."""
    from hobot_stereonet_tpu.config import PreprocessConfig as JPre
    from hobot_stereonet_tpu_torch.config import PreprocessConfig

    x = rng.uniform(-1, 1, (1, 6, 10, 6)).astype(np.float32)
    tbin.save_input_tensor(str(tmp_path / "t.raw"), x, dtype=dtype, layout=layout)
    jbin.save_input_tensor(str(tmp_path / "j.raw"), x, dtype=dtype, layout=layout)
    assert (tmp_path / "t.raw").read_bytes() == (tmp_path / "j.raw").read_bytes()
    got = tbin.load_input_tensor(str(tmp_path / "j.raw"), 6, 10, layout=layout,
                                 cfg=PreprocessConfig())
    want = jbin.load_input_tensor(str(tmp_path / "t.raw"), 6, 10, layout=layout, cfg=JPre())
    assert got.shape == (1, 6, 10, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if dtype == "float32":
        np.testing.assert_array_equal(got, x)
    with pytest.raises(ValueError, match="bytes"):
        tbin.load_input_tensor(str(tmp_path / "t.raw"), 6, 12)


def test_bin_dir_round_trip_equals_jax(tmp_path, rng):
    """``save_bin_dir`` writes what the JAX package writes; ``load_bin_dir``
    (which ``runtime.golden.load_dump`` reads directories with) restores
    shapes and dtypes, and reads a directory without ``meta.json`` flat."""
    from hobot_stereonet_tpu_torch.runtime.golden import load_dump

    tensors = {"a/b": rng.standard_normal((2, 3)).astype(np.float32),
               "q": rng.integers(-128, 128, (5,), dtype=np.int8)}
    tbin.save_bin_dir(str(tmp_path / "t"), tensors)
    jbin.save_bin_dir(str(tmp_path / "j"), tensors)
    for name in ("a__b.bin", "q.bin", "meta.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    got = load_dump(str(tmp_path / "t"))
    want = jbin.load_bin_dir(str(tmp_path / "t"))
    assert sorted(got) == sorted(want) == ["a/b", "q"]
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    os.remove(tmp_path / "t" / "meta.json")
    flat = tbin.load_bin_dir(str(tmp_path / "t"))
    np.testing.assert_array_equal(flat["a/b"], tensors["a/b"].ravel())
    np.testing.assert_array_equal(flat["q"], tensors["q"].view(np.uint8))


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------

def test_pfm_and_sceneflow_equal_jax(tmp_path, rng):
    root = str(tmp_path / "sf")
    for i in range(2):
        img = rng.integers(0, 255, (16, 24, 3), dtype=np.uint8)
        disp = -rng.uniform(1, 40, (16, 24)).astype(np.float32)      # stored negative: abs
        scene = f"frames_cleanpass/TRAIN/A/000{i}"
        _save(f"{root}/{scene}/left/0006.png", img)
        _save(f"{root}/{scene}/right/0006.png", img[:, ::-1].copy())
        os.makedirs(f"{root}/disparity/TRAIN/A/000{i}/left", exist_ok=True)
        tsf.write_pfm(f"{root}/disparity/TRAIN/A/000{i}/left/0006.pfm", disp)
    color = rng.standard_normal((5, 7, 3)).astype(np.float32)
    tsf.write_pfm(str(tmp_path / "c.pfm"), color)
    jsf.write_pfm(str(tmp_path / "cj.pfm"), color)
    assert (tmp_path / "c.pfm").read_bytes() == (tmp_path / "cj.pfm").read_bytes()
    np.testing.assert_array_equal(tsf.read_pfm(str(tmp_path / "c.pfm")), color)
    got, want = tsf.SceneFlowDataset(root), jsf.SceneFlowDataset(root)
    assert got.pairs == want.pairs and len(got) == 2
    for i in range(2):
        _same_sample(got[i], want[i])
        assert (got[i].disparity > 0).all()
    with pytest.raises(FileNotFoundError):
        tsf.SceneFlowDataset(str(tmp_path / "nope"))


def test_kitti_equals_jax(tmp_path, rng):
    root = str(tmp_path / "kitti")
    img = rng.integers(0, 255, (12, 20, 3), dtype=np.uint8)
    raw = (rng.uniform(1, 60, (12, 20)) * 256).astype(np.uint16)
    raw[0, :5] = 0
    for i in range(2):
        _save(f"{root}/training/image_2/00000{i}_10.png", img)
        _save(f"{root}/training/image_3/00000{i}_10.png", img)
    os.makedirs(f"{root}/training/disp_occ_0", exist_ok=True)
    Image.fromarray(raw).save(f"{root}/training/disp_occ_0/000000_10.png")   # one without GT
    d, valid = tkitti.read_kitti_disparity(f"{root}/training/disp_occ_0/000000_10.png")
    dj, vj = jkitti.read_kitti_disparity(f"{root}/training/disp_occ_0/000000_10.png")
    np.testing.assert_array_equal(d, dj)
    np.testing.assert_array_equal(valid, vj)
    got, want = tkitti.Kitti2015Dataset(root), jkitti.Kitti2015Dataset(root)
    assert len(got) == len(want) == 2
    for i in range(2):
        _same_sample(got[i], want[i])
    assert not got[1].disparity.any()
    with pytest.raises(FileNotFoundError):
        tkitti.Kitti2015Dataset(str(tmp_path / "nope"))


@pytest.mark.parametrize("hard", [True, False])
def test_layered_dataset_equals_jax(hard):
    got = LayeredSceneDataset(size=3, seed=5, height=48, width=96, hard=hard)
    want = JLayered(size=3, seed=5, height=48, width=96, hard=hard)
    assert len(got) == 3
    for i in (0, 2):
        _same_sample(got[i], want[i])
        assert got[i] is got[i]                       # cached


# ---------------------------------------------------------------------------
# Stream sources and the host ring
# ---------------------------------------------------------------------------

def test_image_lists_equal_jax(tmp_path, rng):
    paths = []
    for i in range(3):
        p = tmp_path / "img" / f"{i}.png"
        _save(str(p), rng.integers(0, 255, (8, 16, 3), dtype=np.uint8))
        paths.append(p)
    lst = tmp_path / "img" / "left.list"
    lst.write_text(f"# comment\n{paths[0]}\n\n1.png\n{paths[2]}\n")
    got, want = tstream.read_list_file(str(lst)), jstream.read_list_file(str(lst))
    assert got == want and got[1] == str(tmp_path / "img" / "1.png")
    frames = list(tstream.ImageListStreamSource(got, got[::-1], paced=False))
    jframes = list(jstream.ImageListStreamSource(want, want[::-1], paced=False))
    assert len(frames) == len(jframes) == 3
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a.sbs_nv12, b.sbs_nv12)
        assert (a.index, a.height, a.full_width) == (b.index, b.height, b.full_width)
    with pytest.raises(ValueError, match="mismatch"):
        tstream.ImageListStreamSource(got, got[:1])


def test_frame_ring_and_host_ops(rng):
    """The native ring: FIFO order with timestamps and indices, drops when
    full; the host NV12 ops against the port's torch colour-space ops."""
    import torch

    from hobot_stereonet_tpu_torch.ops import colorspace as cs

    assert hostio.available() and hostio.library_path().is_file()
    assert hostio.library_path().parent.name == "hostio"
    ring = hostio.FrameRing(16, capacity=2)
    frames = [rng.integers(0, 256, 16, dtype=np.uint8) for _ in range(3)]
    assert ring.push(frames[0], 1.5, 7) and ring.push(frames[1], 2.5, 8)
    assert not ring.push(frames[2], 3.5, 9) and ring.dropped == 1 and len(ring) == 2
    out, ts, idx = ring.pop()
    np.testing.assert_array_equal(out, frames[0])
    assert (ts, idx) == (1.5, 7)
    assert ring.pop()[2] == 8 and ring.pop() is None
    with pytest.raises(ValueError):
        ring.push(np.zeros(3, np.uint8))
    ring.close()
    h, w = 8, 12
    bgr = rng.integers(0, 256, (h, 2 * w, 3), dtype=np.uint8)
    sbs = hostio.bgr_to_nv12(bgr)
    np.testing.assert_array_equal(sbs, cs.bgr_to_nv12(torch.from_numpy(bgr)).numpy())
    left, right = hostio.nv12_split_sbs(sbs, h, 2 * w)
    l_t, r_t = cs.split_side_by_side_nv12(torch.from_numpy(sbs), h, 2 * w)
    np.testing.assert_array_equal(left, l_t.numpy())
    np.testing.assert_array_equal(right, r_t.numpy())
    y, uv = cs.nv12_to_planes(torch.from_numpy(left), h, w)
    np.testing.assert_array_equal(hostio.nv12_to_yuv444(left, h, w),
                                  cs.yuv420_to_yuv444(y, uv).numpy())


def test_native_ring_builds_under_build_not_native():
    """The library is built from the port's own source into ``build/hostio``;
    the JAX package's ``native/`` is left as git has it."""
    lib = hostio.library_path()
    assert lib.parent == hostio.BUILD_DIR and hostio.BUILD_DIR.parent.name == "build"
    assert hostio.SRC.parent.parent.name == "hobot_stereonet_tpu_torch"
    status = subprocess.run(["git", "status", "--porcelain", "--", "native"], cwd=ROOT,
                            capture_output=True, text=True)
    assert status.returncode != 0 or status.stdout == ""


class _Source:
    """A synthetic source of ``n`` small frames, ``delay`` s apart."""

    def __init__(self, n, delay=0.0, fail_at=None):
        self.n, self.delay, self.fail_at, self.made = n, delay, fail_at, 0

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail_at:
                raise OSError("capture failed")
            self.made += 1
            time.sleep(self.delay)
            yield tstream.Frame(float(i), np.full(24, i, np.uint8), 4, 4,
                                np.full((4, 2), i, np.float32), i)


@pytest.mark.parametrize("native", [True, False], ids=["native", "queue"])
def test_threaded_capture_keeps_frames_and_metadata(native):
    src = tstream.ThreadedCaptureSource(_Source(20, delay=0.001), capacity=32,
                                        use_native=native)
    got = list(src)
    assert [f.index for f in got] == list(range(20)) and src.native is native
    for f in got:
        assert (f.sbs_nv12 == f.index).all() and f.timestamp == float(f.index)
        assert (f.gt_disparity == f.index).all() and (f.height, f.full_width) == (4, 4)


@pytest.mark.parametrize("native", [True, False], ids=["native", "queue"])
def test_threaded_capture_drops_on_full_and_stops_early(native):
    """A slow consumer loses the newest frames (drop-on-full, as the JAX
    package's); closing the iterator stops the producer promptly."""
    src = tstream.ThreadedCaptureSource(_Source(40), capacity=2, use_native=native)
    it = iter(src)
    first = next(it)
    time.sleep(0.2)                      # the producer fills the ring and drops the rest
    rest = list(it)
    assert first.index == 0 and src.dropped > 0
    assert len(rest) + 1 + src.dropped == 40
    slow = _Source(10_000, delay=0.002)
    it = iter(tstream.ThreadedCaptureSource(slow, capacity=4, use_native=native))
    next(it)
    it.close()
    made = slow.made
    time.sleep(0.05)
    assert slow.made == made < 10_000


def test_threaded_capture_matches_jax_and_surfaces_errors():
    """The same frames as the JAX package's capture source through the queue,
    and a capture failure re-raised on the feed side."""
    got = [f.index for f in tstream.ThreadedCaptureSource(_Source(5), use_native=False)]
    want = [f.index for f in jstream.ThreadedCaptureSource(_Source(5), use_native=False)]
    assert got == want == list(range(5))
    with pytest.raises(RuntimeError, match="capture thread died"):
        list(tstream.ThreadedCaptureSource(_Source(5, fail_at=2)))


# ---------------------------------------------------------------------------
# Colormaps and the display server
# ---------------------------------------------------------------------------

def test_colormaps_equal_jax(tmp_path, rng):
    disp = rng.uniform(0, 40, (12, 20)).astype(np.float32)
    depth = rng.uniform(0.5, 15, (12, 20)).astype(np.float32)
    left = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
    for name, args in (("colorize_disparity", (disp,)), ("colorize_depth", (depth,)),
                       ("jet_colormap", ((disp * 6).astype(np.uint8),)),
                       ("stack_vertical", (left, tcm.colorize_disparity(disp)))):
        np.testing.assert_array_equal(getattr(tcm, name)(*args), getattr(jcm, name)(*args))
    for z in (None, depth):
        np.testing.assert_array_equal(tcm.render_result(left, disp, depth_m=z),
                                      jcm.render_result(left, disp, depth_m=z))
    tcm.save_png(str(tmp_path / "x.png"), tcm.render_result(left, disp))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "x.png")),
                                  jcm.render_result(left, disp))


def test_display_server_serves_page_and_frame(rng):
    from types import SimpleNamespace

    from hobot_stereonet_tpu_torch.viz.server import DisplayServer, encode_jpeg, publish_result

    with DisplayServer(port=0, host="127.0.0.1", metrics_fn=lambda: {"frames_out": 3}) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        page = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b"<img src=\"/stream\"" in page
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/frame.jpg", timeout=5)
        assert e.value.code == 503
        result = SimpleNamespace(left_rgb=rng.integers(0, 256, (8, 16, 3), dtype=np.uint8),
                                 disparity=rng.uniform(0, 30, (8, 16)).astype(np.float32),
                                 depth_m=None)
        publish_result(srv, result)
        jpeg = urllib.request.urlopen(base + "/frame.jpg", timeout=5).read()
        assert jpeg == srv.latest_jpeg() == encode_jpeg(tcm.render_result(
            result.left_rgb, result.disparity))
        assert np.asarray(Image.open(__import__("io").BytesIO(jpeg))).shape == (16, 16, 3)
        metrics = json.loads(urllib.request.urlopen(base + "/metrics", timeout=5).read())
        assert metrics == {"frames_out": 3}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=5)
