"""Command-line interface of the port.

Counterpart of ``hobot_stereonet_tpu/cli.py`` (``stereod``), with its
arguments, defaults and one-line JSON output::

    python -m hobot_stereonet_tpu_torch.cli infer  --left L.png --right R.png [--out out.png]
    python -m hobot_stereonet_tpu_torch.cli infer  --input-bin X.raw            a raw input tensor
    python -m hobot_stereonet_tpu_torch.cli stream --frames N [--fps 15] [--ring] [--serve PORT]
    python -m hobot_stereonet_tpu_torch.cli eval   --dataset synthetic|layered|sceneflow|kitti
    python -m hobot_stereonet_tpu_torch.cli bench  [--streaming] [--int8 | --int8-static]
    python -m hobot_stereonet_tpu_torch.cli calibrate --out calib.json
    python -m hobot_stereonet_tpu_torch.cli dump   --left L.png --right R.png --out dump.npz
    python -m hobot_stereonet_tpu_torch.cli compare A B
    python -m hobot_stereonet_tpu_torch.cli train  --steps N [--checkpoint DIR]
    python -m hobot_stereonet_tpu_torch.cli export --out model.stereoblob [--buckets 1,8]
    python -m hobot_stereonet_tpu_torch.cli infer|stream ... --artifact model.stereoblob
    python -m hobot_stereonet_tpu_torch.cli slam   [--gt-disparity] [--loop-closure]
    python -m hobot_stereonet_tpu_torch.cli bench-scaling --devices N --device cpu   gloo ranks
    torchrun --nproc-per-node N -m hobot_stereonet_tpu_torch.cli bench-scaling --devices N

Every command runs on ``cuda:0`` unless ``--device`` names another
(``--device cpu`` runs the kernels' plain versions).  Images are read and
PNGs written through PIL; raw ``.nv12`` frames and ``.bin``/``.raw`` tensors
need no PIL.

Weights (``--checkpoint``): a directory holding ``params.npz`` (what
``train`` writes) or a flax-layout ``.npz``; ``none`` forces seeded random
weights.  Without it the crowned flagship is the default, as in the JAX
package: its ``FLAGSHIP.json`` and ``config.json`` from
``checkpoints/flagship``, its weights from
``hobot_stereonet_tpu_torch/reference/flagship_params.npz`` (the port reads
no orbax directory); ``--model classic`` then gets random weights.

``--int8`` serves w8a8 with dynamic scales, ``--int8-calib JSON`` with
calibrated ones (``calibrate`` writes them); ``eval`` evaluates the network
it serves in either scheme.  ``--debug-nans`` raises at the first module
whose output is not finite (``utils/debug.py``), and in training turns on
autograd's anomaly detection.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]


def _make_config(args, h: Optional[int] = None, w: Optional[int] = None):
    """``--config`` JSON (``Config.from_json``) if given, else the defaults;
    optionally another camera geometry."""
    from .config import Config

    cfg = Config.from_json(args.config) if getattr(args, "config", None) else Config()
    if h is not None:
        cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, width=w, height=h))
    return cfg


def _flagship_dir() -> Optional[Path]:
    """The crowned default checkpoint's directory, if installed."""
    d = ROOT / "checkpoints" / "flagship"
    return d if (d / "FLAGSHIP.json").is_file() else None


def _resolve_checkpoint(args, cfg):
    """(cfg, weights path or None): an explicit ``--checkpoint`` wins
    (``none``: random weights); else the crowned flagship, unless
    ``--config`` pins another architecture or ``--model`` asks for another
    class than the crowned one."""
    from .reference import PARAMS_NPZ

    explicit = getattr(args, "checkpoint", None)
    if explicit:
        return cfg, (None if explicit == "none" else explicit)
    flag = _flagship_dir()
    if flag is None or getattr(args, "config", None):
        return cfg, None
    meta = json.loads((flag / "FLAGSHIP.json").read_text())
    if meta.get("model_class", "fast") != (getattr(args, "model", None) or "fast"):
        return cfg, None
    from .config import Config

    cfg = dataclasses.replace(cfg, model=Config.from_json(str(flag / "config.json")).model)
    print(f"using flagship checkpoint {flag} ({meta['candidate']['name']}, weights "
          f"{PARAMS_NPZ.name}); pass --checkpoint none for random init", file=sys.stderr)
    return cfg, str(PARAMS_NPZ)


def _load_params(path: Optional[str]):
    if path is None:
        return None
    from .runtime.checkpoint import load_params

    p = Path(path)
    if p.is_dir() and not (p / "params.npz").is_file():
        raise FileNotFoundError(f"{path}: no params.npz (the port reads the flax-layout .npz "
                                "that train writes, not orbax directories)")
    return load_params(path)


def _debug(args, model) -> None:
    if getattr(args, "debug_nans", False):
        from .utils.debug import raise_on_nonfinite

        raise_on_nonfinite(model)


def _build_engine(args, h: Optional[int] = None, w: Optional[int] = None,
                  keep_left: bool = False):
    """(the engine the arguments ask for, its flax weights or None)."""
    from .runtime.engine import StereoEngine

    cfg, checkpoint = _resolve_checkpoint(args, _make_config(args, h, w))
    params = _load_params(checkpoint)
    eng = StereoEngine(cfg, params=params, keep_left=keep_left,
                       int8=getattr(args, "int8", False),
                       static_quant=getattr(args, "int8_calib", None),
                       device=getattr(args, "device", None), model=args.model)
    _debug(args, eng.model)
    return eng, params


def _float_network(args, eng, params):
    """The engine's network with float convs (not quantized), on its device,
    in eval mode: what ``dump`` captures and ``calibrate`` records."""
    from .models import build_model
    from .ops.quant import serving_model
    from .runtime.weights import from_flax_params, random_flax_params

    net = build_model(args.model, eng.cfg.model, eng.device)
    if params is None:
        params = random_flax_params(eng.cfg.model, seed=0, model=args.model)
    net.load_state_dict(from_flax_params(params, net.cfg, args.model))
    net = serving_model(net)
    _debug(args, net)
    return net


def _read_any_image(path: str, nv12_height: int, nv12_width: int):
    """An RGB uint8 image from a PNG/JPEG (the dataset reader) or a raw
    ``.nv12`` dump converted to RGB, as the JAX CLI converts it."""
    if not path.endswith(".nv12"):
        from .data.sceneflow import _read_image

        return _read_image(path)
    import numpy as np
    import torch

    from .ops import colorspace as cs

    raw = np.fromfile(path, dtype=np.uint8)
    expect = nv12_height * nv12_width * 3 // 2
    if raw.size != expect:
        raise SystemExit(f"{path}: {raw.size} bytes, expected {expect} for "
                         f"{nv12_width}x{nv12_height} NV12 (set --nv12-width/--nv12-height)")
    yuv = cs.yuv420_to_yuv444(*cs.nv12_to_planes(torch.from_numpy(raw), nv12_height,
                                                 nv12_width))
    rgb = torch.clamp(cs.yuv_to_rgb(yuv.float()), 0.0, 255.0)
    return rgb.numpy().astype(np.uint8)


def _disparity_stats(disp) -> dict:
    return {"min": float(disp.min()), "max": float(disp.max()), "mean": float(disp.mean())}


def cmd_infer(args) -> int:
    import numpy as np

    from .viz import colormap as cm

    if args.input_bin:
        from .data.bintensor import load_input_tensor

        cfg = _make_config(args, h=args.bin_height, w=args.bin_width)
        x = load_input_tensor(args.input_bin, args.bin_height, args.bin_width,
                              dtype=args.bin_dtype, layout=args.bin_layout, cfg=cfg.preprocess)
        eng, _ = _build_engine(args, h=args.bin_height, w=args.bin_width)
        disp = eng.infer_preprocessed(x)
        print(json.dumps({"source": "bin", "shape": list(disp.shape),
                          "disparity_px": {**_disparity_stats(disp),
                                           "median": float(np.median(disp))}}))
        if args.out:
            cm.save_png(args.out, cm.colorize_disparity(disp))
            print(f"wrote {args.out}", file=sys.stderr)
        return 0
    if not args.left or not args.right:
        raise SystemExit("infer needs --left/--right images or --input-bin")
    from .data.loader import pad_to_multiple

    left = _read_any_image(args.left, args.nv12_height, args.nv12_width)
    right = _read_any_image(args.right, args.nv12_height, args.nv12_width)
    h, w = left.shape[:2]
    lp, rp = pad_to_multiple(left, 16), pad_to_multiple(right, 16)
    if args.artifact:
        # The deployment path: the compiled .stereoblob, no model code; the
        # geometry must be the artifact's.
        from .runtime.artifact import CompiledStereoArtifact

        with CompiledStereoArtifact(args.artifact, device=args.device) as art:
            if (lp.shape[0], lp.shape[1]) != (art.height, art.width):
                raise SystemExit(
                    f"input {lp.shape[1]}x{lp.shape[0]} != artifact geometry "
                    f"{art.width}x{art.height} (artifacts are fixed-function, like .hbm blobs)")
            disp = art.infer(lp, rp)[:h, :w]
    else:
        eng, _ = _build_engine(args, h=lp.shape[0], w=lp.shape[1])
        disp = eng.infer(lp, rp)[:h, :w]
    print(json.dumps({"shape": list(disp.shape), "disparity_px": _disparity_stats(disp)}))
    if args.out:
        cm.save_png(args.out, cm.render_result(left, disp))
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def cmd_stream(args) -> int:
    from .data.stream import SyntheticStreamSource, ThreadedCaptureSource
    from .utils.profiling import device_trace

    if args.artifact:
        # Deployment serving: the feed/poll loop over a compiled .stereoblob.
        if args.serve is not None:
            raise SystemExit("--serve needs the live engine (left-view decode); run without "
                             "--artifact")
        from .runtime.artifact import ArtifactEngine

        eng = ArtifactEngine(args.artifact, device=args.device)
        h, w = eng.height, eng.width
    else:
        eng, _ = _build_engine(args, keep_left=args.serve is not None)
        h, w = eng.cfg.camera.height, eng.cfg.camera.width
    if args.left_list or args.right_list:
        if not (args.left_list and args.right_list):
            raise SystemExit("--left-list and --right-list go together")
        import itertools

        from .data.stream import ImageListStreamSource, read_list_file

        src = ImageListStreamSource(read_list_file(args.left_list),
                                    read_list_file(args.right_list), fps=args.fps,
                                    paced=not args.unpaced)
        if args.frames:
            src = itertools.islice(iter(src), args.frames)
    else:
        src = SyntheticStreamSource(height=h, width=w, fps=args.fps, num_frames=args.frames,
                                    paced=not args.unpaced)
    # List replay decodes images on the capture side: by default it runs
    # through the capture thread's ring.
    ring = args.ring if args.ring is not None else bool(args.left_list)
    capture = ThreadedCaptureSource(src) if ring else None
    if capture is not None:
        src = capture
    server = None
    if args.serve is not None:
        from .viz.server import DisplayServer

        server = DisplayServer(port=args.serve, metrics_fn=eng.metrics.snapshot).start()
        print(f"serving live view on http://localhost:{server.port}/", flush=True)
    try:
        with device_trace(args.profile):
            if server is not None:
                from .viz.server import publish_result

                results = []
                with eng:
                    for frame in src:
                        eng.feed(frame)
                        while (r := eng.poll(timeout=0)) is not None:
                            publish_result(server, r)
                            results.append(r)
                    eng.drain()
                    while (r := eng.poll(timeout=0.2)) is not None:
                        publish_result(server, r)
                        results.append(r)
            else:
                results = eng.run_stream(src)
    finally:
        if server is not None:
            server.stop()
    snap = eng.metrics.snapshot()
    if results and results[0].gt_disparity is not None:
        import numpy as np

        from .ops import disparity as dp

        epes = [float(dp.end_point_error(r.disparity, r.gt_disparity)) for r in results]
        snap["epe_px"] = round(float(np.mean(epes)), 3)
    if capture is not None:
        snap["capture_ring"] = "native" if capture.native else "queue"
        snap["capture_dropped"] = capture.dropped
    print(json.dumps(snap))
    return 0


def _eval_dataset(args):
    if args.dataset == "synthetic":
        from .data.loader import SyntheticStereoDataset

        return SyntheticStereoDataset(size=args.frames or 16, height=256, width=512,
                                      seed=args.eval_seed)
    if args.dataset == "layered":
        from .data.loader import LayeredSceneDataset

        return LayeredSceneDataset(size=args.frames or 16)
    if args.dataset == "sceneflow":
        from .data.sceneflow import SceneFlowDataset

        return SceneFlowDataset(args.root)
    from .data.kitti import Kitti2015Dataset

    return Kitti2015Dataset(args.root)


def cmd_eval(args) -> int:
    from .runtime.evaluate import evaluate_dataset

    ds = _eval_dataset(args)
    eng, _ = _build_engine(args)
    out = {}
    if args.check_determinism:
        # The same program on the same data gives the same bits.
        import numpy as np

        s = ds[0]
        d1, d2 = eng.infer(s.left, s.right), eng.infer(s.left, s.right)
        out["deterministic"] = bool(np.array_equal(d1, d2))
        if not out["deterministic"]:
            print("DETERMINISM CHECK FAILED: identical inputs produced different disparities",
                  file=sys.stderr)
    # The network the engine serves (bf16, or int8 in either scheme).
    res = evaluate_dataset(eng.model, None, ds, eng.cfg, max_frames=args.frames or 0)
    out.update(res.to_dict())
    print(json.dumps(out))
    return 0 if out.get("deterministic", True) else 1


def cmd_bench(args) -> int:
    """bench.py's regimes over ``runtime.benchmark.measure_engine_fps``; one
    JSON line ``{"metric", "value", "unit", "vs_baseline"}`` (baseline 15
    frames/s, a live camera's rate)."""
    from .config import Config
    from .reference import CALIB_JSON, PARAMS_NPZ
    from .runtime.benchmark import measure_engine_fps
    from .runtime.weights import load_flax_npz

    flag = ROOT / "checkpoints" / "flagship" / "config.json"
    kwargs = {}
    if flag.is_file():
        # The crowned flagship's input contract (YUV); throughput does not
        # depend on the weights.
        kwargs["preprocess_cfg"] = Config.from_json(str(flag)).preprocess
    if args.int8_static:
        if not CALIB_JSON.is_file():
            raise SystemExit(f"--int8-static needs {CALIB_JSON} (calibrate)")
        cfg = Config.from_json(str(flag))
        kwargs.update(params=load_flax_npz(str(PARAMS_NPZ)), model_cfg=cfg.model,
                      static_quant=str(CALIB_JSON), preprocess_cfg=cfg.preprocess)
        print("serving config: flagship + calibrated static int8", file=sys.stderr)
    res = measure_engine_fps(batch=32 if args.streaming else 128, n_batches=12, int8=args.int8,
                             stage_timing=args.stage_timing, verbose_to=sys.stderr,
                             device=args.device, **kwargs)
    if res["nan_dropped"]:
        print(f"WARNING: {res['nan_dropped']} frames NaN-dropped (drop-and-continue policy; "
              "fps counts published frames)", file=sys.stderr)
    if args.stage_timing and "preprocess_ms" in res:
        print(f"stage split: preprocess {res['preprocess_ms']} ms/batch, network "
              f"{res['network_ms']} ms/batch", file=sys.stderr)
    metric = ("stereo_fps_per_chip_1280x720" + ("_int8" if args.int8 else "")
              + ("_int8static_flagship" if args.int8_static else "")
              + ("_streaming" if args.streaming else "")
              + ("_stage_timing" if args.stage_timing else ""))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"metric": metric, **res}, f, indent=2)
        print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps({"metric": metric, "value": res["fps"], "unit": "frames/s",
                      "vs_baseline": round(res["fps"] / 15.0, 2)}))
    return 0


def cmd_calibrate(args) -> int:
    """Offline int8 calibration: ``--frames`` synthetic frames through the
    float network, the max |input| of each conv, a scales JSON for
    ``--int8-calib``."""
    from .data.loader import SyntheticStereoDataset
    from .ops import preprocess as pp
    from .ops.quant import calibrate_activation_scales, save_calibration

    eng, params = _build_engine(args, h=args.height, w=args.width)
    ds = SyntheticStereoDataset(size=args.frames, height=args.height, width=args.width,
                                seed=args.seed)

    def batches():
        for i in range(len(ds)):
            s = ds[i]
            yield pp.split_model_input(pp.rgb_pair_to_model_input(
                s.left, s.right, eng.cfg.preprocess, eng.device))

    calib = calibrate_activation_scales(_float_network(args, eng, params), batches())
    save_calibration(args.out, calib)
    print(json.dumps({"out": args.out, "convs": len(calib), "frames": args.frames,
                      "scale_range": [min(calib.values()), max(calib.values())]}))
    return 0


def cmd_train(args) -> int:
    import contextlib

    import torch

    from .runtime.train_loop import train_synthetic

    cfg = _make_config(args)
    anomaly = torch.autograd.detect_anomaly() if args.debug_nans else contextlib.nullcontext()
    with anomaly:
        metrics = train_synthetic(
            steps=args.steps,
            batch_size=args.batch,
            checkpoint_dir=args.checkpoint,
            log_every=args.log_every,
            lr=args.lr,
            seed=args.seed,
            resume_from=args.resume,
            model=args.model,
            model_cfg=cfg.model,
            color_space=cfg.preprocess.color_space,
            device=args.device,
        )
    print(json.dumps(metrics))
    return 0


def cmd_dump(args) -> int:
    """Golden-tensor dump of one pair: every module's output (the float
    network, as the JAX CLI's)."""
    from .data.loader import pad_to_multiple
    from .data.sceneflow import _read_image
    from .runtime.golden import dump_pipeline

    left = pad_to_multiple(_read_image(args.left), 16)
    right = pad_to_multiple(_read_image(args.right), 16)
    eng, params = _build_engine(args, h=left.shape[0], w=left.shape[1])
    tensors = dump_pipeline(_float_network(args, eng, params), None, left, right, eng.cfg,
                            path=args.out)
    out = {"tensors": len(tensors), "out": args.out, "names": sorted(tensors)[:8]}
    if args.bin_out:
        # The raw .bin exchange set: the float NCHW input, its int8
        # quantization and the disparity, for foreign toolkits and compare.
        from .data.bintensor import save_bin_dir, save_input_tensor

        x = tensors["input_normalized"]
        save_bin_dir(args.bin_out, {"input_normalized": x, "disparity": tensors["disparity"]})
        for name, dtype in (("input_float_nchw.raw", "float32"), ("input_quant_nchw.raw", "int8")):
            save_input_tensor(os.path.join(args.bin_out, name), x, dtype=dtype, layout="nchw",
                              cfg=eng.cfg.preprocess)
        out["bin_out"] = args.bin_out
    print(json.dumps(out))
    return 0


def cmd_slam(args) -> int:
    """Stereo VO: a synthetic trajectory by default, or an odometry sequence
    (KITTI or EuRoC layout) with --odometry-root; network disparity (or GT
    with --gt-disparity on the synthetic path) -> tracker -> windowed BA ->
    ATE.  The tracker runs on the engine's device (--device)."""
    import numpy as np

    from .config import CameraConfig, SLAMConfig

    if args.odometry_root:
        from .slam.run import open_sequence, run_odometry_sequence

        seq = open_sequence(args.odometry_root, args.sequence)
        first = seq[0]
        eng, _ = _build_engine(args, h=first.left.shape[0] // 16 * 16,
                               w=first.left.shape[1] // 16 * 16)
        out = run_odometry_sequence(seq, engine=eng, max_frames=args.frames,
                                    loop_closure=args.loop_closure)
        if "ate_m" in out:
            out["ate_m"] = round(out["ate_m"], 4)
        print(json.dumps(out))
        return 0
    from .data.synthetic import LayeredScene
    from .slam.tracker import StereoSLAM, absolute_trajectory_error

    cam = CameraConfig(width=args.width, height=args.height)
    rng = np.random.default_rng(args.seed)
    scene = LayeredScene(rng, cam.height, cam.width, cam.focal_px, cam.baseline_m)
    conf_gate = args.confidence_gate or 0.0
    eng = None
    if not args.gt_disparity:
        eng, _ = _build_engine(args, h=cam.height, w=cam.width)
    elif conf_gate > 0:
        raise SystemExit("--confidence-gate needs network disparity (drop --gt-disparity)")
    slam = StereoSLAM(cam, SLAMConfig(keyframe_translation_m=0.08, min_confidence=conf_gate),
                      device=eng.device if eng is not None else args.device)
    ts = np.linspace(0, 1, args.frames)
    gt_centers = np.stack([0.6 * ts, 0.12 * np.sin(2 * np.pi * ts), np.zeros_like(ts)],
                          axis=-1)
    tracked = 0
    t0 = time.monotonic()
    for tx, ty, _ in gt_centers:
        l, r, d = scene.render(float(tx), float(ty))
        conf = None
        if eng is not None:
            if conf_gate > 0:
                d, conf = eng.infer_with_confidence(l, r)
            else:
                d = eng.infer(l, r)
        tracked += int(slam.process(l, d, confidence=conf)["tracked"])
    slam.refine_window(window=4)
    loops = 0
    if args.loop_closure:
        from .slam.pose_graph import close_loops

        res = close_loops(slam)
        loops = len(res["loops"]) if res is not None else 0
    seconds = time.monotonic() - t0
    ate = absolute_trajectory_error(np.stack(slam.state.trajectory), gt_centers)
    print(json.dumps({
        "ate_m": round(ate, 4),
        "frames": args.frames,
        "tracked": tracked,
        "keyframes": len(slam.state.keyframes),
        "disparity_source": "gt" if args.gt_disparity else "network",
        **({"confidence_gate": conf_gate} if conf_gate > 0 else {}),
        **({"loops_closed": loops} if args.loop_closure else {}),
        "frames_per_s": round(args.frames / seconds, 3),
    }))
    return 0


def cmd_export(args) -> int:
    """Trace and serialize the serving pipeline to a .stereoblob (the
    reference's offline .hbm build step): weights baked in, one entry per
    platform and batch bucket."""
    from .runtime.artifact import export_artifact

    cfg, checkpoint = _resolve_checkpoint(args, _make_config(args))
    t0 = time.monotonic()
    manifest = export_artifact(
        args.out, args.model, _load_params(checkpoint), cfg,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        platforms=tuple(args.platforms.split(",")), int8=args.int8,
        static_quant=args.int8_calib)
    print(json.dumps({
        "out": args.out,
        "bytes": os.path.getsize(args.out),
        "buckets": manifest["buckets"],
        "platforms": manifest["platforms"],
        "geometry": f"{manifest['width']}x{manifest['height']}",
        "quant": manifest["quant"],
        "seconds": round(time.monotonic() - t0, 3),
    }))
    return 0


def cmd_compare(args) -> int:
    """Diff two golden dumps."""
    from .runtime.golden import compare, load_dump

    ok, report = compare(load_dump(args.a), load_dump(args.b), rtol=args.rtol, atol=args.atol)
    bad = {k: v for k, v in report.items() if v["status"] != "ok"}
    print(json.dumps({"match": ok, "tensors": len(report), "mismatches": bad}))
    return 0 if ok else 1


CHECKPOINT_HELP = ("weights: a directory with params.npz or a flax-layout .npz (default: the "
                   "crowned flagship if installed; 'none' forces random init)")


def cmd_bench_scaling(args) -> int:
    """A data-parallel forward at 1 and N ranks (``runtime/scaling.py``):
    N gloo ranks spawned on this host with ``--device cpu``, else the ranks
    ``torchrun`` launched, one a card.  Rank 0 prints the JSON line."""
    from .runtime.scaling import bench_scaling

    out = bench_scaling(devices=args.devices, per_device_batch=args.per_device_batch,
                        height=args.height, width=args.width, iters=args.iters,
                        device=args.device)
    if out is not None:
        print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hobot_stereonet_tpu_torch.cli", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", default=None, metavar="JSON",
                        help="load a full Config from JSON (Config.from_json)")
        sp.add_argument("--model", default="fast", choices=["fast", "classic"],
                        help="network: fast (the streaming flagship) or classic "
                             "(the StereoNet paper's 3-D conv build)")
        sp.add_argument("--int8", action="store_true",
                        help="run the network w8a8 int8 with dynamic scales (the same "
                             "checkpoint, convs swapped when the model is built)")
        sp.add_argument("--int8-calib", default=None, metavar="JSON",
                        help="calibrated static activation scales (calibrate): the "
                             "static-scale int8 path, the reference's deployment scheme")
        sp.add_argument("--debug-nans", action="store_true",
                        help="raise at the first module whose output is not finite (train: "
                             "autograd anomaly detection); serializes the device")
        sp.add_argument("--device", default=None,
                        help="torch device (default cuda:0; cpu runs the kernels' plain versions)")

    pi = sub.add_parser("infer", help="single stereo pair -> disparity (PNG/JPEG or raw .nv12)")
    pi.add_argument("--nv12-width", type=int, default=1280, help="frame width of .nv12 inputs")
    pi.add_argument("--nv12-height", type=int, default=720, help="frame height of .nv12 inputs")
    pi.add_argument("--left", default=None)
    pi.add_argument("--right", default=None)
    pi.add_argument("--input-bin", default=None, metavar="BIN",
                    help="raw preprocessed input-tensor dump (float32 normalized or int8 "
                         "quantized) fed to the network; replaces --left/--right")
    pi.add_argument("--bin-layout", default="nchw", choices=["nchw", "nhwc"],
                    help="tensor layout of --input-bin (reference dumps are NCHW)")
    pi.add_argument("--bin-dtype", default="auto", choices=["auto", "float32", "int8"],
                    help="element type of --input-bin (auto: from its size)")
    pi.add_argument("--bin-height", type=int, default=720)
    pi.add_argument("--bin-width", type=int, default=1280)
    pi.add_argument("--out", default=None, help="composite PNG path")
    pi.add_argument("--checkpoint", default=None, help=CHECKPOINT_HELP)
    pi.add_argument("--artifact", default=None, metavar="BLOB",
                    help="run a compiled .stereoblob (export) instead of the live model; "
                         "the input geometry must match the artifact's")
    common(pi)
    pi.set_defaults(fn=cmd_infer)

    ps = sub.add_parser("stream", help="live-stream emulation")
    ps.add_argument("--frames", type=int, default=30)
    ps.add_argument("--fps", type=float, default=15.0)
    ps.add_argument("--unpaced", action="store_true")
    ps.add_argument("--left-list", default=None, metavar="FILE",
                    help="replay a (left) image-list file instead of the synthetic stream")
    ps.add_argument("--right-list", default=None, metavar="FILE")
    ps.add_argument("--ring", action=argparse.BooleanOptionalAction, default=None,
                    help="run capture in its own thread through the native SPSC frame ring "
                         "(default: on for list replay)")
    ps.add_argument("--checkpoint", default=None, help=CHECKPOINT_HELP)
    ps.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace (Chrome JSON) into LOGDIR")
    ps.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve a live MJPEG browser view (left|disparity composite)")
    ps.add_argument("--artifact", default=None, metavar="BLOB",
                    help="serve a compiled .stereoblob through ArtifactEngine (no model code)")
    common(ps)
    ps.set_defaults(fn=cmd_stream)

    pe = sub.add_parser("eval", help="dataset EPE/D1 evaluation")
    pe.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "layered", "sceneflow", "kitti"])
    pe.add_argument("--root", default=None)
    pe.add_argument("--frames", type=int, default=0)
    pe.add_argument("--eval-seed", type=int, default=777,
                    help="synthetic eval-set seed (disjoint from train seeds)")
    pe.add_argument("--checkpoint", default=None, help=CHECKPOINT_HELP)
    pe.add_argument("--check-determinism", action="store_true",
                    help="run the first pair twice and require bit-equal disparities")
    common(pe)
    pe.set_defaults(fn=cmd_eval)

    pb = sub.add_parser("bench", help="headline throughput bench (bench.py's regimes)")
    pb.add_argument("--int8", action="store_true", help="w8a8, dynamic scales")
    pb.add_argument("--int8-static", action="store_true",
                    help="the flagship with checkpoints/flagship/calib.json")
    pb.add_argument("--streaming", action="store_true",
                    help="batch 32 (camera-paced) instead of 128")
    pb.add_argument("--stage-timing", action="store_true",
                    help="time the ingest and the network apart (diagnostic)")
    pb.add_argument("--out", default=None, metavar="FILE",
                    help="also write the full measurement dict as JSON")
    pb.add_argument("--device", default=None, help="torch device (default cuda:0)")
    pb.set_defaults(fn=cmd_bench)

    pq = sub.add_parser("calibrate", help="offline int8 activation-scale calibration -> JSON")
    pq.add_argument("--out", required=True)
    pq.add_argument("--frames", type=int, default=8)
    pq.add_argument("--height", type=int, default=256)
    pq.add_argument("--width", type=int, default=512)
    pq.add_argument("--seed", type=int, default=4242,
                    help="calibration-set seed (disjoint from train/eval)")
    pq.add_argument("--checkpoint", default=None, help=CHECKPOINT_HELP)
    common(pq)
    pq.set_defaults(fn=cmd_calibrate)

    pt = sub.add_parser("train", help="train on procedural scenes")
    pt.add_argument("--steps", type=int, default=100)
    pt.add_argument("--batch", type=int, default=4)
    pt.add_argument("--checkpoint", default=None,
                    help="directory to save the training state into (params.npz, opt_state.pt)")
    pt.add_argument("--log-every", type=int, default=20)
    pt.add_argument("--lr", type=float, default=1e-3)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--resume", default=None,
                    help="checkpoint to continue training from (weights only; a fresh optimizer)")
    common(pt)
    pt.set_defaults(fn=cmd_train)

    pv = sub.add_parser("slam", help="stereo VO on a synthetic trajectory or an odometry "
                                     "sequence")
    pv.add_argument("--frames", type=int, default=12)
    pv.add_argument("--width", type=int, default=320)
    pv.add_argument("--height", type=int, default=240)
    pv.add_argument("--seed", type=int, default=11)
    pv.add_argument("--gt-disparity", action="store_true",
                    help="track on ground-truth disparity (isolates the tracker)")
    pv.add_argument("--odometry-root", default=None,
                    help="an odometry dataset root (KITTI sequences/ or EuRoC mav0/)")
    pv.add_argument("--sequence", default="00")
    pv.add_argument("--checkpoint", default=None, help=CHECKPOINT_HELP)
    pv.add_argument("--loop-closure", action="store_true",
                    help="detect loops and optimize the keyframe pose graph")
    pv.add_argument("--confidence-gate", type=float, default=0.0,
                    help="map only keypoints whose network confidence (soft-argmin peak "
                         "probability) is at least this; needs network disparity")
    common(pv)
    pv.set_defaults(fn=cmd_slam)

    px = sub.add_parser("export", help="trace and serialize the serving pipeline to a "
                                       ".stereoblob artifact")
    px.add_argument("--out", required=True)
    px.add_argument("--checkpoint", default=None, help=CHECKPOINT_HELP)
    px.add_argument("--buckets", default="1,8", help="comma-separated batch buckets")
    px.add_argument("--platforms", default="cuda",
                    help="comma-separated platforms traced into the artifact (cpu, cuda)")
    common(px)
    px.set_defaults(fn=cmd_export)

    pd = sub.add_parser("dump", help="golden-tensor dump of one pair")
    pd.add_argument("--left", required=True)
    pd.add_argument("--right", required=True)
    pd.add_argument("--out", required=True)
    pd.add_argument("--bin-out", default=None, metavar="DIR",
                    help="also write raw .bin exchange tensors (float NCHW input, int8 "
                         "quantized input, disparity)")
    pd.add_argument("--checkpoint", default=None, help=CHECKPOINT_HELP)
    common(pd)
    pd.set_defaults(fn=cmd_dump)

    pc = sub.add_parser("compare", help="diff two golden dumps (.npz, a .bin dump dir, or a "
                                        "single raw .bin tensor)")
    pc.add_argument("a")
    pc.add_argument("b")
    pc.add_argument("--rtol", type=float, default=1e-4)
    pc.add_argument("--atol", type=float, default=1e-4)
    pc.set_defaults(fn=cmd_compare)

    pbs = sub.add_parser("bench-scaling", help="data-parallel forward at 1 and N ranks (gloo "
                                               "ranks on the CPU, or torchrun's on cards)")
    pbs.add_argument("--devices", type=int, default=None,
                     help="ranks (default: 8 gloo ranks with --device cpu; on cards the "
                          "number torchrun launched)")
    pbs.add_argument("--per-device-batch", type=int, default=1)
    pbs.add_argument("--width", type=int, default=256)
    pbs.add_argument("--height", type=int, default=128)
    pbs.add_argument("--iters", type=int, default=5)
    pbs.add_argument("--device", default=None,
                     help="cpu: spawn gloo ranks here (default: the launched ranks' cards)")
    pbs.set_defaults(fn=cmd_bench_scaling)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except (ValueError, AssertionError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
