"""The port imports neither JAX, flax, orbax nor the JAX package."""

import subprocess
import sys

CHECK = r"""
import importlib, pkgutil, sys
import hobot_stereonet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "hobot_stereonet_tpu"))
print(len(names), bad)
assert len(names) >= 20, names
new = {"data.synthetic", "data.loader", "data.stream", "utils.profiling",
       "runtime.benchmark", "runtime.evaluate", "runtime.golden", "ops.quant",
       "ops.kernels.int8_conv", "ops.kernels.numerics", "runtime.training",
       "runtime.train_loop", "runtime.checkpoint", "cli", "ops.int8_gemm", "data.bintensor",
       "data.sceneflow", "data.kitti", "runtime.hostio", "viz.colormap", "viz.server",
       "utils.debug", "runtime.artifact", "slam.se3", "slam.features", "slam.odometry",
       "slam.ba", "slam.pose_graph", "slam.tracker", "slam.run", "data.euroc",
       "data.kitti_odometry", "parallel", "parallel.mesh", "parallel.distributed",
       "parallel.halo", "parallel.tiling", "parallel.collectives", "runtime.scaling"}
missing = {pkg.__name__ + "." + n for n in new} - set(names)
assert not missing, missing
assert not bad, bad
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", CHECK], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax():
    src = open("chip_smoke.py").read()
    for word in ("import jax", "from jax", "import flax", "orbax", "hobot_stereonet_tpu."):
        assert word not in src, word
    compile(src, "chip_smoke.py", "exec")
