"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level name (the program's own name begins with the JAX package's)."""

import ast

import pytest

from stereobench import harness


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(harness.HERE.rglob("*.py")), ids=lambda p: p.name)
def test_no_file_imports_jax_or_the_jax_package(path):
    assert harness.forbidden_modules(list(_imports(path))) == []


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("optax", True), ("orbax.checkpoint", True), ("hobot_stereonet_tpu", True),
    ("hobot_stereonet_tpu.ops.preprocess", True), ("hobot_stereonet_tpu_torch", False),
    ("hobot_stereonet_tpu_torch.runtime.engine", False), ("jax_like", False),
    ("torch", False), ("stereobench.harness", False)])
def test_forbidden_names_compare_whole_top_level_names(name, bad):
    assert (harness.forbidden_modules([name]) == [name]) is bad


def test_the_program_imports_no_jax(tmp_path):
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import stereobench.harness as h; "
            "import hobot_stereonet_tpu_torch.runtime.engine, stereobench.traffic.backlog, "
            "stereobench.reference.fast, stereobench.reference.classic; "
            "print(h.forbidden_modules(sys.modules))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
