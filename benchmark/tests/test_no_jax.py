"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole), and the reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

from benchmark import run

HERE = os.path.join(run.ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "volume_path_tracer_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "dataclasses", "json", "math", "os", "typing", "numpy", "torch"}, (path, tops)


def test_loaded_modules_of_a_run():
    code = ("import sys; sys.argv = ['x']; import benchmark.run, benchmark.calibrate; "
            "import benchmark.drivers.render, benchmark.drivers.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'volume_path_tracer_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
