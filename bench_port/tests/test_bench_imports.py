"""Nothing that the harness, the job launcher or the reference loads is
JAX or the JAX package; the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from bench_port import run, spec as specs

HARNESS = ["bench_port.run", "bench_port.cli_job", "bench_port.control",
           "bench_port.check", "bench_port.trace", "bench_port.textfiles",
           "bench_port.entries.cli", "bench_port.entries.api",
           "bench_port.reference.density"]


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["clustering_tpu_torch",
                                  "clustering_tpu_torch.ops",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["clustering_tpu.ops", "jax._src",
                                  "jaxlib", "flax.linen"]) == [
        "clustering_tpu", "flax", "jax", "jaxlib"]


def test_harness_loads_no_jax():
    code = ("import sys, importlib, glob, os\n"
            f"for m in {HARNESS!r}: importlib.import_module(m)\n"
            "from bench_port import spec\n"
            "for p in glob.glob(os.path.join(spec.HERE, 'metrics', '*.py')):\n"
            "    spec.metric_reader(os.path.basename(p)[:-3])\n"
            "from bench_port.run import forbidden_modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=specs.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def imported(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_and_reference_no_program():
    for dirpath, _, files in os.walk(specs.HERE):
        for f in files:
            if f.endswith(".py"):
                names = imported(os.path.join(dirpath, f))
                assert not names & set(run.FORBIDDEN), f
                if os.path.basename(dirpath) == "reference":
                    assert "clustering_tpu_torch" not in names, f
                    assert names - sys.stdlib_module_names <= {
                        "numpy", "torch"}, f
