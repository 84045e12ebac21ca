"""The PyTorch port never imports jax or any module of the JAX package
``clustering_tpu``, and never falls back to the CPU when CUDA is asked
for."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "clustering_tpu_torch"
GOLDEN = ROOT / "tests" / "golden"

# sys.modules entries that must stay absent in a process of the port
FOREIGN = ("[m for m in sys.modules if m in ('jax', 'clustering_tpu')\n"
           "     or m.startswith(('jax.', 'clustering_tpu.'))]")


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if parts[-1] != "__main__":
            mods.append(".".join(parts))
    return mods


def _python(code, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "clustering_tpu_torch.ops.kernels" in mods
    assert "clustering_tpu_torch.models.state_filter" in mods
    assert "clustering_tpu_torch.parallel.sharded" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import clustering_tpu_torch as p\n"
            "p.populations, p.screening_series, p.parallel.sharded\n"
            f"bad = {FOREIGN}\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    assert _python(code, ROOT).startswith("ok")


def _imported_roots(path):
    """The top-level package of every absolute import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value.split(".")[0]


def test_sources_never_import_jax():
    paths = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [f"{p.relative_to(ROOT)}:{line}: {root}"
           for p in paths for line, root in _imported_roots(p)
           if root in ("jax", "jaxlib", "clustering_tpu")]
    assert not bad, bad


def test_host_modes_through_port_cli_import_no_jax_package(tmp_path):
    """density on the CPU, then the six host modes, in one process of the
    port's CLI: no module of jax or of the JAX package gets loaded."""
    for name in ("fe", "microstates", "clust.0.30", "clust.0.60",
                 "clust.0.90", "clust.1.20"):
        shutil.copy(GOLDEN / name, tmp_path / name)
    n = len(np.loadtxt(GOLDEN / "microstates"))
    rng = np.random.default_rng(2)
    np.savetxt(tmp_path / "coords.dat", rng.normal(size=(n, 2)), fmt="%.5f")
    runs = [
        ["density", "-f", "coords.dat", "-r", "0.5", "-p", "pop", "-d",
         "fe2", "-b", "nn", "-o", "c", "-T", "1.0"],
        ["network", "-p", "1", "-b", "clust", "--min", "0.3", "--step",
         "0.3"],
        ["mpp", "-s", "microstates", "-D", "fe", "-l", "2"],
        ["coring", "-s", "microstates", "-w", "2", "-o", "cored"],
        ["noise", "-s", "microstates", "-o", "denoised", "-b", "clust"],
        ["filter", "-s", "clust.1.20", "-c", "coords.dat", "-S", "1"],
        ["stats", "-s", "microstates"],
    ]
    code = ("import os, sys\n"
            "os.environ['CLUSTERING_TORCH_DEVICE'] = 'cpu'\n"
            "from clustering_tpu_torch import cli\n"
            f"for argv in {runs!r}:\n"
            "    assert cli.main(argv) == 0, argv\n"
            f"bad = {FOREIGN}\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    assert _python(code, tmp_path).splitlines()[-1] == "ok"
    for name in ("pop", "nn", "c.1.00", "network_links.dat", "cored",
                 "denoised", "coords.state1.dat"):
        assert (tmp_path / name).exists(), name


def test_surface_and_switches_import_no_jax_package(tmp_path):
    """The JAX package's call forms, ``screening_step``, the warms and
    ``band_sigma2_estimate``, and a profiled CLI run, in one process of
    the port: no module of jax or of the JAX package gets loaded."""
    code = ("import os, sys\n"
            "import numpy as np\n"
            "os.environ['CLUSTERING_TORCH_DEVICE'] = 'cpu'\n"
            "os.environ['CLUSTERING_TPU_PROFILE'] = 'trace'\n"
            "from clustering_tpu_torch import cli\n"
            "from clustering_tpu_torch.models.density import screening_step\n"
            "from clustering_tpu_torch.ops import density, neighbors\n"
            "from clustering_tpu_torch.ops.engine import DensityEngine\n"
            "from clustering_tpu_torch.ops.screening import "
            "ThresholdSeriesScreener\n"
            "c = np.random.default_rng(4).normal(size=(300, 2))"
            ".astype(np.float32)\n"
            "p = density.populations(c, [0.3], 8, 16, 'pallas', False, 'cpu')\n"
            "x = density.populations(c, [0.3], 8, 16, 'xla', True, 'cpu')\n"
            "assert (p[0.3] == x[0.3]).all()\n"
            "fe = density.free_energies(p[0.3])\n"
            "nn = neighbors.nearest_neighbors(c, fe, 8, 16, 'xla', True, "
            "'cpu')\n"
            "e = DensityEngine(c, 8, 16, 'auto', None, 'cpu')\n"
            "assert e.precompile_pops([0.3]) is None\n"
            "assert e.precompile_nn() is None\n"
            "e.populations([0.3], True, 0.3)\n"
            "assert e.band_sigma2_estimate() > 0\n"
            "s = ThresholdSeriesScreener(c, fe, [1.0], 8, 16, 'auto', None, "
            "None, 'cpu')\n"
            "assert s.precompile(np.float32(0.1)) is None\n"
            "got = screening_step(fe, nn[1], 1.0, c, None, device='cpu')\n"
            "assert (got == s.step(None, 0, np.float32(4 * nn[1].astype("
            "np.float64).mean()))).all()\n"
            "np.savetxt('coords.dat', c, fmt='%.5f')\n"
            "assert cli.main(['density', '-f', 'coords.dat', '-r', '0.3', "
            "'-o', 'c', '-T', '1.0']) == 0\n"
            "assert os.path.exists('trace/trace.json')\n"
            f"bad = {FOREIGN}\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    assert _python(code, tmp_path).splitlines()[-1] == "ok"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engines_raise_without_cuda(no_cuda):
    from clustering_tpu_torch.ops.engine import DensityEngine
    from clustering_tpu_torch.ops.screening import (ScreeningEngine,
                                                    ThresholdSeriesScreener)
    coords = np.zeros((20, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        DensityEngine(coords, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ScreeningEngine(coords, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ThresholdSeriesScreener(coords, np.zeros(20, np.float32), [0.5],
                                device="cuda")
    # the JAX package's surface: the default device is CUDA on every route
    from clustering_tpu_torch.models.density import screening_step
    from clustering_tpu_torch.ops import density, neighbors
    fe = np.zeros(20, np.float32)
    for call in (
            lambda: density.populations(coords, [0.1], backend="xla"),
            lambda: density.populations(coords, [0.1], prune=False),
            lambda: neighbors.nearest_neighbors(coords, fe, backend="xla"),
            lambda: screening_step(fe, np.ones(20, np.float32), 1.0, coords,
                                   None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_cli_density_raises_without_cuda(no_cuda, monkeypatch, tmp_path):
    from clustering_tpu_torch import cli
    np.savetxt(tmp_path / "c.dat", np.zeros((10, 2)), fmt="%.3f")
    monkeypatch.delenv(cli.DEVICE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["density", "-f", "c.dat", "-r", "0.1", "-p", "pop"])
    assert not (tmp_path / "pop").exists()
