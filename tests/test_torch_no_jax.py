"""The PyTorch port never imports jax, and never falls back to the CPU
when CUDA is asked for."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "clustering_tpu_torch"


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


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "clustering_tpu_torch.ops.kernels" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import clustering_tpu_torch as p\n"
            "p.populations, p.screening_series\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_sources_never_import_jax():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or "clustering_tpu.ops" in s
                        or "clustering_tpu.parallel" in s
                        or "clustering_tpu.models.density" in s), \
                f"{path}: {line}"


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


def test_cli_density_raises_without_cuda(no_cuda, monkeypatch, tmp_path):
    from clustering_tpu_torch import cli
    np.savetxt(tmp_path / "c.dat", np.zeros((10, 2)), fmt="%.3f")
    monkeypatch.delenv(cli.DEVICE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["density", "-f", "c.dat", "-r", "0.1", "-p", "pop"])
    assert not (tmp_path / "pop").exists()
