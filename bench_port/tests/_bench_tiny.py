"""Shared helpers of the benchmark's tests: tiny cells on the CPU."""

import json
import os
import shutil

from bench_port import spec as specs

TINY = {"name": "tiny", "source": "test", "n_frames": 3000, "dim": 4,
        "radius": 0.1, "precision": "float32", "reference": "density",
        "sample_frames": 200}


def tiny_cell(monkeypatch, traffic="cli-t4", n_frames=3000):
    """A cell of the tiny configuration under ``traffic``, its config
    served in place of the files' (the CLI on the CPU)."""
    monkeypatch.setenv("CLUSTERING_TORCH_DEVICE", "cpu")
    cfg = dict(TINY, n_frames=n_frames)
    real = specs.config
    monkeypatch.setattr(specs, "config",
                        lambda name, *a: cfg if name == "tiny"
                        else real(name, *a))
    return {"name": "tiny", "config": "tiny", "traffic": traffic,
            "chips": 1}


def copy_benchmark(dst):
    """A checkout-like copy of ``BENCHMARK.json`` and ``bench_port/`` in
    ``dst``, with the program linked beside it."""
    shutil.copy(os.path.join(specs.ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(specs.HERE, os.path.join(dst, "bench_port"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(specs.ROOT, "clustering_tpu_torch"),
               os.path.join(dst, "clustering_tpu_torch"))
    with open(os.path.join(dst, "BENCHMARK.json")) as fh:
        return json.load(fh)
