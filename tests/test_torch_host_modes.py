"""The port's six host modes against the JAX package's, through both CLIs.

Each mode runs through ``clustering_tpu.cli.main`` and
``clustering_tpu_torch.cli.main`` in two directories that hold the same
inputs: the density artifacts of ``tests/golden/`` and seeded coordinate
files (ASCII, and an .xtc of 12 atoms a frame, which takes the compressed
3dfcoord branch). Every file a mode writes must be byte-equal between the
two after ``make_golden.strip_volatile`` (binary .xtc files as they are),
and so must what ``stats`` prints. The xtc codecs are also held against
each other: the same frames written by both writers, each file read by
the other package's reader.
"""

import os
import pathlib
import shutil

import numpy as np
import pytest

import make_golden
from clustering_tpu import cli as jcli
from clustering_tpu.utils import xtc as jxtc
from clustering_tpu_torch import cli as tcli
from clustering_tpu_torch.utils import xtc as txtc

N_ATOMS = 12

MODES = {
    "network": ["network", "-p", "1", "-b", "clust", "-o", "network",
                "--min", "0.3", "--step", "0.3"],
    "mpp": ["mpp", "-s", "microstates", "-D", "fe", "-l", "2",
            "--qmin-from", "0.2", "--qmin-to", "0.6", "--qmin-step", "0.4"],
    "coring": ["coring", "-s", "microstates", "-w", "2", "-o", "cored",
               "-d", "wtd", "--cores", "cores.dat"],
    "coring_iterative": ["coring", "-s", "microstates", "-w", "3", "-o",
                         "cored", "-d", "wtd", "--cores", "cores.dat",
                         "--iterative"],
    "noise": ["noise", "-s", "microstates", "-o", "denoised", "-b", "clust",
              "-c", "10"],
    "filter": ["filter", "-s", "clust.1.20", "-c", "coords.dat", "-o", "sel",
               "-S", "1", "2", "--every-nth", "2"],
    "filter_xtc": ["filter", "-s", "clust.1.20", "-c", "traj.xtc", "-S", "1",
                   "3"],
    "stats": ["stats", "-s", "microstates"],
}


def _frames(n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 1.5, size=(n, N_ATOMS, 3)).astype(np.float32)


def _inputs(where):
    """The golden density artifacts plus seeded coordinates, in ``where``."""
    where.mkdir()
    for name in ("pop", "fe", "nn", "microstates", "clust.0.30",
                 "clust.0.60", "clust.0.90", "clust.1.20"):
        shutil.copy(os.path.join(make_golden.GOLDEN, name), where / name)
    n = len(np.loadtxt(where / "microstates"))
    frames = _frames(n)
    np.savetxt(where / "coords.dat", frames[:, :2, 0], fmt="%.6f")
    w = jxtc.XtcWriter(str(where / "traj.xtc"))
    for i, f in enumerate(frames):
        w.write_frame(f, step=i, time=0.5 * i)
    w.close()
    return sorted(p.name for p in where.iterdir())


def _run(main, argv, where, monkeypatch, capsys):
    monkeypatch.chdir(where)
    capsys.readouterr()
    assert main(list(argv)) == 0, argv
    return capsys.readouterr().out


def _content(path):
    if path.suffix == ".xtc":
        return path.read_bytes()
    return make_golden.strip_volatile(str(path))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_host_mode_matches_jax_cli(mode, tmp_path, monkeypatch, capsys):
    inputs = _inputs(tmp_path / "jax")
    _inputs(tmp_path / "port")
    out_j = _run(jcli.main, MODES[mode], tmp_path / "jax", monkeypatch,
                 capsys)
    out_t = _run(tcli.main, MODES[mode], tmp_path / "port", monkeypatch,
                 capsys)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    written = [n for n in names if n not in inputs]
    if mode == "stats":
        assert out_t == out_j and "total number of microstates" in out_t
    else:
        assert written, f"{mode} wrote no file"
    for name in written:
        got = _content(tmp_path / "port" / name)
        want = _content(tmp_path / "jax" / name)
        assert got == want, name


def test_xtc_round_trip_between_packages(tmp_path):
    frames = _frames(40, seed=9)
    frames[3, :9] = 0.0  # a run of equal atoms: the run-length branch
    paths = {}
    for tag, mod in (("jax", jxtc), ("port", txtc)):
        paths[tag] = str(tmp_path / f"{tag}.xtc")
        w = mod.XtcWriter(paths[tag])
        for i, f in enumerate(frames):
            w.write_frame(f, step=i, time=0.25 * i, precision=1000.0)
        w.close()
    assert (pathlib.Path(paths["jax"]).read_bytes()
            == pathlib.Path(paths["port"]).read_bytes())
    for reader, path in ((txtc.XtcReader, paths["jax"]),
                         (jxtc.XtcReader, paths["port"])):
        r = reader(path)
        got = []
        while (fr := r.read_frame()) is not None:
            got.append((fr.step, fr.time, fr.coords))
        r.close()
        assert [g[0] for g in got] == list(range(len(frames)))
        np.testing.assert_array_equal([g[1] for g in got],
                                      np.float32(0.25) * np.arange(40))
        # 3dfcoord quantises to 1/precision
        np.testing.assert_allclose(np.stack([g[2] for g in got]), frames,
                                   rtol=0, atol=0.5e-3 + 1e-6)
