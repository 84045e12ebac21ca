"""The port's package-level API against the JAX package's.

Every name the JAX package serves (``clustering_tpu._API_NAMES``) resolves
in ``clustering_tpu_torch`` too, and comes from the port's own modules. The host functions
(``fill_landscape``, ``mpp_lump``, ``core_trajectory``, ``assign_noise``,
``waiting_time_distribution``) give outputs equal to the JAX package's on
the same seeded inputs: the density artifacts of a two-blob data set,
computed once by the JAX package.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import clustering_tpu as ct
import clustering_tpu_torch as ctt
from clustering_tpu_torch.ops import density as tdensity
from clustering_tpu_torch.ops import neighbors as tneighbors
from clustering_tpu_torch.ops import screening as tscreening

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMES = list(ct._API_NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_api_name_resolves_in_both_packages(name):
    assert getattr(ct, name) is not None
    got = getattr(ctt, name)
    home = getattr(got, "__module__", None) or got.__name__
    assert home.split(".")[0] == "clustering_tpu_torch", home
    assert name in dir(ctt)


def test_api_names_equal_the_jax_packages():
    assert set(ct._API_NAMES) == set(ctt._API_NAMES)
    assert ctt.parallel.sharded.populations.__module__ == (
        "clustering_tpu_torch.parallel.sharded")
    with pytest.raises(AttributeError):
        ctt.no_such_name  # noqa: B018


@pytest.mark.parametrize("name,module", [
    ("populations", tdensity), ("free_energies", tdensity),
    ("nearest_neighbors", tneighbors), ("screening_labels", tscreening)])
def test_ops_reexports_are_the_ports_own(name, module):
    assert getattr(ctt.ops, name) is getattr(module, name)


def test_package_import_for_a_host_mode_loads_no_torch():
    """The API loads lazily: the package, its host models and utils load
    neither torch nor a kernel."""
    code = ("import sys\n"
            "import clustering_tpu_torch as p\n"
            "dir(p), p.models, p.utils\n"
            "from clustering_tpu_torch.models import coring, mpp, noise\n"
            "assert 'torch' not in sys.modules\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.fixture(scope="module")
def landscape():
    """(clusterings, neighbourhoods, fe) of two seeded gaussian blobs,
    through the JAX package on the CPU."""
    rng = np.random.default_rng(11)
    a = rng.normal((0.0, 0.0), 0.12, size=(150, 2))
    b = rng.normal((1.3, 0.2), 0.15, size=(110, 2))
    coords = np.concatenate([a, b]).astype(np.float32)
    coords = coords[rng.permutation(len(coords))]
    fe = ct.free_energies(ct.populations(coords, 0.2))
    nn = ct.nearest_neighbors(coords, fe)
    series = ct.screening_series(coords, fe, nn.nh_dist,
                                 thresholds=[0.5, 1.0, 2.0])
    return series, nn, fe


def _micro(pkg, landscape):
    series, nn, fe = landscape
    return pkg.fill_landscape(series[-1], nn, fe)


# each case: pkg, landscape -> a tuple of outputs (arrays, lists, dicts)
HOST_CASES = {
    "fill_landscape": lambda pkg, ls: (_micro(pkg, ls),),
    "mpp_lump": lambda pkg, ls: tuple(pkg.mpp_lump(
        _micro(pkg, ls), ls[2], lagtime=2, qmin_values=[0.3, 0.6, 0.9])),
    "mpp_lump_default_qmin_concat": lambda pkg, ls: tuple(pkg.mpp_lump(
        _micro(pkg, ls), ls[2], lagtime=1, concat_limits=[100, 260])),
    "core_trajectory_int": lambda pkg, ls: pkg.core_trajectory(
        _micro(pkg, ls), windows=2),
    "core_trajectory_dict": lambda pkg, ls: pkg.core_trajectory(
        _micro(pkg, ls), windows={1: 3, 2: 1}, concat_limits=[130, 260]),
    "core_trajectory_iterative": lambda pkg, ls: pkg.core_trajectory(
        _micro(pkg, ls), windows=3, iterative=True),
    "assign_noise": lambda pkg, ls: (pkg.assign_noise(
        _micro(pkg, ls), ls[0][-1], cmin=5.0),),
    "assign_noise_concat": lambda pkg, ls: (pkg.assign_noise(
        _micro(pkg, ls), ls[0][1], cmin=20.0, concat_limits=[90, 260]),),
    "waiting_time_distribution": lambda pkg, ls: tuple(
        pkg.waiting_time_distribution(_micro(pkg, ls), s) for s in (1, 2)),
    "waiting_time_distribution_empty": lambda pkg, ls: (
        pkg.waiting_time_distribution([], 1),),
}


def _assert_same(got, want):
    if isinstance(want, dict):
        assert got == want
    elif isinstance(want, (list, tuple)) and not np.isscalar(want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_functions_match_jax(case, landscape):
    want = HOST_CASES[case](ct, landscape)
    got = HOST_CASES[case](ctt, landscape)
    _assert_same(got, want)
    if case == "fill_landscape":
        assert (got[0] > 0).all() and len(np.unique(got[0])) > 1
    if case.startswith("mpp_lump"):
        assert type(ctt.mpp_lump(_micro(ctt, landscape), landscape[2], 2,
                                 [0.5])).__name__ == "MppResult"
