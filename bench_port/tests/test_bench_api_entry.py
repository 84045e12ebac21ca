"""The library entry's jobs: their inputs, spans and outputs at tiny N."""

import numpy as np

from bench_port import run as runs
from bench_port.checks import density
from bench_port.entries import api

from _bench_tiny import tiny_cell


def test_jobs_permute_and_undo(monkeypatch):
    cell = tiny_cell(monkeypatch, "api-t20", n_frames=1200)
    run = runs.make_run(cell, 3, 0, device="cpu")
    calls = []
    real = api._perm
    monkeypatch.setattr(api, "_perm",
                        lambda r, k: calls.append(real(r, k)) or calls[-1])
    a, b = api.job(run, 0), api.job(run, 1)
    assert not np.array_equal(calls[0], calls[1])
    assert set(a["spans"]) == set(api.SPANS)
    assert abs(sum(a["spans"].values()) - a["wall"]) < 0.05 * a["wall"] + 1e-3
    assert a["measured"] == {
        "populations": a["spans"]["populations"]
        + a["spans"]["free_energies"],
        "nearest_neighbors": a["spans"]["nearest_neighbors"],
        "screening": a["spans"]["screening_series"]}
    # populations and distances do not depend on the input's order
    for key in ("pops", "fe", "nh_d2", "hd_d2"):
        assert np.array_equal(a["out"][key], b["out"][key]), key
    assert np.array_equal(a["out"]["rank"][calls[0]], np.arange(1200))
    # the outputs, in the original order, are the reference's
    ref = density.Reference(run, a["out"])
    for rec in (a, b):
        got = density.compare(rec["out"], ref, api.thresholds(run),
                          rank=rec["out"]["rank"])
        assert got["pops_wrong"] == got["nn_wrong"] == 0
        assert got["clust_wrong"] == got["clust_split"] == 0
        assert got["clust_joined"] == 0
        assert got["fe_gap"] < 1e-6 and got["nn_d2_gap"] == 0
