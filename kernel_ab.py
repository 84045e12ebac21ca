#!/usr/bin/env python3
"""A/B of two versions of some of the port's kernels on one NVIDIA GPU, on
the calls of their 2^20 paths (N = 2^20, D = 4).

    python3 kernel_ab.py --old OLD_CSRC [--kernels pops_bidir,pops_tiles]
                         [--out build/kernel_ab.json]

OLD_CSRC is a ``csrc`` directory of another version of
``clustering_tpu_torch`` (the named kernels' ``<name>.cu`` and their
``common.cuh``), for example the parent commit's, unpacked with
``git archive`` into a directory that .gitignore lists. ``--kernels``
names any of the eight kernels (``chip_smoke.KERNELS``); the old version's
named kernels are built with nvcc into a library of their own, and every
other kernel comes from the current sources. In one process, in the order
old, new, new, old:

  1. the engines' pipeline of ``chip_smoke.py`` phase 6 (populations, NN,
     screening set-up and four screening steps) on the bidirectional
     route, the skip-word route of phase 7 (populations and the two-pass
     NN through ``pops_tiles`` / ``nn_tiles``) and, when a row-side kernel
     (``pops_sparse``, ``nn_sparse``, ``label_min_sparse``) is named, the
     engines once more on the symmetric route (the three bidirectional
     switches off), each held against the first, with the stage walls on
     the host clock, after one untimed warm-up run; every run must give
     identical populations, nn ids, nn distances (bit for bit) and
     clusterings;
  2. the recorded calls of the named kernels from the first run replayed
     through each version, kernel time summed over the calls (CUDA
     events); outputs must be identical between the versions.

Prints one JSON line and writes it to ``--out``.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess

import numpy as np

import chip_smoke as cs

ORDER = ("old", "new", "new", "old")


def build_old(csrc, names, flags=()):
    """nvcc the old version's named kernels (with the extra nvcc ``flags``)
    into one library; returns it."""
    from clustering_tpu_torch.ops import _build
    srcs = [os.path.join(csrc, f"{k}.cu") for k in names]
    h = hashlib.sha256(" ".join(flags).encode())
    for p in srcs + [os.path.join(csrc, "common.cuh")]:
        with open(p, "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libold_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        subprocess.run([_build._nvcc()] + _build.ARCH_FLAGS
                       + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                          "-shared", "-I", csrc, "-o", lib] + list(flags)
                       + srcs,
                       check=True)
    old = ctypes.CDLL(lib)
    for name in names:
        fn = getattr(old, "ck_" + name)
        fn.argtypes = _build.SIGNATURES["ck_" + name]
        fn.restype = ctypes.c_int
    return old


class Switch:
    """Stands in for the kernel library: the named kernels' entry points
    from the chosen version, every other one from the current build."""

    def __init__(self, new, old, names):
        self.libs = {"new": new, "old": old}
        self.names = names
        self.use = "new"

    def __getattr__(self, name):
        version = self.use if name[3:] in self.names else "new"
        return getattr(self.libs[version], name)


def same_results(a, b):
    pops_a, nn_a, clust_a = a
    pops_b, nn_b, clust_b = b
    if not np.array_equal(pops_a, pops_b):
        return False
    for i in (0, 2):
        if not np.array_equal(nn_a[i], nn_b[i]):
            return False
    for i in (1, 3):
        if not np.array_equal(np.asarray(nn_a[i], np.float32).view(np.int32),
                              np.asarray(nn_b[i], np.float32).view(np.int32)):
            return False
    return all(np.array_equal(x, y) for x, y in zip(clust_a, clust_b))


def run_paths(torch, coords, symmetric):
    """The engines' pipeline, then the skip-word route and, if
    ``symmetric``, the engines' symmetric route, each held against it.
    Returns ((pops, nn, clusterings), {route: stage walls})."""
    pops, nn, clust, walls, _ = cs.run_engines(torch, coords)
    _, skip_walls = cs.phase_skip_words(torch, pops, nn)
    routes = {"bidir": walls, "skip_words": skip_walls}
    if symmetric:
        with cs.bidir_switches(False):
            *sym, sym_walls, modes = cs.run_engines(torch, coords)
        if set(modes.values()) != {"symmetric"}:
            cs.fail(f"the symmetric run took another route: {modes}")
        if not same_results((pops, nn, clust), sym):
            cs.fail("the symmetric run's results differ from the"
                    " bidirectional run's")
        routes["symmetric"] = sym_walls
    return (pops, nn, clust), routes


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="the old csrc directory")
    ap.add_argument("--kernels", default="pops_bidir,pops_tiles",
                    help="comma-separated kernel names")
    ap.add_argument("--out", default="build/kernel_ab.json")
    args = ap.parse_args()
    names = tuple(args.kernels.split(","))
    unknown = [k for k in names if k not in cs.KERNELS]
    if unknown:
        ap.error(f"unknown kernels {unknown}; choose from {list(cs.KERNELS)}")
    torch, smi = cs.phase_device()
    cs.phase_build()
    from clustering_tpu_torch.ops import _build, kernels
    switch = Switch(_build.library(), build_old(args.old, names), names)
    _build.library = lambda: switch
    coords = cs.synthetic_fel(cs.N_MAIN, cs.DIM, seed=0)
    symmetric = any(k in cs.SPARSE_KERNELS for k in names)

    # one untimed run first: the CUDA context, the library loads and the
    # allocator's first growth stay out of the walls
    run_paths(torch, coords, symmetric)
    walls, calls, first = [], None, None
    for version in ORDER:
        switch.use = version
        with cs.record_calls(names) as rec:
            results, routes = run_paths(torch, coords, symmetric)
        walls.append({"version": version, **routes,
                      "calls": {k: len(rec[k]) for k in names}})
        print(f"[ab] {version}: " + ", ".join(
            f"{route} {json.dumps(w)}" for route, w in routes.items()))
        if first is None:
            first, calls = results, rec
        elif not same_results(first, results):
            cs.fail(f"the {version} run's results differ from the first")

    replays = {}
    for name in names:
        if not calls[name]:
            cs.fail(f"{name}: no call recorded on the engines' or the"
                    " skip-word route")
        fn = getattr(kernels, cs.WRAPPERS[name])
        outs, times = {}, []
        for version in ORDER:
            switch.use = version
            out, ms = cs.replay(torch, name, fn, calls[name])
            outs.setdefault(version, out)
            times.append({"version": version, "ms": ms})
        bad, _ = cs.compare_outputs(torch, outs["new"], outs["old"])
        if bad:
            cs.fail(f"{name}: old and new differ in {bad} elements")
        pairs = sum(cs.evaluated_pairs(name, a) for a, _ in calls[name])
        bound = pairs * 3 * cs.DIM / cs.PEAK_FLOPS * 1e3
        replays[name] = {"calls": len(calls[name]), "pairs": pairs,
                         "bound_ms": bound, "times": times}
        print(f"[ab] {name}: {len(calls[name])} calls, {pairs} pairs, bound"
              f" {bound:.3f} ms, ms " + ", ".join(
                  f"{t['version']} {t['ms']:.3f} (share"
                  f" {bound / t['ms']:.3f})" for t in times))
    result = {"device": smi, "n": cs.N_MAIN, "d": cs.DIM,
              "kernels_ab": list(names), "walls": walls, "kernels": replays}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
