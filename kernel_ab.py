#!/usr/bin/env python3
"""A/B of two versions of the bidirectional NN and label-min kernels on one
NVIDIA GPU, on the calls of the density main path at N = 2^20, D = 4.

    python3 kernel_ab.py --old OLD_CSRC [--out build/kernel_ab.json]

OLD_CSRC is a ``csrc`` directory of another version of
``clustering_tpu_torch`` (``nn_bidir.cu``, ``label_min_bidir.cu`` and
their ``common.cuh``), for example the parent commit's, unpacked with
``git archive`` into a directory that .gitignore lists. Its two kernels are
built with nvcc into a library of their own; every other kernel comes from
the current sources. In one process, in the order old, new, new, old:

  1. the engines' pipeline of ``chip_smoke.py`` phase 6 (populations, NN,
     screening set-up and four screening steps), with the stage walls on
     the host clock, after one untimed warm-up run; every run must give
     identical populations, nn ids, nn distances (bit for bit) and
     clusterings;
  2. the recorded ``nn_bidir`` and ``label_min_bidir`` calls of the first
     run replayed through each version, kernel time summed over the calls
     (CUDA events); outputs must be identical between the versions.

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

AB_KERNELS = ("nn_bidir", "label_min_bidir")
ORDER = ("old", "new", "new", "old")


def build_old(csrc):
    """nvcc the old version's two kernels into one library; returns it."""
    from clustering_tpu_torch.ops import _build
    srcs = [os.path.join(csrc, f"{k}.cu") for k in AB_KERNELS]
    h = hashlib.sha256()
    for p in srcs + [os.path.join(csrc, "common.cuh")]:
        with open(p, "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libold_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        subprocess.run([_build._nvcc()] + _build.ARCH_FLAGS
                       + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                          "-shared", "-I", csrc, "-o", lib] + srcs,
                       check=True)
    old = ctypes.CDLL(lib)
    for name in AB_KERNELS:
        fn = getattr(old, "ck_" + name)
        fn.argtypes = _build.SIGNATURES["ck_" + name]
        fn.restype = ctypes.c_int
    return old


class Switch:
    """Stands in for the kernel library: the two A/B entry points from the
    chosen version, every other one from the current build."""

    def __init__(self, new, old):
        self.libs = {"new": new, "old": old}
        self.use = "new"

    def __getattr__(self, name):
        if name[3:] in AB_KERNELS:
            return getattr(self.libs[self.use], name)
        return getattr(self.libs["new"], name)


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="the old csrc directory")
    ap.add_argument("--out", default="build/kernel_ab.json")
    args = ap.parse_args()
    torch, smi = cs.phase_device()
    cs.phase_build()
    from clustering_tpu_torch.ops import _build, kernels
    switch = Switch(_build.library(), build_old(args.old))
    _build.library = lambda: switch
    coords = cs.synthetic_fel(cs.N_MAIN, cs.DIM, seed=0)

    # one untimed run first: the CUDA context, the library loads and the
    # allocator's first growth stay out of the walls
    cs.run_engines(torch, coords)
    walls, calls, first = [], None, None
    for version in ORDER:
        switch.use = version
        kernels.reset_launches()
        with cs.record_calls(AB_KERNELS) as rec:
            pops, nn, clust, w, _ = cs.run_engines(torch, coords)
        walls.append({"version": version, "stages": w,
                      "launches": {k: kernels.LAUNCHES[k]
                                   for k in AB_KERNELS}})
        print(f"[ab] {version}: stages {json.dumps(w)}")
        if first is None:
            first, calls = (pops, nn, clust), rec
        elif not same_results(first, (pops, nn, clust)):
            cs.fail(f"the {version} run's results differ from the first")

    replays = {}
    for name in AB_KERNELS:
        fn = getattr(kernels, name)
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
                  f"{t['version']} {t['ms']:.3f}" for t in times))
    result = {"device": smi, "n": cs.N_MAIN, "d": cs.DIM, "walls": walls,
              "kernels": replays}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
