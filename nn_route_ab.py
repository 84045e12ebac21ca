#!/usr/bin/env python3
"""Before/after A/B of the density pipeline on one NVIDIA GPU: this
checkout against another (``--old``, for example the parent commit
unpacked with ``git archive`` into a directory that .gitignore lists),
each run in a process of its own, in the order old, new, new, old:

  cli: the density CLI at N = 2^20, D = 4 (``chip_smoke.py`` phase 5's
     argv and data) with ``CLUSTERING_TPU_PROFILE_SUBSTAGES`` set: its
     process wall, stage walls and sub-stage times; every run must write
     the same pop, nn and clust.* files (but for the time stamp);
  engines, big: the engines' pipeline at N = 2^20, and 2^24 (each
     checkout's own ``chip_smoke.run_engines``, after an untimed run in
     the same process, so that neither the CUDA context nor the kernels'
     first loads fall in it): stage walls, populations' and NN's
     sub-stage times, NN's phase-2 mode and tiles; every run must give
     the same populations, neighbours and clusterings.

    python3 nn_route_ab.py --old build/parent [--parts cli,engines,big]
                           [--out FILE]

The old checkout reuses this one's kernel library when its sources are
the same (``build/torch_kernels`` is linked into it). Prints one JSON
line per run, then the summary, which ``--out`` also receives.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
ORDER = ("old", "new", "new", "old")
WALL = re.compile(r"\[([a-z .0-9]+): ([0-9.]+)s\]")
SUBSTAGES = re.compile(r"\[(\w+) substages: ([^\]]*)\]")
TIMEOUT = 900

# the engines at N = argv[1], an untimed run then a timed one, with the
# checkout on sys.path
ENGINES = r"""
import hashlib, json, sys
import numpy as np
import torch
import chip_smoke as cs
coords = cs.synthetic_fel(int(sys.argv[1]), cs.DIM, seed=0)
cs.run_engines(torch, coords)
stats, keep = {}, {}
pops, nn, clust, walls, _ = cs.run_engines(torch, coords, stats, keep)
digest = hashlib.sha256()
for a in (pops, *nn, *clust):
    digest.update(np.ascontiguousarray(a).tobytes())
pick = ("mode", "band_prefetched", "band_tiles", "phase2_tiles", "t_band",
        "t_plan", "t_sweep", "t_best_sort")
print("RESULT " + json.dumps({
    "walls": walls, "screener_build": keep.get("screener_build"),
    "populations": {k: v for k, v in stats["populations"].items()
                    if k in pick},
    "nn": {k: v for k, v in stats["nearest neighbors"].items() if k in pick},
    "digest": digest.hexdigest()}))
"""


def run(root, args, cwd, extra_env=()):
    """(stdout, seconds) of ``python args`` with ``root`` on the path."""
    env = dict(os.environ, PYTHONPATH=root, **dict(extra_env))
    env.pop("CLUSTERING_TORCH_DEVICE", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        cs.fail(f"{args[:2]} in {root} exited {proc.returncode}:\n"
                f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, wall


def files(d):
    """{name: data lines} of a CLI run's pop, nn and clust.* files."""
    out = {}
    for name in ["pop", "nn"] + [f"clust.{t}" for t in cs.THRESHOLDS]:
        with open(os.path.join(d, name), "rb") as fh:
            out[name] = [ln for ln in fh.read().splitlines()
                         if not ln.startswith(b"# Created ")]
    return out


def cli_ab(roots, tmp):
    coords_path = os.path.join(tmp, "coords.dat")
    np.savetxt(coords_path, cs.synthetic_fel(cs.N_MAIN, cs.DIM, seed=0),
               fmt="%.6f")
    runs, first = [], None
    for i, which in enumerate(ORDER):
        d = os.path.join(tmp, f"cli{i}_{which}")
        os.makedirs(d)
        os.link(coords_path, os.path.join(d, "coords.dat"))
        out, wall = run(roots[which], ["-m", "clustering_tpu_torch"]
                        + cs.ARGV, d, {cs.SUBSTAGES_ENV: "1"})
        got = files(d)
        if first is None:
            first = got
        elif got != first:
            cs.fail(f"CLI run {i} ({which}) wrote other files")
        rec = {"run": i, "version": which, "what": f"CLI N={cs.N_MAIN}",
               "process": wall,
               "walls": {m.group(1): float(m.group(2))
                         for m in WALL.finditer(out)},
               "substages": dict(SUBSTAGES.findall(out)),
               "nn_line": re.findall(r"\[nn: [^\]]*\]", out),
               "screener": re.findall(r"\[screener built[^\]]*\]", out)}
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    return runs


def engines_ab(roots, tmp, n):
    runs, digest = [], None
    for i, which in enumerate(ORDER):
        out, wall = run(roots[which], ["-c", ENGINES, str(n)], tmp)
        rec = json.loads(out.split("RESULT ", 1)[1].splitlines()[0])
        if digest is None:
            digest = rec["digest"]
        elif rec["digest"] != digest:
            cs.fail(f"engines run {i} ({which}) gave other results")
        rec.update(run=i, version=which, what=f"engines N={n}",
                   process=wall)
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    return runs


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", required=True,
                   help="root of the other checkout (old)")
    p.add_argument("--parts", default="cli,engines",
                   help="comma-separated parts: cli, engines (2^20), big"
                        " (2^24, chip_smoke.N_BIG)")
    p.add_argument("--out", help="write the summary JSON here")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("[device]", smi)
    from clustering_tpu_torch.ops import _build
    _build.build()
    old = os.path.abspath(args.old)
    link = os.path.join(old, "build", "torch_kernels")
    if not os.path.exists(link):
        os.makedirs(os.path.dirname(link), exist_ok=True)
        os.symlink(_build.BUILD_DIR, link)
    roots = {"old": old, "new": ROOT}
    with tempfile.TemporaryDirectory() as tmp:
        parts = {"cli": lambda: cli_ab(roots, tmp),
                 "engines": lambda: engines_ab(roots, tmp, cs.N_MAIN),
                 "big": lambda: engines_ab(roots, tmp, cs.N_BIG)}
        summary = {"device": smi}
        for part in args.parts.split(","):
            summary[part] = parts[part]()
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)


if __name__ == "__main__":
    main()
