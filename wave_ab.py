#!/usr/bin/env python3
"""The wave order against the given order of the row-side NN and
label-min kernels, on their calls of the 2^20 symmetric path (N = 2^20,
D = 4), on one NVIDIA GPU.

    python3 wave_ab.py [--out build/wave_ab.json]

The calls of ``nn_sparse`` and ``label_min_sparse`` are recorded on the
engines' symmetric route (``chip_smoke.py`` phase 6's run, after one
untimed run), then:

  1. each kernel's calls replayed with their tile lists run in the given
     (row-major) order -- ``kernels.wave_order`` replaced by the identity
     -- and in the wave order the wrappers apply, in the order given,
     waves, waves, given: kernel time summed over the calls (CUDA events,
     the wrapper's sort included); outputs must be identical;
  2. ``label_min_sparse``'s calls once more in each order through a build
     of ``label_min_sparse.cu`` with ``-DCK_STEP_STATS``: of the thread
     steps (MT_RM x MT_RN = 16 pairs each) the kernel saw, the share whose
     distances its skip left out, the share left out by the whole warp
     (only those save time), and the share of adjacent pairs among the
     evaluated ones, per call and in all.

Prints one JSON line and writes it to ``--out``.
"""

import argparse
import contextlib
import ctypes
import json
import os

import chip_smoke as cs
import kernel_ab as ab

NAMES = ("nn_sparse", "label_min_sparse")
ORDER = ("given", "waves", "waves", "given")


@contextlib.contextmanager
def list_order(order):
    """Run the row-side kernels' lists in ``order``: "waves" (as the
    wrappers do) or "given" (``kernels.wave_order`` is the identity)."""
    import torch
    from clustering_tpu_torch.ops import kernels
    saved = kernels.wave_order
    if order == "given":
        kernels.wave_order = lambda ti, *a: torch.arange(ti.shape[0],
                                                         device=ti.device)
    try:
        yield
    finally:
        kernels.wave_order = saved


def step_stats(torch, calls):
    """{order: thread steps seen and skipped} of the label_min_sparse
    calls through a -DCK_STEP_STATS build of the current source."""
    from clustering_tpu_torch.ops import _build, kernels
    lib = ab.build_old(_build.CSRC_DIR, ("label_min_sparse",),
                       ("-DCK_STEP_STATS",))
    read = lib.ck_label_min_sparse_step_stats
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * 4)()
    switch = ab.Switch(_build.library(), lib, ("label_min_sparse",))
    switch.use = "old"
    saved = _build.library
    _build.library = lambda: switch
    out = {}
    try:
        for order in ("given", "waves"):
            if read(counts) != 0:  # zero the counters
                cs.fail("ck_label_min_sparse_step_stats failed")
            per_call = []
            with list_order(order):
                for args, kw in calls:
                    kernels.label_min_sparse(*args, **kw)
                    torch.cuda.synchronize()
                    if read(counts) != 0:
                        cs.fail("ck_label_min_sparse_step_stats failed")
                    per_call.append(list(counts))
            seen, skipped, warp, adj = (sum(c[i] for c in per_call)
                                        for i in range(4))
            shares = {"skipped": skipped / max(seen, 1),
                      "warp_skipped": warp / max(seen, 1),
                      "adjacent": adj / max(16 * (seen - skipped), 1)}
            out[order] = {"seen": seen, "skipped": skipped,
                          "warp_skipped": warp, "adjacent_pairs": adj,
                          "shares": shares, "per_call": per_call}
            print(f"[wave ab] label_min_sparse, {order} order: {seen} thread"
                  " steps; shares " + json.dumps(shares) + "; skipped,"
                  " warp-skipped per call " + ", ".join(
                      f"{c[1] / max(c[0], 1):.3f}/{c[2] / max(c[0], 1):.3f}"
                      for c in per_call))
    finally:
        _build.library = saved
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/wave_ab.json")
    args = ap.parse_args()
    torch, smi = cs.phase_device()
    cs.phase_build()
    from clustering_tpu_torch.ops import kernels
    coords = cs.synthetic_fel(cs.N_MAIN, cs.DIM, seed=0)
    with cs.bidir_switches(False):
        cs.run_engines(torch, coords)  # untimed: context, loads, allocator
        with cs.record_calls(NAMES) as calls:
            *_, walls, modes = cs.run_engines(torch, coords)
    if set(modes.values()) != {"symmetric"}:
        cs.fail(f"the symmetric run took another route: {modes}")
    print(f"[wave ab] {smi}; symmetric run N={cs.N_MAIN} D={cs.DIM}: stages "
          + json.dumps(walls))
    result = {"device": smi, "n": cs.N_MAIN, "d": cs.DIM, "walls": walls,
              "kernels": {}}
    for name in NAMES:
        fn = getattr(kernels, name)
        cs.replay(torch, name, fn, calls[name])  # warm-up
        outs, times = {}, []
        for order in ORDER:
            per_call = []
            with list_order(order):
                out, ms = cs.replay(torch, name, fn, calls[name], per_call)
            outs.setdefault(order, out)
            times.append({"order": order, "ms": ms, "per_call": per_call})
        bad, _ = cs.compare_outputs(torch, outs["waves"], outs["given"])
        if bad:
            cs.fail(f"{name}: the two orders differ in {bad} elements")
        pairs = sum(cs.evaluated_pairs(name, a) for a, _ in calls[name])
        bound = pairs * 3 * cs.DIM / cs.PEAK_FLOPS * 1e3
        result["kernels"][name] = {
            "calls": len(calls[name]), "pairs": pairs, "bound_ms": bound,
            "pairs_per_call": [cs.evaluated_pairs(name, a)
                               for a, _ in calls[name]], "times": times}
        print(f"[wave ab] {name}: {len(calls[name])} calls, {pairs} pairs,"
              f" bound {bound:.3f} ms, ms " + ", ".join(
                  f"{t['order']} {t['ms']:.3f} (share {bound / t['ms']:.3f})"
                  for t in times) + "; outputs identical; per call (waves)"
              " ms/Mpairs " + ", ".join(
                  f"{t:.3f}/{p / 1e6:.0f}" for t, p in
                  zip(times[1]["per_call"],
                      result["kernels"][name]["pairs_per_call"])))
    result["label_min_sparse_steps"] = step_stats(
        torch, calls["label_min_sparse"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
