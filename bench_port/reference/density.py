"""Plain PyTorch reference of the density pipeline, for sampled frames.

For each sampled frame i it sweeps every frame j of the trajectory and
works out, from the coordinates alone:

- ``pop``: #{j : d2(i, j) <= r^2}, i itself included;
- ``nh``: the nearest frame, argmin d2 over {j : d2 > 0}, ties to the
  smallest j;
- ``hd``: the nearest frame of higher density, the same over
  {j : d2 > 0, pop_j > pop_i} (fe_j < fe_i: the free energy falls as the
  population rises, and distinct populations give distinct float32 free
  energies); ``col_pops`` gives pop_j.

``populations`` counts pop alone, for frames whose populations the
comparison takes from the program (the higher-density neighbours).

d2 is the float32 sum of squared float32 differences as a chain of fused
multiply-adds over the dimensions in order from 0, ``acc = fma(d_k, d_k,
acc)``: the arithmetic that the program states for its kernels. It is
computed here without relying on the device's fma: every difference,
square and sum is exact or correctly rounded in float64, and each float32
rounding goes through float64 rounded to odd (``_fma_chain``), which
rounds correctly to float32 because float64 carries more than 24 + 1
bits.

``control=True`` also sweeps the same frames with the coordinates and
the arithmetic in bfloat16, the precision below the configuration's
float32: the answers a program that computed in bfloat16 would give.
"""

import numpy as np
import torch

_INF = float("inf")
# the float32 chain over a few dimensions (a rounded difference, then one
# rounding per fused step) lies within about 4e-7 of the exact sum of
# squares, relative: only pairs this near r^2 need the chain
_NEAR = 1e-6


def radius2(radius):
    """r^2 as the configuration's float32 product."""
    return float(np.float32(radius) * np.float32(radius))


def _fma_chain(diffs):
    """float32 fma chain sum_k d_k^2 of float32 differences ``diffs`` (one
    tensor per dimension, any one shape), correctly rounded at each step."""
    acc = None
    for diff in diffs:
        d = diff.double()
        sq = d * d  # exact: 24-bit operands
        if acc is None:
            acc = sq.float()
            continue
        prev = acc.double()
        s = sq + prev
        # two-sum: s + err == sq + prev exactly
        b = s - sq
        err = (sq - (s - b)) + (prev - b)
        # round to odd: an inexact s whose last bit is even moves one
        # step towards the exact value (every sum here is >= 0)
        bits = s.view(torch.int64)
        step = torch.where(err > 0, 1, -1)
        bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
        acc = bits.view(torch.float64).float()
    return acc


def sq_dists(a, b):
    """(len(a), len(b)) float32 d2 between the rows of ``a`` and ``b``."""
    return _fma_chain([(a[:, k, None].double() - b[None, :, k].double())
                       .float() for k in range(a.shape[1])])


def pair_sq_dists(coords, i, j):
    """float32 d2 of the pairs (i[k], j[k])."""
    a, b = coords[i], coords[j]
    return _fma_chain([(a[:, k].double() - b[:, k].double()).float()
                       for k in range(coords.shape[1])])


def sq_dists_bf16(a, b):
    """The control's d2: coordinates, differences, squares and sums in
    bfloat16."""
    a, b = a.bfloat16(), b.bfloat16()
    acc = torch.zeros((len(a), len(b)), dtype=torch.bfloat16,
                      device=a.device)
    for k in range(a.shape[1]):
        d = a[:, k, None] - b[None, :, k]
        acc = acc + d * d
    return acc.float()


def _first_min(d2, col0, best, best_id):
    """Fold one block of candidate distances (inf = not admissible) into
    the running minimum and its smallest column."""
    mn = d2.amin(dim=1)
    cols = torch.arange(d2.shape[1], device=d2.device) + col0
    big = torch.iinfo(torch.int64).max
    idx = torch.where(d2 == mn[:, None], cols, big).amin(dim=1)
    better = mn < best
    return torch.where(better, mn, best), torch.where(better, idx, best_id)


def _fold(d2, rows, col0, col_pops, r2, acc):
    """One block's populations and nearest neighbours into ``acc``."""
    cols = torch.arange(d2.shape[1], device=d2.device) + col0
    acc["pop"] += (d2 <= r2).sum(dim=1)
    pos = torch.where(d2 > 0, d2, _INF)
    acc["nh_d2"], acc["nh_id"] = _first_min(pos, col0, acc["nh_d2"],
                                            acc["nh_id"])
    higher = col_pops[None, cols] > col_pops[rows][:, None]
    acc["hd_d2"], acc["hd_id"] = _first_min(torch.where(higher, pos, _INF),
                                            col0, acc["hd_d2"], acc["hd_id"])


def _empty(n_rows, device):
    return {"pop": torch.zeros(n_rows, dtype=torch.int64, device=device),
            "nh_d2": torch.full((n_rows,), _INF, device=device),
            "nh_id": torch.zeros(n_rows, dtype=torch.int64, device=device),
            "hd_d2": torch.full((n_rows,), _INF, device=device),
            "hd_id": torch.zeros(n_rows, dtype=torch.int64, device=device)}


def _host(acc):
    return {k: v.cpu().numpy() for k, v in acc.items()}


def sweep(coords, rows, radius, col_pops, control=False, row_block=64,
          col_block=1 << 20):
    """The reference's answers for the frames ``rows`` (int64 tensor) of
    ``coords`` ((N, D) float32 tensor), on their device: a dict of numpy
    arrays ``pop``, ``nh_d2``, ``nh_id``, ``hd_d2``, ``hd_id`` (d2 = inf
    where no frame is admissible); with ``control``, also ``control``:
    the same dict from the bfloat16 sweep."""
    device = coords.device
    col_pops = col_pops.to(device)
    r2 = radius2(radius)
    r2_low = float(torch.tensor(r2).bfloat16())
    parts = {"exact": [], "control": []}
    for lo in range(0, len(rows), row_block):
        part = rows[lo:lo + row_block]
        a = coords[part]
        exact = _empty(len(part), device)
        low = _empty(len(part), device)
        for col0 in range(0, coords.shape[0], col_block):
            b = coords[col0:col0 + col_block]
            _fold(sq_dists(a, b), part, col0, col_pops, r2, exact)
            if control:
                _fold(sq_dists_bf16(a, b), part, col0, col_pops, r2_low,
                      low)
        parts["exact"].append(exact)
        parts["control"].append(low)
    out = _host(_concat(parts["exact"]))
    if control:
        out["control"] = _host(_concat(parts["control"]))
    return out


def _concat(blocks):
    return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}


def populations(coords, rows, radius, row_block=256, col_block=1 << 20):
    """pop of the frames ``rows`` (int64 tensor), as a numpy array: the
    float64 sum of squares decides every pair farther than ``_NEAR`` from
    r^2 (relative), the float32 chain the others."""
    r2 = radius2(radius)
    pops = []
    for lo in range(0, len(rows), row_block):
        part = rows[lo:lo + row_block]
        a = coords[part].double()
        count = torch.zeros(len(part), dtype=torch.int64,
                            device=coords.device)
        for col0 in range(0, coords.shape[0], col_block):
            b = coords[col0:col0 + col_block].double()
            d2 = torch.zeros((len(a), len(b)), dtype=torch.float64,
                             device=coords.device)
            for k in range(a.shape[1]):
                d2 += (a[:, k, None] - b[None, :, k]) ** 2
            count += (d2 <= r2 * (1.0 - _NEAR)).sum(dim=1)
            r, c = torch.nonzero((d2 - r2).abs() < r2 * _NEAR,
                                 as_tuple=True)
            exact = pair_sq_dists(coords, part[r], c + col0)
            count.index_add_(0, r, (exact <= r2).long())
        pops.append(count)
    return torch.cat(pops).cpu().numpy()
