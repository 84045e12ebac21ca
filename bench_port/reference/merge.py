"""Plain PyTorch reference of the screening's clusterings: the connected
components of the clustered frames at each threshold.

At threshold k the frames below it are joined i ~ j iff d2(i, j) < link2
(= 4 sigma^2), and the clustering is the partition of those frames into
the connected components of that graph. The frames of each threshold are
nested, so every edge has a level, the first threshold at which both of
its frames are in, and the components grow from one threshold to the
next as edges are added.

``edges`` finds every pair of the given frames with d2 below
link2 (1 + slack) through a grid of cells of side sqrt(link2 (1 + slack)):
such a pair lies in one cell or in two cells that touch, so each frame
is compared with the frames of its own cell and of the 3^D - 1 cells
around it (half of them, so that each pair comes once). d2 here is the
float64 sum of squares of the float32 coordinates' differences, which
lies within about 1e-7 of the float32 chain of the program (relative to
d2), far inside ``slack``: an edge is sure where d2 < link2 (1 - slack),
and the few between the two may go either way.

``components`` hooks every root onto the smallest root of its edges and
jumps pointers until no edge joins two roots: each frame then points at
the smallest frame of its component.
"""

import itertools
import math

import torch

EDGE_SLACK = 1e-4
CHUNK = 1 << 25


def _half_stencil(dim):
    """The cell offsets in {-1, 0, 1}^dim that are zero or whose first
    nonzero entry is positive."""
    out = []
    for off in itertools.product((-1, 0, 1), repeat=dim):
        nonzero = [o for o in off if o]
        if not nonzero or nonzero[0] > 0:
            out.append(off)
    return out


def _cell_pairs(x, side):
    """Frames sorted by cell, and per stencil offset the touching
    (cell a, cell b) pairs: (order, start, count, [(a, b, same)])."""
    cell = torch.floor((x - x.min(dim=0).values) / side).long() + 1
    dims = (cell.max(dim=0).values + 2).tolist()
    stride = [math.prod(dims[k + 1:]) for k in range(len(dims))]
    key = (cell * torch.tensor(stride, device=x.device)).sum(dim=1)
    order = torch.argsort(key)
    ukey, count = torch.unique_consecutive(key[order], return_counts=True)
    start = torch.cumsum(count, 0) - count
    cells = torch.arange(len(ukey), device=x.device)
    pairs = []
    for off in _half_stencil(x.shape[1]):
        lin = sum(o * s for o, s in zip(off, stride))
        if lin == 0:
            pairs.append((cells, cells, True))
            continue
        want = ukey + lin
        pos = torch.searchsorted(ukey, want).clamp(max=len(ukey) - 1)
        hit = ukey[pos] == want
        pairs.append((cells[hit], pos[hit], False))
    return order, start, count, pairs


def edges(coords, frames, link2, slack=EDGE_SLACK, chunk=CHUNK):
    """(i, j, sure) of every pair of ``frames`` (int64 tensor of frame
    ids) with d2 < link2 (1 + slack), each pair once; ``sure``: d2 <
    link2 (1 - slack)."""
    dev = coords.device
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if len(frames) < 2:
        return empty, empty, torch.zeros(0, dtype=torch.bool, device=dev)
    reach2 = link2 * (1.0 + slack)
    x = coords[frames].double()
    order, start, count, pairs = _cell_pairs(x, math.sqrt(reach2))
    x, ids = x[order], frames[order]
    out = []
    for a, b, same in pairs:
        n_b = count[b]
        n_ab = count[a] * n_b
        cum = torch.cumsum(n_ab, 0)
        lo, done = 0, 0
        while lo < len(a):
            hi = int(torch.searchsorted(cum, done + chunk, right=True))
            hi = max(hi, lo + 1)
            seg = n_ab[lo:hi]
            size = int(seg.sum())
            rep = torch.repeat_interleave(
                torch.arange(hi - lo, device=dev), seg, output_size=size)
            k = torch.arange(size, device=dev) - (torch.cumsum(seg, 0)
                                                  - seg)[rep]
            nb = n_b[lo:hi][rep]
            ki, kj = k // nb, k % nb
            if same:
                keep = ki < kj
                rep, ki, kj = rep[keep], ki[keep], kj[keep]
            i = start[a[lo:hi]][rep] + ki
            j = start[b[lo:hi]][rep] + kj
            d2 = ((x[i] - x[j]) ** 2).sum(dim=1)
            near = d2 < reach2
            out.append((ids[i[near]], ids[j[near]],
                        d2[near] < link2 * (1.0 - slack)))
            lo, done = hi, int(cum[hi - 1])
    if not out:
        return empty, empty, torch.zeros(0, dtype=torch.bool, device=dev)
    return tuple(torch.cat(part) for part in zip(*out))


def components(i, j, parent):
    """``parent`` (int64 tensor over the frames, each entry pointing at a
    root of a forest) with the edges (i, j) joined: each frame then points
    at the smallest frame of its component (a new tensor)."""
    parent = parent.clone()
    while True:
        pi, pj = parent[i], parent[j]
        apart = pi != pj
        if not bool(apart.any()):
            return parent
        i, j, pi, pj = i[apart], j[apart], pi[apart], pj[apart]
        parent.scatter_reduce_(0, torch.maximum(pi, pj),
                               torch.minimum(pi, pj), reduce="amin")
        while True:
            up = parent[parent]
            if torch.equal(up, parent):
                break
            parent = up


def clusterings(coords, levels, n_levels, link2, slack=EDGE_SLACK,
                chunk=CHUNK):
    """Per threshold k < ``n_levels``, the components of the frames whose
    ``levels`` (the first threshold at which each frame is clustered,
    ``n_levels`` for none; a tensor on the coordinates' device) are <= k:
    a list of (sure, maybe) int64 tensors over all frames, each frame's
    smallest frame of its component over the sure edges and over all
    edges; a frame not yet clustered is its own."""
    n = len(coords)
    frames = torch.nonzero(levels < n_levels).flatten()
    i, j, sure = edges(coords, frames, link2, slack, chunk)
    level = torch.maximum(levels[i], levels[j])
    sure_parent = torch.arange(n, device=coords.device)
    maybe_parent = sure_parent.clone()
    out = []
    for k in range(n_levels):
        now = level == k
        sure_parent = components(i[now & sure], j[now & sure], sure_parent)
        maybe_parent = components(i[now], j[now], maybe_parent)
        out.append((sure_parent, maybe_parent))
    return out
