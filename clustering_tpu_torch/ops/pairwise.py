"""Squared distances with the arithmetic of the pairwise kernels.

Counterpart of ``clustering_tpu/ops/pairwise.py``. The distance is the
plain fma chain from zero in ascending dimension order,
``acc = fma(d_k, d_k, acc)``: ``torch.addcmul`` computes it as one fused
multiply-add, which makes it bit-equal to the CUDA kernels
(``__fmaf_rn``) and to the Pallas kernels run in interpret mode.
"""

import torch


def sq_dists(x, y):
    """(..., B, D) x (..., C, D) -> (..., B, C) squared distances
    (leading dimensions broadcast)."""
    acc = None
    for k in range(x.shape[-1]):
        diff = x[..., :, None, k] - y[..., None, :, k]
        acc = diff * diff if acc is None else torch.addcmul(acc, diff, diff)
    if acc is None:
        return torch.zeros(x.shape[:-1] + y.shape[-2:-1], dtype=torch.float32,
                           device=x.device)
    return acc


def pair_d2(coords, idx):
    """(N, D) coords, (..., N) neighbour ids -> squared distance of each
    frame to coords[idx] (the NN finish's recompute)."""
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=coords.device)
    for k in range(coords.shape[1]):
        diff = coords[:, k] - coords[idx, k]
        acc = torch.addcmul(acc, diff, diff)
    return acc
