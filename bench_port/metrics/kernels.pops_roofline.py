"""kernels.pops_roofline: the populations kernels' share of their
roofline, in per cent.

The work is what every exact count has to account for, whatever
implements it: the unordered frame pairs within the radius,
(sum of populations - N) / 2, taken from the job's populations (which the
check verifies), each 3 D float32 operations (a difference and a fused
multiply-add per dimension). The bytes are the coordinates read once and
the counts written once (float32 and int32). The least time is the larger
of the operations over 67 TFLOP/s and the bytes over 3.35 TB/s, NVIDIA's
published float32 (outside the tensor cores) and HBM peaks of the H100
SXM at 700 W; the card's power limit stands beside the result in the
line's ``device``. The time is the union of the traced job's
populations kernels, which are recognised by the names the program gives
them (``KERNEL``): the band prefetch's NN kernels run inside the
populations annotation, so the annotation's time would not do.
"""

import re

from bench_port import trace

KERNEL = re.compile(r"\bpops_\w*_kernel\b")
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def least_s(pops_sum, n, dim):
    pairs = (pops_sum - n) / 2
    flops = 3 * dim * pairs
    moved = 4 * n * dim + 4 * n
    return max(flops / PEAK_FLOPS, moved / PEAK_BYTES)


def read(ctx):
    if ctx.trace is None or ctx.pops_sum is None:
        return None
    spans = [span for name, span in ctx.trace["kernels"]
             if KERNEL.search(name)]
    if not spans:
        return None
    return 100.0 * least_s(ctx.pops_sum, ctx.n, ctx.dim) / trace.union_s(spans)
