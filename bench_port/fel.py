"""The benchmark's input: a synthetic free-energy landscape from the seed.

``synthetic_fel`` is the generator of the repository's ``bench.py`` and
``chip_smoke.py`` (four anisotropic gaussian basins visited by a sticky
Markov walk, so that frames are correlated in time as MD frames are),
with one change: every seed gives each basin the same number of frames.
The walk's stays (geometric, mean ``1 / (1 - STAY)`` frames) are cut
within each basin's share and then shuffled. With the occupancy left to
the walk, a basin's share moves by several per cent from seed to seed at
2^20 frames, and the O(N^2) work with it; the seed should change the
frames, not the amount of work.

Coordinates are fixed to six decimals (``micro_units``): the text that the
CLI reads is exactly ``%.6f`` of those values (``write_text``), and the
float32 coordinates that the reference and the library entry use
(``coords_f32``) are what a correct parser of that text returns.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

CENTERS = np.asarray([
    [0.0, 0.0, 0.0, 0.0],
    [1.1, 0.4, -0.2, 0.1],
    [-0.8, 1.0, 0.3, -0.2],
    [0.5, -0.9, 0.1, 0.3],
])
STAY = 0.9995
FRAC_DIGITS = 6
# the three decimal digits of 0..999, as bytes
_DIGITS3 = np.frombuffer("".join(f"{i:03d}" for i in range(1000)).encode(),
                         dtype=np.uint8).reshape(1000, 3)


def seed_words(seed, *more):
    """numpy seed entropy from any whole ``seed`` (negative ones too) and
    further whole numbers: one stream per purpose."""
    return [int(seed) % (1 << 64)] + [int(m) for m in more]


def basin_walk(n, n_basins, rng):
    """(n,) basin of each frame: each basin holds n // n_basins frames (the
    first n % n_basins one more), in stays of geometric length cut within
    each basin's share and shuffled."""
    stays = []
    for basin in range(n_basins):
        count = n // n_basins + (basin < n % n_basins)
        cuts = np.flatnonzero(rng.random(max(count - 1, 0)) > STAY) + 1
        lengths = np.diff(np.concatenate(([0], cuts, [count])))
        stays.append(np.stack([np.full(len(lengths), basin), lengths], 1))
    stays = np.concatenate(stays)
    stays = stays[rng.permutation(len(stays))]
    return np.repeat(stays[:, 0], stays[:, 1])


def synthetic_fel(n, d, seed):
    """(n, d) float64 frames of the landscape drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    centers = np.zeros((len(CENTERS), d))
    centers[:, :min(d, CENTERS.shape[1])] = CENTERS[:, :d]
    scales = np.linspace(0.25, 0.08, d)
    which = basin_walk(n, len(CENTERS), rng)
    return centers[which] + rng.normal(size=(n, d)) * scales


def micro_units(x):
    """The frames as whole millionths (int64): the values that the text
    holds."""
    return np.rint(np.asarray(x, dtype=np.float64) * 10 ** FRAC_DIGITS
                   ).astype(np.int64)


def coords_f32(q):
    """float32 coordinates of ``micro_units`` ``q``: the decimal rounded
    once to float64 by the division, then to float32; a six-decimal value
    of this size never lies on a float32 rounding tie, so this is the
    correctly rounded float32 of the text."""
    return (np.asarray(q, dtype=np.int64) / float(10 ** FRAC_DIGITS)
            ).astype(np.float32)


def format_rows(q):
    """``%.6f`` text of the rows of ``q`` (int64 millionths), one row per
    line, columns separated by one space: what ``np.savetxt(fmt="%.6f")``
    writes for the values ``q / 1e6``."""
    q = np.asarray(q, dtype=np.int64)
    n, d = q.shape
    neg = q < 0
    mag = np.abs(q)
    whole = mag // 10 ** FRAC_DIGITS
    frac = mag % 10 ** FRAC_DIGITS
    n_whole = max(1, len(str(int(whole.max())))) if q.size else 1
    width = 1 + n_whole + 1 + FRAC_DIGITS + 1
    buf = np.zeros((n, d, width), dtype=np.uint8)
    keep = np.ones((n, d, width), dtype=bool)
    buf[:, :, 0] = ord("-")
    keep[:, :, 0] = neg
    for k in range(n_whole):
        place = 10 ** (n_whole - 1 - k)
        buf[:, :, 1 + k] = ord("0") + (whole // place) % 10
        if k < n_whole - 1:
            keep[:, :, 1 + k] = whole >= place
    buf[:, :, 1 + n_whole] = ord(".")
    buf[:, :, 2 + n_whole:5 + n_whole] = _DIGITS3[frac // 1000]
    buf[:, :, 5 + n_whole:8 + n_whole] = _DIGITS3[frac % 1000]
    buf[:, :, -1] = ord(" ")
    buf[:, -1, -1] = ord("\n")
    return buf[keep].tobytes()


def write_text(path, q, rows_per_chunk=1 << 18, workers=8):
    """Write ``q`` as ``%.6f`` text to ``path``, its chunks of rows
    formatted on ``workers`` threads (numpy releases the interpreter lock)
    and written in order."""
    chunks = [q[lo:lo + rows_per_chunk]
              for lo in range(0, len(q), rows_per_chunk)]
    with ThreadPoolExecutor(max_workers=workers) as pool, \
            open(path, "wb") as fh:
        for text in pool.map(format_rows, chunks):
            fh.write(text)
