"""Noise detection and dynamic reassignment.

Mirrors ``Clustering::Noise::main`` (reference: src/noise.cpp:41-243):
frames that belong to low-populated clusters in the highest-threshold
screening result are marked as noise and then reassigned to the previous
core, chunk by chunk.
"""

import os
import sys

import numpy as np

from ..utils import io
from ..utils.logger import logger


def find_highest_cluster_file(basename, comments_map):
    """Scan the directory for the screening file with the highest FE level
    matching ``basename.`` (reference: src/noise.cpp:97-147)."""
    dirname = os.path.dirname(basename)
    scan_dir = dirname if dirname else "."
    prefix = os.path.basename(basename) + "."
    try:
        entries = sorted(os.listdir(scan_dir))
    except OSError:
        entries = []
    use_limit = (comments_map.get("screening_to", 0.0) != 0.0
                 and comments_map.get("screening_step", 0.0) != 0.0)
    for name in reversed(entries):
        if prefix not in name:
            continue
        pos = name.rfind(prefix)
        suffix = name[pos + len(prefix):]
        if use_limit:
            try:
                fe_max = float(suffix)
            except ValueError:
                continue
            hi = comments_map["screening_to"] + comments_map["screening_step"]
            if fe_max > hi or fe_max < comments_map["screening_to"]:
                continue
        path = os.path.join(scan_dir, name) if dirname else name
        return path
    return None


def noise_assignment(states, clust, cmin_fraction):
    """Mark frames of clusters with population < cmin * N as noise.

    Returns (marked_states, noise_state, n_noise_frames).
    Reference: src/noise.cpp:160-178.
    """
    states = np.asarray(states, dtype=np.int64)
    clust = np.asarray(clust, dtype=np.int64)
    n_frames = len(states)
    noise_state = int(states.min()) - 1
    if n_frames and clust.min() >= 0 and clust.max() < (1 << 24):
        # O(n) bincount gather instead of the unique() sort
        count_of = np.bincount(clust)[clust]
    else:
        vals, counts = np.unique(clust, return_counts=True)
        count_of = counts[np.searchsorted(vals, clust)]
    is_noise = count_of < cmin_fraction * n_frames
    marked = np.where(is_noise, noise_state, states)
    return marked, noise_state, int(np.count_nonzero(is_noise))


def reassign_noise(marked, noise_state, concat_limits, original_states):
    """Reassign noise frames to the previous non-noise core per chunk.

    Returns (noise_traj, cores, changed_frames).
    Reference: src/noise.cpp:186-215.
    """
    marked = np.asarray(marked, dtype=np.int64)
    n_frames = len(marked)
    noise_traj = np.empty_like(marked)
    cores = np.full(n_frames, -1, dtype=np.int64)
    changed = 0
    last_limit = 0
    # initial fallback core carries across all-noise chunks
    # (reference: noise.cpp:188, 193-200)
    carry_core = int(marked[0]) if n_frames else 0
    for next_limit in concat_limits:
        hi = min(int(next_limit), n_frames)
        lo = last_limit
        last_limit = hi
        if hi <= lo:
            continue
        seg = marked[lo:hi]
        ok = seg != noise_state
        nz = np.flatnonzero(ok)
        first_core = int(seg[nz[0]]) if len(nz) else carry_core
        pos = np.arange(hi - lo, dtype=np.int64)
        src = np.maximum.accumulate(np.where(ok, pos, -1))
        filled = np.where(src >= 0, seg[np.clip(src, 0, None)], first_core)
        noise_traj[lo:hi] = filled
        cores[lo:hi] = np.where(ok, filled, -1)
        changed += int(np.count_nonzero(filled != original_states[lo:hi]))
        carry_core = int(filled[-1])
    return noise_traj, cores, changed


def main(args, header_comment, comments_map):
    logger("~~~ reading files\n    trajectory from: " + args.states)
    states = io.read_clustered_trajectory(args.states)
    states_without_noise = states.copy()
    n_frames = len(states)
    cmin = 0.01 * float(args.cmin)
    basename = args.basename
    io.read_comments(args.states, comments_map)
    comments_map["cmin"] = cmin

    if not (args.output or args.cores):
        print("\nerror (noise): nothing to do! please define '--output'"
              " or '--cores'\n", file=sys.stderr)
        sys.exit(1)

    concat_limits = io.resolve_concat_limits(args.concat_limits,
                                             args.concat_nframes, n_frames)
    logger(f"    interpret data as {len(concat_limits)} trajectories")
    if comments_map["limits"] == 0:
        comments_map["limits"] = float(len(concat_limits))
    elif abs(comments_map["limits"] - len(concat_limits)) > 0.001:
        logger("warning: the number of limits are not in agreement\n"
               f"         {io.fmt_float(comments_map['limits'])} vs. "
               f"{len(concat_limits)}")

    clust_filename = find_highest_cluster_file(basename, comments_map)
    if clust_filename is None:
        print(f"\nerror (noise): cluster file of type {basename}. not"
              " found\n", file=sys.stderr)
        sys.exit(1)
    header_comment += ("#\n# Execution remarks:\n"
                       "# used for highest cluster file: %s\n"
                       % clust_filename)
    logger("    highest cluster: " + clust_filename)
    clust = io.read_clustered_trajectory(clust_filename)
    io.read_comments(clust_filename, comments_map)
    if n_frames != len(clust):
        print("\nerror (noise): clust file is not of same length as state"
              " trajectory.\n", file=sys.stderr)
        sys.exit(1)

    logger("~~~ noise assignment")
    marked, noise_state, noise_frames = noise_assignment(states, clust, cmin)
    noise_pct = 100.0 * noise_frames / n_frames
    logger("    %.2f" % noise_pct + "% of frames were identified as noise")
    header_comment += ("# %.2f" % noise_pct
                       + "% of frames were identified as noise\n")

    noise_traj, cores, changed = reassign_noise(marked, noise_state,
                                                concat_limits,
                                                states_without_noise)
    changed_pct = 100.0 * changed / n_frames
    logger("    %.2f" % changed_pct + "% of frames were reassigned\n"
           "    store result in: " + (args.output or ""))
    header_comment += ("# %.2f" % changed_pct
                       + "% of frames were reassigned\n")
    if args.output:
        io.write_clustered_trajectory(args.output, noise_traj,
                                      header_comment, comments_map)
    if args.cores:
        hc = io.append_comments_map(header_comment, comments_map)
        io.write_single_column(args.cores, cores, hc)
