"""Dynamical coring of state trajectories.

Mirrors ``Clustering::Coring::main`` (reference: src/coring.cpp:42-345):
a frame only enters a new state's core after ``window`` consecutive frames of
that state; until then it stays assigned to the previous core. Concatenated
sub-trajectories are cored independently.

The reference's sequential per-frame scan is replaced by vectorized
run-length encoding per chunk (identical results, O(N) numpy ops).
"""

import sys

import numpy as np

from ..utils import io
from ..utils.logger import logger


def compute_wtd(streaks):
    """Waiting-time distribution of a list of streak lengths
    (reference: src/coring.cpp:42-60): wtd[i] = P(streak >= i).

    One searchsorted instead of a per-i count (a megaframe single-state
    trajectory has megastreak lengths -- the scalar loop was seconds)."""
    wtd = {}
    if len(streaks):
        s = np.sort(np.asarray(streaks, dtype=np.int64))
        max_streak = int(s[-1])
        n = float(len(s))
        below = np.searchsorted(s, np.arange(max_streak + 1,
                                             dtype=np.int64), side="left")
        probs = (len(s) - below) / n
        return {i: float(p) for i, p in enumerate(probs)}
    return wtd


def _run_end_excl(seg):
    """For each position, the exclusive end of the maximal constant run
    containing it."""
    n = len(seg)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.flatnonzero(seg[1:] != seg[:-1]) + 1
    bounds = np.concatenate([[0], change, [n]])
    return np.repeat(bounds[1:], np.diff(bounds))


def core_trajectory(states, concat_limits, windows, size_for_all,
                    iterative=False):
    """Core a (possibly concatenated) state trajectory.

    Returns (cored_traj, cores, changed_frames) where ``cores[i]`` is the
    core state when frame i is inside a core, else -1.

    Reference: src/coring.cpp:189-289. Each (ramp step, chunk) scan runs
    as one native pass (native/textio.cpp::coring_pass) when the library
    is available; the vectorized numpy block below is the fallback and
    the parity oracle (tests/test_coring.py fuzzes their equality).
    """
    from ..utils import textio_native
    states = np.asarray(states, dtype=np.int64)
    n_frames = len(states)
    # per-state windows resolved once: coring only ever propagates
    # existing state values, so every later segment's values are in
    # vals0. A uniform window (the common single-int -w) skips the
    # per-frame lookup entirely.
    if windows:
        vals0 = np.unique(states)
        wins0 = np.asarray([windows.get(int(v), size_for_all)
                            for v in vals0], dtype=np.int64)
        max_window = int(wins0.max()) if len(wins0) else size_for_all
    else:
        vals0 = wins0 = None
        max_window = size_for_all
    if iterative and max_window > 1:
        window_ramp = list(range(2, max_window + 1))
    else:
        window_ramp = [max_window]

    prev = states.copy()
    cored = np.empty_like(states)
    cores = np.full(n_frames, -1, dtype=np.int64)
    changed_frames = 0
    for curr_max in window_ramp:
        last_pass = curr_max == max_window
        changed_frames = 0
        last_limit = 0
        for next_limit in concat_limits:
            hi = min(int(next_limit), n_frames)
            lo = last_limit
            last_limit = hi
            if hi <= lo:
                continue
            seg = prev[lo:hi]
            m = hi - lo
            if wins0 is None:
                cw = np.full(m, min(size_for_all, curr_max),
                             dtype=np.int64)
            else:
                cw = np.minimum(wins0[np.searchsorted(vals0, seg)],
                                curr_max)
            native = textio_native.coring_pass(seg, cw,
                                               int(next_limit) - lo,
                                               iterative)
            if native is not None:
                seg_cored, in_core = native
                cored[lo:hi] = seg_cored
                if last_pass:
                    cores[lo:hi] = np.where(in_core, seg_cored, -1)
                    changed_frames += int(
                        np.count_nonzero(seg_cored != states[lo:hi]))
                continue
            run_end = _run_end_excl(seg)
            pos = np.arange(m, dtype=np.int64)
            # full-window membership; the window must fit before the *raw*
            # chunk limit (coring.cpp:244: "last frames can not be in core")
            fits = (lo + pos + cw) <= next_limit
            if iterative:
                # iterative mode checks only the window's last frame
                # against the current frame (coring.cpp:248-253)
                j = np.minimum(pos + cw - 1, m - 1)
                const_win = seg[j] == seg
            else:
                const_win = run_end >= pos + cw
            in_core = fits & const_win & (pos + cw <= m)
            # first core: scan with window truncated at the chunk end
            # (coring.cpp:226-239)
            trunc_end = np.minimum(pos + cw, m)
            first_candidates = np.flatnonzero(run_end >= trunc_end)
            if len(first_candidates):
                first_core = seg[first_candidates[0]]
            else:
                first_core = seg[0]
            # forward-fill cores
            src = np.where(in_core, pos, -1)
            src = np.maximum.accumulate(src)
            seg_cored = np.where(src >= 0, seg[np.clip(src, 0, None)],
                                 first_core)
            cored[lo:hi] = seg_cored
            if last_pass:
                cores[lo:hi] = np.where(in_core, seg_cored, -1)
                changed_frames += int(
                    np.count_nonzero(seg_cored != states[lo:hi]))
        prev = cored.copy()
    return cored, cores, changed_frames


def main(args, header_comment, comments_map):
    states = io.read_clustered_trajectory(args.states)
    state_names = [int(s) for s in np.unique(states)]
    n_frames = len(states)
    iterative = bool(args.iterative)
    io.read_comments(args.states, comments_map)
    logger("~~~ reading files\n    trajectory from: " + args.states)
    if not (args.output or args.distribution or args.cores):
        print("\nerror (coring): nothing to do! please define '--output',"
              " '--distribution' or both!\n", file=sys.stderr)
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

    # window sizes: single int or per-state file with '*' wildcard
    # (reference: coring.cpp:106-157)
    windows = {}
    size_for_all = 1
    try:
        size_for_all = int(args.windows)
    except ValueError:
        logger("\n~~~ coring windows:\n    from file: " + args.windows)
        try:
            fh = open(args.windows)
        except OSError:
            print(f"error: cannot open file '{args.windows}'",
                  file=sys.stderr)
            sys.exit(1)
        with fh:
            for line in fh:
                toks = line.split()
                if len(toks) >= 2 and toks[0] == "*":
                    try:
                        size_for_all = int(toks[1])
                    except ValueError:
                        print("error: file not correctly formated.",
                              file=sys.stderr)
                elif len(toks) >= 2 and toks[0].isdigit():
                    try:
                        windows[int(toks[0])] = int(toks[1])
                    except ValueError:
                        print("error: file not correctly formated.",
                              file=sys.stderr)
    n_explicit = sum(1 for s in state_names if s in windows)
    # note: the reference's "single_coring_time" metadata write is dead
    # code (coring.cpp:154-157 tests a map that was just filled for every
    # state), so no #@ line is emitted here either
    header_comment += (
        "#\n# coring specific parameters: \n"
        "#    %i state-specific coring windows were read\n"
        "#    %i frames is used for reamining states\n"
        % (n_explicit, size_for_all))
    if iterative:
        header_comment += "# iterative mode active\n"
    if n_explicit > 0:
        logger(f"    {n_explicit} state-specific coring windows were read")
    if size_for_all > 1:
        logger(f"    default window was set to {size_for_all} frames")

    all_windows = [windows.get(s, size_for_all) for s in state_names]
    if min(all_windows) == 0:
        print("error: no window of size 0 is allowed. A window of length 1"
              " corresponds to no coring", file=sys.stderr)
        sys.exit(1)

    logger("\n~~~ coring trajectory")
    logger(f"    max coring window: {max(all_windows)}")
    cored_traj, cores, changed_frames = core_trajectory(
        states, concat_limits, windows, size_for_all, iterative)
    changed_pct = 100.0 * changed_frames / n_frames
    logger("    %.2f" % changed_pct + "% of frames were changed\n    "
           + str(changed_frames) + " frames in total")
    header_coring = (header_comment + "#    %.2f" % changed_pct
                     + "% of frames were changed\n")
    if args.output:
        logger("    store result in: " + args.output)
        io.write_clustered_trajectory(args.output, cored_traj,
                                      header_coring, comments_map)
    if args.cores:
        hc = io.append_comments_map(header_coring, comments_map)
        io.write_single_column(args.cores, cores, hc)
    if args.distribution:
        logger("~~~ generating distribution")
        # streak lengths over the whole cored trajectory, grouped by
        # state via one RLE + sort (reference: coring.cpp:311-325 -- the
        # sequential scan; not chunk-aware, matched here)
        change = np.flatnonzero(cored_traj[1:] != cored_traj[:-1]) + 1
        bounds = np.concatenate([[0], change, [len(cored_traj)]])
        lengths = np.diff(bounds)
        run_states = cored_traj[bounds[:-1]]
        order = np.argsort(run_states, kind="stable")
        su, ls = run_states[order], lengths[order]
        cuts = np.flatnonzero(su[1:] != su[:-1]) + 1
        streaks = {int(st): chunk for st, chunk in
                   zip(su[np.concatenate([[0], cuts])],
                       np.split(ls, cuts))}
        hc = io.append_comments_map(header_comment, comments_map)
        logger("    storing...")
        for state in state_names:
            wtd = compute_wtd(streaks.get(state, []))
            io.write_map(io.stringprintf(args.distribution + "_%d", state),
                         wtd, hc)
