"""State filtering and state-trajectory statistics.

Mirrors ``Clustering::Filter::main`` (reference: src/state_filter.cpp:55-274):
``stats`` prints a per-state population/entered/left table; ``filter``
streams a coordinates file (ASCII or GROMACS .xtc) and writes per-state
output files, optionally subsampled (--every-nth) or randomly sampled
(--nRandom).
"""

import random
import sys

import numpy as np

from ..utils import io
from ..utils.coords_file import open_coords_file
from ..utils.logger import logger


def state_statistics(states, concat_limits):
    """Returns (pops, entered, left) dicts (reference:
    state_filter.cpp:66-130)."""
    states = np.asarray(states, dtype=np.int64)
    n_frames = len(states)
    if n_frames and states.min() >= 0 and states.max() < (1 << 24):
        cnt = np.bincount(states)  # O(n), vs the unique() sort
        vals = np.flatnonzero(cnt)
        pops = {int(v): int(cnt[v]) for v in vals}
    else:
        vals, counts = np.unique(states, return_counts=True)
        pops = {int(v): int(c) for v, c in zip(vals, counts)}
    entered = {}
    left = {}
    last_limit = 0
    for next_limit in concat_limits:
        hi = min(int(next_limit), n_frames)
        seg = states[last_limit:hi]
        if len(seg) > 1:
            change = seg[1:] != seg[:-1]
            for s, c in zip(*np.unique(seg[1:][change], return_counts=True)):
                entered[int(s)] = entered.get(int(s), 0) + int(c)
            for s, c in zip(*np.unique(seg[:-1][change], return_counts=True)):
                left[int(s)] = left.get(int(s), 0) + int(c)
        last_limit = hi
    return pops, entered, left


def print_stats(states, concat_limits):
    """Reference: state_filter.cpp:131-169."""
    n_frames = len(states)
    pops, entered, left = state_statistics(states, concat_limits)
    print("~~~ state stats\n"
          "    state  population  pop [%]  tot [%]  entered     left")
    total_pop = 0.0
    total_entered = 0
    # descending population, ties by higher state id first
    # (std::priority_queue of (pop, id) pairs)
    order = sorted(pops.items(), key=lambda kv: (kv[1], kv[0]), reverse=True)
    for state, pop in order:
        rel = 100.0 * pop / n_frames
        total_pop += rel
        ent = entered.get(state, 0)
        lft = left.get(state, 0)
        total_entered += ent
        print("    %5d%12d%9.3f%9.3f%9d%9d"
              % (state, pop, rel, total_pop, ent, lft))
    print(f"\n~~~ total number of microstates: {len(entered)}\n"
          f"                    transitions: {total_entered}")


def _ascii_table(path, n_frames):
    """One-pass float32 table read for the ASCII filter fast path; None
    falls back to the row-streaming handler (native lib unavailable,
    comment lines, ragged rows, short files)."""
    from ..utils import textio_native
    if textio_native.format_g_rows(np.zeros((1, 1), np.float32)) is None:
        return None
    try:
        with open(path, "rb") as fh:
            head = fh.read(1 << 16)
    except OSError:
        return None
    stripped = head.lstrip(b" \t\r\n")
    if not stripped or stripped[:1] == b"#":
        # comment header (even after blank lines): the streaming handler
        # rejects it, so the bulk path must not silently accept it
        return None
    arr = io._read_table_fast(path)
    if arr is None or len(arr) < n_frames:
        return None
    return np.ascontiguousarray(arr[:n_frames], dtype=np.float32)


def _write_ascii_selection(table, states, selected, output_name,
                           every_nth, chosen_idx):
    """Bulk equivalent of the per-frame streaming loop below: same row
    selection, same " %g %g ...\\n" bytes (native formatter)."""
    from ..utils import textio_native
    if chosen_idx is not None:
        keep = np.fromiter(sorted(chosen_idx), dtype=np.int64,
                           count=len(chosen_idx))
    else:
        keep = np.flatnonzero(states == selected)[::every_nth]
    body = textio_native.format_g_rows(table[keep])
    with open(output_name, "wb") as fh:
        fh.write(body)


def filter_coords(states, coords_name, output_basename, selected_states,
                  every_nth, n_random):
    """Reference: state_filter.cpp:170-273."""
    states = np.asarray(states, dtype=np.int64)
    n_frames = len(states)
    file_extension = ""
    if len(coords_name) > 4 and coords_name[-4] == ".":
        file_extension = coords_name[-4:]
    if output_basename is None:
        output_basename = (coords_name[:-4] if file_extension
                           else coords_name)
    logger("\n~~~ filter states:")
    if every_nth > 1:
        logger(f"    use only every {every_nth}th frame")
    rng = random.SystemRandom()
    # bulk path only for the well-defined sampling domain; anything odd
    # (every_nth < 1) keeps the streaming loop's exact behavior
    table = None if (file_extension == ".xtc" or every_nth < 1) \
        else _ascii_table(coords_name, n_frames)
    for selected in selected_states:
        chosen_idx = None
        if n_random > 0:
            idx = np.flatnonzero(states == selected).tolist()
            rng_local = random.Random(rng.randint(0, 2**63))
            rng_local.shuffle(idx)
            chosen_idx = set(idx[:min(n_random, len(idx))])
        output_name = io.stringprintf(
            output_basename + ".state%i" + file_extension, selected)
        if table is not None:
            logger(f"    {selected} : {output_name}")
            _write_ascii_selection(table, states, selected, output_name,
                                   every_nth, chosen_idx)
            continue
        coords_in = open_coords_file(coords_name, "r")
        coords_out = open_coords_file(output_name, "w")
        logger(f"    {selected} : {output_name}")
        nth = 0
        try:
            for idx in range(n_frames):
                row = coords_in.next()
                if states[idx] != selected:
                    continue
                if n_random > 0:
                    if idx in chosen_idx:
                        coords_out.write(row)
                elif (nth % every_nth) == 0:
                    coords_out.write(row)
                    nth += 1
                else:
                    nth += 1
        finally:
            coords_in.close()
            coords_out.close()


def main(args, header_comment, comments_map, list_mode):
    logger("~~~ reading files\n    trajectory from: " + args.states)
    states = io.read_clustered_trajectory(args.states)
    n_frames = len(states)
    if list_mode:
        io.read_comments(args.states, comments_map)
        concat_limits = io.resolve_concat_limits(
            getattr(args, "concat_limits", None),
            getattr(args, "concat_nframes", None), n_frames)
        logger(f"    interpret data as {len(concat_limits)} trajectories")
        if comments_map["limits"] == 0:
            comments_map["limits"] = float(len(concat_limits))
        elif abs(comments_map["limits"] - len(concat_limits)) > 0.001:
            logger("warning: the number of limits are not in agreement\n"
                   f"         {io.fmt_float(comments_map['limits'])} vs. "
                   f"{len(concat_limits)}")
        print_stats(states, concat_limits)
    else:
        coords_name = args.coords
        logger("        coords from: " + coords_name)
        if args.selected_states:
            selected = list(args.selected_states)
        else:
            selected = np.unique(states).tolist()
        every_nth = int(args.every_nth)
        n_random = int(args.n_random) if args.n_random else 0
        if n_random and every_nth > 1:
            print("\nerror parsing arguments:\n\n"
                  "Use either 'every-nth' or 'nRandom'\n\n", file=sys.stderr)
            sys.exit(1)
        filter_coords(states, coords_name, args.output, selected,
                      every_nth, n_random)
