"""Most-Probable-Path (MPP) dynamic lumping of microstates.

Mirrors ``Clustering::MPP`` (reference: src/mpp.cpp): builds a row-normalized
transition matrix at fixed lag time, then for a series of metastability
thresholds Q_min iteratively lumps each microstate along its most probable
path into the path's free-energy sink until self-consistency.

Matrices are kept as sparse dict-of-rows keyed by state id (the reference
uses boost::uBLAS mapped_matrix<float>, mpp.hpp:59). Initial transition
probabilities are computed with fp32 divisions to match the reference
bitwise; re-lumped matrices accumulate in double (the reference accumulates
in fp32 -- values may differ at ~1e-7, documented deviation).

Reference quirks reproduced on purpose (see SURVEY.md "hard parts" #7):
  * ``path_sinks`` collects equal-minimum sink candidates by comparing the
    *per-frame* free energy indexed by state id (reference bug,
    mpp.cpp:373-384); we reproduce it verbatim for parity.
Reference quirks fixed on purpose:
  * the reference tests ``args.count("concat_limits")`` (typo, mpp.cpp:526),
    so ``--concat-limits`` silently degraded to a single continuous
    trajectory; here the flag works and selects the *intended* per-chunk
    sqrt-weighted transition counts (with the chunk-slicing fixed,
    cf. mpp.cpp:113-157).
"""

import sys

import numpy as np

from ..utils import io
from ..utils.logger import logger

MAX_ITER = 100


# ---------------------------------------------------------------------------
# transition matrices (sparse dict-of-rows: {i: {j: p}})
# ---------------------------------------------------------------------------

def transition_counts(trajectory, concat_limits, n_lag_steps):
    """Pair counts (i -> j) at the given lag, not crossing chunk limits.

    Reference: mpp.cpp:78-111 (including the quirk that frames beyond the
    last limit form an implicit extra chunk).
    """
    if n_lag_steps == 0:
        print("error: lagtime of 0 does not make any sense for MPP"
              " clustering", file=sys.stderr)
        sys.exit(1)
    traj = np.asarray(trajectory, dtype=np.int64)
    n = len(traj)
    limits = [min(int(x), n) for x in (concat_limits or [n])]
    if limits and limits[-1] < n:
        limits.append(n)
    counts = {}
    lo = 0
    smax = int(traj.max()) + 1 if n else 1
    for hi in limits:
        if hi - lo > n_lag_steps:
            src = traj[lo:hi - n_lag_steps]
            dst = traj[lo + n_lag_steps:hi]
            # memory-bounded gate: the bincount table is smax^2 int64s,
            # so only take the flat-key path when that table is small
            # relative to the trajectory (max state id can approach the
            # frame count, making smax^2 explode past RAM)
            if 0 <= traj.min() and smax * smax <= max(4 * len(src), 1 << 26):
                # flat-key bincount: linear instead of the 2-column
                # lexsort (1.1s -> ~20ms at 1M frames, 600 states)
                key = src * smax + dst
                cnt = np.bincount(key, minlength=smax * smax)
                nzk = np.flatnonzero(cnt)
                pairs = np.stack([nzk // smax, nzk % smax], axis=1)
                pair_counts = cnt[nzk]
            else:
                pairs, pair_counts = np.unique(
                    np.stack([src, dst], axis=1), axis=0,
                    return_counts=True)
            # group by source row (pairs are lexicographically sorted)
            row_starts = np.concatenate(
                [[0], np.flatnonzero(np.diff(pairs[:, 0])) + 1])
            bounds = np.append(row_starts, len(pairs))
            fcounts = pair_counts.astype(np.float64)
            for k, s in enumerate(row_starts):
                e = bounds[k + 1]
                i = int(pairs[s, 0])
                js = pairs[s:e, 1].tolist()
                cs = fcounts[s:e].tolist()
                row = counts.get(i)
                if row is None:
                    counts[i] = dict(zip(js, cs))
                else:
                    for j, c in zip(js, cs):
                        row[j] = row.get(j, 0.0) + c
        lo = hi
    return counts


def weighted_transition_counts(trajectory, concat_limits, n_lag_steps):
    """Per-chunk counts combined with sqrt(row-count) weights
    (intended semantics of reference mpp.cpp:113-157)."""
    traj = np.asarray(trajectory, dtype=np.int64)
    n = len(traj)
    weighted = {}
    acc_weights = {}
    lo = 0
    for hi in [min(int(x), n) for x in concat_limits]:
        chunk_counts = transition_counts(traj[lo:hi], [], n_lag_steps)
        for i, row in chunk_counts.items():
            w = float(np.sqrt(np.float32(sum(row.values()))))
            acc_weights[i] = acc_weights.get(i, 0.0) + w
            wrow = weighted.setdefault(i, {})
            for j, c in row.items():
                wrow[j] = wrow.get(j, 0.0) + w * c
        lo = hi
    for i, row in weighted.items():
        for j in row:
            row[j] /= acc_weights[i]
    return weighted


def row_normalized(counts, cluster_names):
    """Row-normalize counts into transition probabilities with fp32
    divisions (reference: mpp.cpp:159-179)."""
    tmat = {}
    for i in cluster_names:
        row = counts.get(i, {})
        row_sum = np.float32(0.0)
        for j in sorted(row):
            row_sum = np.float32(row_sum + np.float32(row[j]))
        if row_sum > 0:
            tmat[i] = {j: float(np.float32(np.float32(c) / row_sum))
                       for j, c in row.items() if c != 0}
    return tmat


def read_transition_probabilities(path):
    """3-column 'from to prob' file (reference: mpp.cpp:38-76)."""
    tmat = {}
    data = np.loadtxt(path, ndmin=2, comments="#")
    for i, j, p in data:
        tmat.setdefault(int(i), {})[int(j)] = float(p)
    return tmat


def _t(tmat, i, j):
    return tmat.get(i, {}).get(j, 0.0)


# ---------------------------------------------------------------------------
# MPP iteration pieces
# ---------------------------------------------------------------------------

def microstate_min_free_energy(trajectory, free_energy):
    """state -> min frame free energy (reference: mpp.cpp:320-335)."""
    traj = np.asarray(trajectory, dtype=np.int64)
    fe = np.asarray(free_energy, dtype=np.float32)
    m = min(len(traj), len(fe))
    if m and traj[:m].min() >= 0 and traj[:m].max() < (1 << 24):
        # small-id fast path: scatter-min instead of a full sort
        smax = int(traj[:m].max()) + 1
        mins = np.full(smax, np.inf, dtype=np.float32)
        np.minimum.at(mins, traj[:m], fe[:m])
        vals = np.flatnonzero(np.isfinite(mins) |
                              (np.bincount(traj[:m], minlength=smax) > 0))
        return {int(v): float(mins[v]) for v in vals}
    out = {}
    order = np.argsort(traj[:m], kind="stable")
    vals, starts = np.unique(traj[:m][order], return_index=True)
    mins = np.minimum.reduceat(fe[:m][order], starts)
    return {int(v): float(mn) for v, mn in zip(vals, mins)}


def _rows_to_coo(tmat, row_ids):
    """Stack the sparse rows ``row_ids`` into COO arrays (i, j, p).

    Entry order is row-major; within a row the dict order is kept (every
    consumer is order-independent: max is exact, sums re-sort first)."""
    ii, jj, pp = [], [], []
    for i in row_ids:
        r = tmat.get(i)
        if not r:
            continue
        ii.append(np.full(len(r), i, dtype=np.int64))
        jj.append(np.fromiter(r.keys(), dtype=np.int64, count=len(r)))
        pp.append(np.fromiter(r.values(), dtype=np.float64, count=len(r)))
    if not ii:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), np.empty(0, dtype=np.float64)
    return np.concatenate(ii), np.concatenate(jj), np.concatenate(pp)


def _positions_in(sorted_arr, values):
    """(positions, valid_mask) of ``values`` in the sorted id array."""
    pos = np.searchsorted(sorted_arr, values)
    pos_c = np.minimum(pos, len(sorted_arr) - 1)
    return pos_c, (pos < len(sorted_arr)) & (sorted_arr[pos_c] == values)


def single_step_future_state(tmat, cluster_names, q_min, min_free_energy):
    """Immediate-future state per microstate (reference: mpp.cpp:234-286).

    Vectorized over the sparse matrix entries; decision semantics match
    the reference scan exactly: a state with self-transition probability
    >= q_min is its own future; otherwise the off-diagonal maximum wins,
    with probability ties broken by minimal per-state free energy and
    remaining ties by the smallest state id (the reference's
    first-minimum-in-ascending-scan order).
    """
    names = list(cluster_names)
    name_arr = np.asarray(sorted(names), dtype=np.int64)
    self_p = {i: _t(tmat, i, i) for i in names}
    future = {}
    pending = [i for i in names if not self_p[i] >= q_min]
    for i in names:
        if self_p[i] >= q_min:
            future[i] = i
    if pending:
        i_arr, j_arr, p_arr = _rows_to_coo(tmat, pending)
        pos_i, _ = _positions_in(name_arr, i_arr)
        pos_j, j_ok = _positions_in(name_arr, j_arr)
        # eligible: j a live state, off-diagonal, positive probability
        # (only p > 0 can win the reference's strict '>' maximum)
        keep = j_ok & (i_arr != j_arr) & (p_arr > 0.0)
        i_k, j_k, p_k = pos_i[keep], j_arr[keep], p_arr[keep]
        max_p = np.full(len(name_arr), 0.0)
        np.maximum.at(max_p, i_k, p_k)
        # candidates: entries achieving their row's exact maximum; pick
        # the (min_free_energy, state id) lexicographic minimum per row
        cand = p_k == max_p[i_k]
        i_c, j_c = i_k[cand], j_k[cand]
        fe_c = np.fromiter(
            (min_free_energy.get(int(s), np.inf) for s in j_c),
            dtype=np.float64, count=len(j_c))
        order = np.lexsort((j_c, fe_c, i_c))
        rows_sorted = i_c[order]
        first = np.unique(rows_sorted, return_index=True)[1]
        winner = dict(zip(name_arr[rows_sorted[first]].tolist(),
                          j_c[order][first].tolist()))
        for i in pending:
            if i not in winner:
                print(f"error: state '{i}' has self-transition probability"
                      f" of {io.fmt_float(_t(tmat, i, i))} at Qmin "
                      f"{io.fmt_float(q_min)} and does not find any"
                      " transition candidates. please have a look at your"
                      " trajectory!", file=sys.stderr)
                sys.exit(1)
            future[i] = winner[i]
    return future


def most_probable_path(future_state, cluster_names):
    """Follow future states until a state repeats (reference: mpp.cpp:288-306)."""
    mpp = {}
    for i in cluster_names:
        path = [i]
        visited = {i}
        nxt = future_state[i]
        while nxt not in visited:
            path.append(nxt)
            visited.add(nxt)
            nxt = future_state[nxt]
        mpp[i] = path
    return mpp


def path_sinks(trajectory, mpp, tmat, cluster_names, q_min, free_energy):
    """Sink (lumping target) per path (reference: mpp.cpp:337-396)."""
    pops = io.microstate_populations(trajectory)
    min_fe = microstate_min_free_energy(trajectory, free_energy)
    return _path_sinks(pops, min_fe, mpp, tmat, cluster_names, q_min,
                       free_energy)


def _path_sinks(pops, min_fe, mpp, tmat, cluster_names, q_min,
                free_energy):
    """path_sinks with precomputed per-state populations and min free
    energies (the state-space iteration avoids the per-iteration
    full-trajectory scans).

    Reproduces the reference's candidate-collection quirk: the equality loop
    compares the per-frame free energy *indexed by state id*.
    """
    fe = np.asarray(free_energy, dtype=np.float32)

    def frame_fe(state):
        return float(fe[state]) if state < len(fe) else float("inf")

    sinks = {}
    for i in cluster_names:
        metastable = [j for j in mpp[i] if _t(tmat, j, j) > q_min]
        if not metastable:
            metastable = list(mpp[i])
        # first min by per-state min free energy (path order on ties)
        candidate = min(metastable, key=lambda s: min_fe[s])
        ref_fe = frame_fe(candidate)
        sink_candidates = set()
        while metastable and frame_fe(candidate) == ref_fe:
            sink_candidates.add(candidate)
            metastable.remove(candidate)
            if not metastable:
                break
            candidate = min(metastable, key=lambda s: min_fe[s])
        if len(sink_candidates) == 1:
            sinks[i] = next(iter(sink_candidates))
        else:
            sinks[i] = max(sorted(sink_candidates),
                           key=lambda s: pops.get(s, 0))
    return sinks


def updated_transition_probabilities(tmat, sinks, pops):
    """Re-lump the transition matrix by the sink mapping
    (reference: mpp.cpp:181-232).

    Sparse COO formulation of P'[m1, m2] = sum_{u1 in m1, u2 in m2}
    relpop(u1) * P[u1, u2], then row-normalized -- O(nnz log nnz) instead
    of the reference's O(S^2 * members) nested scan. Per-entry arithmetic
    (fp32 relative populations, float64 products) matches the scalar
    formulation exactly; group sums use numpy's deterministic pairwise
    summation (see docs/PARITY.md, "Floating-point notes").
    """
    macrostates = sorted(set(sinks.values()))
    n_mac = len(macrostates)
    m_index = {m: k for k, m in enumerate(macrostates)}
    micro = np.fromiter(sorted(sinks), dtype=np.int64)
    mac_of = np.fromiter((m_index[sinks[int(u)]] for u in micro),
                         dtype=np.int64, count=len(micro))
    pop_u = np.fromiter((pops.get(int(u), 0) for u in micro),
                        dtype=np.int64, count=len(micro))
    # exact integer group totals (float64 holds counts < 2^53 exactly),
    # then the reference's fp32 division
    pop_tot = np.bincount(mac_of, weights=pop_u.astype(np.float64),
                          minlength=n_mac)
    with np.errstate(invalid="ignore"):
        rp = (pop_u.astype(np.float32)
              / pop_tot.astype(np.float32)[mac_of]).astype(np.float64)

    i_arr, j_arr, p_arr = _rows_to_coo(tmat, micro.tolist())
    updated = {m: {} for m in macrostates}
    if len(i_arr):
        pos_i, _ = _positions_in(micro, i_arr)
        pos_j, j_ok = _positions_in(micro, j_arr)
        i_k, j_k, p_k = pos_i[j_ok], pos_j[j_ok], p_arr[j_ok]
        g = mac_of[i_k] * n_mac + mac_of[j_k]
        vals = rp[i_k] * p_k
        order = np.argsort(g, kind="stable")
        g_sorted, v_sorted = g[order], vals[order]
        starts = np.concatenate(
            [[0], np.flatnonzero(np.diff(g_sorted)) + 1])
        g_unique = g_sorted[starts]
        acc = np.add.reduceat(v_sorted, starts)
        gm1, gm2 = g_unique // n_mac, g_unique % n_mac
        row_sums = np.zeros(n_mac)
        # in-order fold per row (groups are g-sorted, i.e. ascending m2
        # within each m1, the reference's accumulation order)
        np.add.at(row_sums, gm1, acc)
        rs = row_sums[gm1]
        out_vals = np.where(rs != 0.0, acc / np.where(rs == 0.0, 1.0, rs),
                            acc)
        nz = acc != 0.0
        for m1i, m2i, v in zip(gm1[nz].tolist(), gm2[nz].tolist(),
                               out_vals[nz].tolist()):
            updated[macrostates[m1i]][macrostates[m2i]] = v
    return updated


def lumped_trajectory(trajectory, sinks):
    """Map every state through the sink lookup (reference: mpp.cpp:400-407)."""
    traj = np.asarray(trajectory, dtype=np.int64)
    vals = np.unique(traj)
    lookup = np.asarray([sinks.get(int(v), int(v)) for v in vals],
                        dtype=np.int64)
    return lookup[np.searchsorted(vals, traj)]


def fixed_metastability_clustering(initial_trajectory, tmat, q_min,
                                   free_energy):
    """Iterate lump->update until the trajectory is stable
    (reference: mpp.cpp:409-485).

    The iteration runs entirely in state space: per-state populations
    and min free energies are aggregated once from the frame trajectory,
    then each lump step composes an S-sized state map instead of
    rewriting the N-frame trajectory (the reference pays the N-frame
    rewrite per iteration, mpp.cpp:400-407). The trajectory materializes
    once at convergence -- bit-identical results, O(S) iterations."""
    traj0 = np.asarray(initial_trajectory, dtype=np.int64)
    init_states = np.unique(traj0)
    base_pops = io.microstate_populations(traj0)
    base_minfe = microstate_min_free_energy(traj0, free_energy)
    # cur[k] = current lumped name of init_states[k]
    cur = init_states.copy()
    lumping = {}
    for it in range(MAX_ITER):
        names_arr = np.unique(cur)
        names = names_arr.tolist()
        if 0 in names:
            print("\nwarning:\n"
                  "  there is a state '0' in your trajectory.\n"
                  "  are you sure you generated a proper trajectory of"
                  " microstates\n"
                  "  (e.g. by running a final, seeded density-clustering"
                  " to fill up the FEL)?\n", file=sys.stderr)
        logger("          %3i %6s" % (it + 1, "%0.3f" % q_min))
        # aggregate pops / min-FE over each lumped state's preimage
        pops = {}
        min_fe = {}
        for k, s0 in enumerate(init_states):
            name = int(cur[k])
            pops[name] = pops.get(name, 0) + base_pops.get(int(s0), 0)
            mf = base_minfe.get(int(s0))
            if mf is not None and (name not in min_fe
                                   or mf < min_fe[name]):
                min_fe[name] = mf
        future = single_step_future_state(tmat, names, q_min, min_fe)
        mpp = most_probable_path(future, names)
        sinks = _path_sinks(pops, min_fe, mpp, tmat, names, q_min,
                            free_energy)
        tmat = updated_transition_probabilities(tmat, sinks, pops)
        cur_new = np.asarray(
            [sinks.get(int(v), int(v)) for v in cur], dtype=np.int64)
        for frm, to in sinks.items():
            if frm != to:
                lumping[frm] = to
        if np.array_equal(cur_new, cur):
            return lumped_trajectory(traj0, dict(
                zip(init_states.tolist(), cur.tolist()))), lumping, tmat
        cur = cur_new
    raise RuntimeError("reached max. no. of iterations for Q_min"
                       f" convergence: {MAX_ITER}")


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def main(args, header_comment, comments_map):
    basename = args.output
    transitions = {}
    max_pop = {}
    max_qmin = {}
    logger("~~~ reading files\n    trajectory from: " + args.states)
    traj = io.read_clustered_trajectory(args.states)
    io.read_comments(args.states, comments_map)
    n_frames = len(traj)
    logger("    free energy from: " + args.free_energy_input)
    free_energy = io.read_free_energies(args.free_energy_input)
    io.read_comments(args.free_energy_input, comments_map)

    q_min_from = np.float32(args.qmin_from)
    q_min_to = np.float32(args.qmin_to)
    q_min_step = np.float32(args.qmin_step)
    lagtime = int(args.lagtime)

    diff_sized_chunks = bool(args.concat_limits)
    if diff_sized_chunks:
        logger("    concat limits from: " + args.concat_limits)
        concat_limits = io.read_concat_limits(args.concat_limits)
    elif args.concat_nframes:
        step = int(args.concat_nframes)
        concat_limits = list(range(step, n_frames + 1, step))
    else:
        concat_limits = [n_frames]
    io.check_concat_limits(concat_limits, n_frames)

    logger("~~~ transition matrix")
    if args.tprob:
        logger("    read from " + args.tprob + "\n"
               "     lagtime -l will be ignored.")
        tmat = read_transition_probabilities(args.tprob)
    else:
        logger("    compute it")
        names = np.unique(traj).tolist()
        if diff_sized_chunks:
            counts = weighted_transition_counts(traj, concat_limits, lagtime)
        else:
            counts = transition_counts(traj, concat_limits, lagtime)
        tmat = row_normalized(counts, names)

    logger("\n~~~ run mpp\n    iteration   qmin")
    q_min = q_min_from
    while q_min <= q_min_to:
        traj_out, lumping, tmat = fixed_metastability_clustering(
            traj, tmat, float(q_min), free_energy)
        header_qmin = io.append_comments_map(header_comment, comments_map)
        header_qmin += ("#\n# mpp specific parameters: \n"
                        "#    qmin = %0.3f \n" % float(q_min))
        traj = traj_out
        io.write_single_column(
            io.stringprintf("%s_traj_%0.3f.dat", basename, float(q_min)),
            traj, header_qmin)
        for frm, to in lumping.items():
            transitions[frm] = (to, float(q_min))
        pops = io.microstate_populations(traj)
        io.write_map(
            io.stringprintf("%s_pop_%0.3f.dat", basename, float(q_min)),
            pops, header_qmin)
        for state in np.unique(traj).tolist():
            max_pop[state] = pops[state]
            max_qmin[state] = float(q_min)
        q_min = np.float32(q_min + q_min_step)

    header_final = io.append_comments_map(header_comment, comments_map)
    with open(basename + "_transitions.dat", "w") as fh:
        fh.write(header_final)
        fh.write("#\n# Specifies the linkage matrix, so at which qmin value\n"
                 "# which states are lumped.\n# state_i state_j qmin\n")
        for frm in sorted(transitions):
            to, q = transitions[frm]
            fh.write(f"{frm} {to} {io.fmt_float(q)}\n")
    io.write_map(basename + "_max_pop.dat", max_pop, header_final)
    io.write_map(basename + "_max_qmin.dat", max_qmin, header_final)
