"""Free-energy network (tree) builder over a screening threshold series.

Mirrors ``Clustering::NetworkBuilder::main`` (reference:
src/network_builder.cpp:379-512): walks ``basename.%0.2f`` files from the
lowest to the highest threshold, remaps state ids to be globally unique,
links every node to its parent at the next free-energy level, prunes by
minimum population and writes links/nodes/leaves/end-node-trajectory files
plus an optional interactive HTML visualization. Deviation from the
reference (documented in docs/PARITY.md row 18): instead of embedding the
reference's 29k-line cytoscape.js application (src/embedded_cytoscape.hpp,
network_builder.cpp:280-372), we emit a self-contained SVG page with
pan/zoom, node hover labels and id search — no third-party JS, fully
offline.
"""

import math
import os
import sys

import numpy as np

from ..utils import io
from ..utils.logger import logger


def save_network_links(fname, network, header_comment, comments_map):
    """Reference: network_builder.cpp:182-192."""
    fname += "_links.dat"
    logger("    saving links in: " + fname)
    hc = io.append_comments_map(header_comment, comments_map)
    hc += ("#\n# Name of the cluster connected to the name in next "
           "higher free energy level\n# Named by the remapped clusters.\n#\n"
           "# cluster_name(fe+step) cluster_name(fe)\n")
    io.write_map(fname, network, hc, val_then_key=True)


def save_node_info(fname, free_energies, pops, header_comment, comments_map):
    """Reference: network_builder.cpp:194-218."""
    fname += "_nodes.dat"
    logger("    saving nodes in: " + fname)
    hc = io.append_comments_map(header_comment, comments_map)
    hc += "#\n# nodes\n"
    hc += ("#\n# Name of all clusters at a given free energies (fe) "
           "with the corresponding populations pop.\n"
           "# id(cluster) fe pop\n")
    with open(fname, "w") as fh:
        fh.write(hc)
        for key in sorted(pops):
            fh.write(f"{key} {io.fmt_float(free_energies[key])}"
                     f" {pops[key]}\n")


def compute_and_save_leaves(fname, network, header_comment, comments_map):
    """Reference: network_builder.cpp:220-248."""
    fname += "_leaves.dat"
    logger("    saving leaves in: " + fname)
    leaves = set()
    not_leaves = set()
    for src in sorted(network):
        target = network[src]
        not_leaves.add(target)
        if src in not_leaves:
            leaves.discard(src)
        else:
            leaves.add(src)
    hc = io.append_comments_map(header_comment, comments_map)
    hc += ("#\n# All network leaves, i.e. nodes (microstates) without child\n"
           "# nodes at a lower free energy level. These microstates"
           " represent\n"
           "# the minima of their local basins.\n#\n"
           "# id(cluster)\n")
    io.write_single_column(fname, sorted(leaves), hc)
    return leaves


def save_traj_of_leaves(fname, leaves, d_min, d_max, d_step, remapped_name,
                        n_rows, header_comment, comments_map,
                        remapped_cache=None):
    """Reference: network_builder.cpp:250-278. ``remapped_cache`` holds
    the remapped trajectories main() just wrote (same values as the
    files), so the walk skips re-reading what is already in memory."""
    fname += "_end_node_traj.dat"
    logger("    saving end-node trajectory in: " + fname)
    traj = np.zeros(n_rows, dtype=np.int64)
    prec = np.float32(d_step) / np.float32(10.0)
    d = np.float32(d_min)
    leaf_arr = np.asarray(sorted(leaves), dtype=np.int64)
    while not (d <= d_max + d_step + prec and d >= d_max + d_step - prec):
        rname = io.stringprintf(remapped_name, float(d))
        cl_now = (remapped_cache or {}).get(rname)
        if cl_now is None:
            cl_now = io.read_clustered_trajectory(rname)
        if len(leaf_arr):
            is_leaf = np.isin(cl_now, leaf_arr)
            traj = np.where(is_leaf, cl_now, traj)
        d = np.float32(d + d_step)
    hc = io.append_comments_map(header_comment, comments_map)
    hc += ("#\n# All frames beloning to a leaf node are marked with\n"
           "# the custer id. All others with zero.\n")
    hc += "#\n# state/cluster id frames are assigned to\n"
    io.write_single_column(fname, traj, hc)


# --------------------------------------------------------------------------
# HTML visualization (tree layout + cytoscape.js template)
# --------------------------------------------------------------------------

_HORIZONTAL_SPACING = 10
_VERTICAL_SPACING = 50


class _Node:
    """Tree node for the visualization layout
    (reference: network_builder.cpp:63-179)."""

    __slots__ = ("id", "fe", "pop", "children", "pos_x", "pos_y", "_width")

    def __init__(self, node_id=0, fe=0.0, pop=0):
        self.id = node_id
        self.fe = fe
        self.pop = pop
        self.children = {}
        self.pos_x = 0
        self.pos_y = 0
        self._width = 0

    def find_parent_of(self, search_id):
        if search_id in self.children:
            return self
        for child in self.children.values():
            found = child.find_parent_of(search_id)
            if found is not None:
                return found
        return None

    def subtree_width(self):
        if not self._width:
            self_width = 10 + 2 * _HORIZONTAL_SPACING
            total = sum(c.subtree_width() for c in self.children.values())
            self._width = max(total, self_width)
        return self._width

    def set_pos(self, x, y):
        self.pos_x = x
        self.pos_y = y
        total = sum(c.subtree_width() for c in self.children.values())
        cur_x = int(x - 0.5 * total)
        for cid in sorted(self.children):
            child = self.children[cid]
            stw = child.subtree_width()
            child.set_pos(int(cur_x + 0.5 * stw), y + _VERTICAL_SPACING)
            cur_x += stw

    def serialize(self, nodes, edges):
        log_pop = math.log(self.pop) if self.pop > 0 else 0.0
        nodes.append(
            '{"id":%d,"x":%d,"y":%d,"pop":%d,"fe":%f,"logpop":%0.2f}'
            % (self.id, self.pos_x, self.pos_y, self.pop, self.fe, log_pop))
        for cid in sorted(self.children):
            edges.append('{"s":%d,"t":%d}' % (cid, self.id))

    def serialize_subtree(self, nodes, edges):
        for cid in sorted(self.children):
            child = self.children[cid]
            child.serialize(nodes, edges)
            child.serialize_subtree(nodes, edges)


# Self-contained SVG viewer -- no external scripts, so the file works
# offline exactly like the reference's embedded-cytoscape page
# (src/embedded_cytoscape.hpp) without shipping a 29k-line payload.
# Node size maps log(pop) to [5, 30] px and color maps fe blue->red,
# the same mappings the reference configures (network_builder.cpp:300-340).
_HTML_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<title>clustering-tpu network</title>
<meta charset="utf-8"/>
<style>
  body {{ margin: 0; font-family: sans-serif; }}
  svg {{ width: 100vw; height: 100vh; display: block; cursor: grab; }}
  #info {{ position: fixed; top: 8px; left: 8px; background: #222;
          color: #0f0; padding: 4px 10px; font-size: 18px;
          border-radius: 4px; pointer-events: none; }}
  #find {{ position: fixed; top: 8px; right: 8px; font-size: 16px;
          padding: 4px 8px; width: 10em; }}
</style>
</head>
<body>
<div id="info">click a state</div>
<input id="find" type="text" placeholder="find state id&#8629;"/>
<svg id="net" xmlns="http://www.w3.org/2000/svg">
  <defs><marker id="arr" viewBox="0 0 10 10" refX="9" refY="5"
    markerWidth="6" markerHeight="6" orient="auto-start-reverse">
    <path d="M 0 0 L 10 5 L 0 10 z" fill="#999"/></marker></defs>
  <g id="view"></g>
</svg>
<script>
var NODES = [{nodes}];
var EDGES = [{edges}];
var FE_MIN = {fe_min:f}, FE_MAX = {fe_max:f};
var LP_MIN = {logpop_min:.2f}, LP_MAX = {logpop_max:.2f};
function lerp(a, b, t) {{ return a + (b - a) * Math.min(Math.max(t, 0), 1); }}
function radius(n) {{
  var t = LP_MAX > LP_MIN ? (n.logpop - LP_MIN) / (LP_MAX - LP_MIN) : 0.5;
  return lerp(2.5, 15, t);
}}
function color(n) {{
  var t = FE_MAX > FE_MIN ? (n.fe - FE_MIN) / (FE_MAX - FE_MIN) : 0.5;
  return 'rgb(' + Math.round(lerp(0, 255, t)) + ',0,'
       + Math.round(lerp(255, 0, t)) + ')';
}}
var svg = document.getElementById('net');
var view = document.getElementById('view');
var byId = {{}};
NODES.forEach(function (n) {{ byId[n.id] = n; }});
EDGES.forEach(function (e) {{
  var s = byId[e.s], t = byId[e.t];
  if (!s || !t) return;
  var l = document.createElementNS(svg.namespaceURI, 'line');
  l.setAttribute('x1', s.x); l.setAttribute('y1', s.y);
  l.setAttribute('x2', t.x); l.setAttribute('y2', t.y);
  l.setAttribute('stroke', '#999'); l.setAttribute('stroke-width', '2');
  l.setAttribute('marker-end', 'url(#arr)');
  view.appendChild(l);
}});
NODES.forEach(function (n) {{
  var c = document.createElementNS(svg.namespaceURI, 'circle');
  c.setAttribute('cx', n.x); c.setAttribute('cy', n.y);
  c.setAttribute('r', radius(n)); c.setAttribute('fill', color(n));
  c.style.cursor = 'pointer';
  var tip = document.createElementNS(svg.namespaceURI, 'title');
  tip.textContent = n.id + ': fe=' + n.fe.toFixed(2) + ', pop=' + n.pop;
  c.appendChild(tip);
  c.addEventListener('click', function (ev) {{
    document.getElementById('info').textContent =
      n.id + ': fe=' + n.fe.toFixed(2) + ', pop=' + n.pop;
    ev.stopPropagation();
  }});
  n.el = c;
  view.appendChild(c);
}});
document.getElementById('find').addEventListener('keydown', function (ev) {{
  if (ev.key !== 'Enter') return;
  var n = byId[parseInt(this.value, 10)];
  var info = document.getElementById('info');
  if (!n) {{ info.textContent = 'state ' + this.value + ' not found'; return; }}
  info.textContent = n.id + ': fe=' + n.fe.toFixed(2) + ', pop=' + n.pop;
  var w = Math.max(vb[2], 1);
  vb = [n.x - w / 2, n.y - vb[3] / 2, vb[2], vb[3]];
  setVB();
  n.el.setAttribute('stroke', '#0f0'); n.el.setAttribute('stroke-width', 4);
  setTimeout(function () {{ n.el.removeAttribute('stroke'); }}, 1500);
}});
var xs = NODES.map(function (n) {{ return n.x; }});
var ys = NODES.map(function (n) {{ return n.y; }});
var pad = 60;
var vb = NODES.length ? [Math.min.apply(null, xs) - pad,
                         Math.min.apply(null, ys) - pad,
                         Math.max.apply(null, xs) - Math.min.apply(null, xs) + 2 * pad,
                         Math.max.apply(null, ys) - Math.min.apply(null, ys) + 2 * pad]
                      : [0, 0, 100, 100];
function setVB() {{ svg.setAttribute('viewBox', vb.join(' ')); }}
setVB();
svg.addEventListener('wheel', function (ev) {{
  ev.preventDefault();
  var k = ev.deltaY > 0 ? 1.2 : 1 / 1.2;
  var mx = vb[0] + vb[2] * ev.offsetX / svg.clientWidth;
  var my = vb[1] + vb[3] * ev.offsetY / svg.clientHeight;
  vb = [mx - (mx - vb[0]) * k, my - (my - vb[1]) * k, vb[2] * k, vb[3] * k];
  setVB();
}});
var drag = null;
svg.addEventListener('mousedown', function (ev) {{
  drag = [ev.clientX, ev.clientY];
}});
window.addEventListener('mousemove', function (ev) {{
  if (!drag) return;
  vb[0] -= (ev.clientX - drag[0]) * vb[2] / svg.clientWidth;
  vb[1] -= (ev.clientY - drag[1]) * vb[3] / svg.clientHeight;
  drag = [ev.clientX, ev.clientY];
  setVB();
}});
window.addEventListener('mouseup', function () {{ drag = null; }});
</script>
</body>
</html>
"""


def save_network_to_html(fname, network, free_energies, pops):
    """Reference: network_builder.cpp:280-372 (tree construction + layout);
    the page itself is our self-contained SVG viewer template (deviation
    from the reference's embedded cytoscape.js app — docs/PARITY.md #18)."""
    logger("\n~~~ computing network visualization")
    fe_vals = list(free_energies.values())
    pop_vals = list(pops.values())
    fe_min, fe_max = min(fe_vals), max(fe_vals)
    pop_min, pop_max = min(pop_vals), max(pop_vals)
    fake_root = _Node()
    for i_from in sorted(network):
        i_to = network[i_from]
        parent_to = fake_root.find_parent_of(i_to)
        if parent_to is None:
            # top-level nodes have no own fe/pop entry; the reference's
            # std::map operator[] defaults them to zero
            fake_root.children[i_to] = _Node(i_to,
                                             free_energies.get(i_to, 0.0),
                                             pops.get(i_to, 0))
            parent_to = fake_root
        parent_from = fake_root.find_parent_of(i_from)
        if parent_from is not None:
            parent_to.children[i_to].children[i_from] = \
                parent_from.children[i_from]
            del parent_from.children[i_from]
        else:
            parent_to.children[i_to].children[i_from] = _Node(
                i_from, free_energies.get(i_from, 0.0), pops.get(i_from, 0))
    logger("    ...done")
    fake_root.set_pos(0, 0)
    nodes, edges = [], []
    fake_root.serialize_subtree(nodes, edges)
    log_pop_min = math.log(pop_min) if pop_min > 0 else 0.0
    log_pop_max = math.log(pop_max) if pop_max > 0 else 0.0
    with open(fname + "_visualization.html", "w") as fh:
        fh.write(_HTML_TEMPLATE.format(
            logpop_min=log_pop_min, logpop_max=log_pop_max,
            fe_min=fe_min, fe_max=fe_max,
            nodes=",\n".join(nodes), edges=",\n".join(edges)))


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def main(args, header_comment, comments_map):
    d_min = np.float32(args.min)
    d_max = np.float32(args.max)
    d_step = np.float32(args.step)
    basename = args.basename + ".%0.2f"
    remapped_name = "remapped_" + basename
    minpop = int(args.minpop)

    network = {}
    pops = {}
    free_energies = {}

    fname_next = io.stringprintf(basename, float(d_min))
    if not os.path.exists(fname_next):
        print(f"error: file does not exist: {fname_next}"
              "       check basename (-b) and --min/--max/--step",
              file=sys.stderr)
        sys.exit(0)
    io.read_comments(fname_next, comments_map)
    cl_next = io.read_clustered_trajectory(fname_next)
    n_rows = len(cl_next)
    prec = d_step / np.float32(10.0)
    if d_max == 0.0:
        if comments_map["screening_to"] > 0:
            d_max = np.float32(comments_map["screening_to"] + d_step)
        else:
            d_max = np.float32(np.finfo(np.float32).max)
    else:
        d_max = np.float32(d_max + d_step)

    logger("~~~ remapping cluster files and generating network")
    d = d_min
    # overlap writing level d with reading/processing level d+1 (the
    # reference pipelines the same way with 2 OpenMP threads,
    # network_builder.cpp:438-464); files are distinct, so all writes can
    # be in flight at once
    from concurrent.futures import ThreadPoolExecutor
    # the end-node-trajectory walk revisits every remapped file; keep
    # them in memory (bounded) so it never re-reads what we just wrote
    remapped_cache = {}
    cache_budget = 512 << 20
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = []
        while d < d_max - prec and os.path.exists(fname_next):
            rname = io.stringprintf(remapped_name, float(d))
            logger("    " + fname_next + " -> " + rname)
            cl_now = cl_next
            fname_next = io.stringprintf(basename, float(d + d_step))
            pending.append(pool.submit(
                io.write_clustered_trajectory, rname,
                cl_now, header_comment, comments_map))
            if cl_now.nbytes <= cache_budget:
                remapped_cache[rname] = cl_now
                cache_budget -= cl_now.nbytes
            if os.path.exists(fname_next):
                cl_next = io.read_clustered_trajectory(fname_next)
                max_id = int(cl_now.max())
                nz = cl_next != 0
                cl_next = np.where(nz, cl_next + max_id, cl_next)
                both = nz & (cl_now != 0)
                idx = np.flatnonzero(both)
                # row order, later rows win -- dict() keeps the last
                # occurrence, matching the reference's sequential stores
                network.update(zip(cl_now[idx].tolist(),
                                   cl_next[idx].tolist()))
                vals, counts = np.unique(cl_now[both], return_counts=True)
                for v, c in zip(vals.tolist(), counts.tolist()):
                    pops[v] = pops.get(v, 0) + c
                    free_energies[v] = float(d)
            d = np.float32(d + d_step)
        for fut in pending:
            fut.result()
    d_max = np.float32(d - d_step)

    # only after every in-flight write captured the pre-network metadata
    comments_map["minimal_population"] = float(minpop)
    if minpop > 1:
        logger(f"\n~~~ removing states with population p < {minpop}")
        logger("    ... removing nodes")
        removals = {k for k, v in pops.items() if v < minpop}
        for k in removals:
            del pops[k]
        logger("    ... removing edges")
        network = {a: b for a, b in network.items()
                   if a not in removals and b not in removals}

    logger("\n~~~ storing output files")
    save_network_links(args.output, network, header_comment, comments_map)
    save_node_info(args.output, free_energies, pops, header_comment,
                   comments_map)
    leaves = compute_and_save_leaves(args.output, network, header_comment,
                                     comments_map)
    save_traj_of_leaves(args.output, leaves, d_min, float(d_max),
                        float(d_step), remapped_name, n_rows,
                        header_comment, comments_map,
                        remapped_cache=remapped_cache)
    if args.network_html:
        save_network_to_html(args.output, network, free_energies, pops)
