"""Finding a cell's parts by the names that ``BENCHMARK.json`` gives them.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the traffic names the entry that its jobs
go through (``entries/<entry>.py``); the configuration names its plain
reference (``reference/<reference>.py``); each metric is read by
``metrics/<metric name>.py``, a module with ``read(ctx)`` that returns the
metric's value or None where it finds nothing to read. A later cell,
configuration, traffic mix, entry or metric is a new file and a new entry
in ``BENCHMARK.json``; no file here changes.
"""

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def benchmark(root=ROOT):
    return _json(root, "BENCHMARK.json")


def cell(spec, name):
    for c in spec["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name, here=HERE):
    return _json(here, "configs", name + ".json")


def traffic(name, here=HERE):
    return _json(here, "traffic", name + ".json")


def entry(name):
    return importlib.import_module(f"bench_port.entries.{name}")


def reference(name):
    return importlib.import_module(f"bench_port.reference.{name}")


def metric_reader(name, here=HERE):
    """The ``read`` function of ``metrics/<name>.py`` (metric names hold
    dots, so the file is loaded by its path)."""
    path = os.path.join(here, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "bench_port.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def metrics_of(spec, cell_name, kind):
    """The ``kind`` ("end_to_end" or "per_layer") metrics that the cell
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in spec[kind]
            if cell_name in m.get("workloads", [cell_name])]
