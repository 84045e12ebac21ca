"""Reduction of traces, logs and files to metrics, on canned inputs."""

from types import SimpleNamespace

import numpy as np
import pytest

from bench_port import spec as specs
from bench_port import stages, textfiles, trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# a job's trace: stages at 0-1000 and 1500-3000 us (gap 1000-1500 with no
# annotation), kernels overlapping at 100-400 and 300-600, a copy at
# 2000-2100, one kernel outside the window
EVENTS = [
    ev("user_annotation", "populations", 0, 1000),
    ev("user_annotation", "nearest neighbors", 1500, 1500),
    ev("user_annotation", "helper", 2500, 400),
    ev("kernel", "void ns::pops_bidir_kernel<4, 1>(float const*)", 100, 300),
    ev("kernel", "void ns::nn_bidir_kernel<4>(float const*)", 300, 300),
    ev("gpu_memcpy", "Memcpy DtoH", 2000, 100),
    ev("kernel", "late", 5000, 100),
    ev("cpu_op", "aten::add", 0, 5000),
]


def test_summary_of_a_canned_trace():
    s = trace.summarize(EVENTS, {"populations", "nearest neighbors"})
    assert s["window_s"] == pytest.approx(3000e-6)
    assert s["busy_s"] == pytest.approx(600e-6)  # 100-600 and 2000-2100
    assert s["kernel_busy_s"] == pytest.approx(500e-6)
    # gaps 0-100 (in populations), 600-2000 (its middle between the
    # stages) and 2100-3000 (helper, the innermost annotation open at its
    # middle)
    assert s["idle_gaps"] == [["no annotation @0.001s", 1400e-6],
                              ["helper @0.002s", 900e-6],
                              ["populations @0.000s", 100e-6]]
    assert s["device_ops"][0] == [
        "void ns::pops_bidir_kernel<4, 1>(float const*)", 300e-6]
    assert "late" not in dict(s["device_ops"])
    assert trace.summarize(EVENTS, {"absent"}) is None


def reader(name):
    return specs.metric_reader(name)


def test_trace_metrics_and_roofline():
    s = trace.summarize(EVENTS, {"populations", "nearest neighbors"})
    ctx = SimpleNamespace(trace=s, pops_sum=10 + 2 * 1_000_000, n=10,
                          dim=4)
    assert reader("device.idle_share")(ctx) == pytest.approx(0.8)
    assert reader("kernels.busy_s")(ctx) == pytest.approx(500e-6)
    # 1e6 pairs x 12 flops / 67e12 over the pops kernel's 300 us
    want = 100 * 12e6 / 67e12 / 300e-6
    assert reader("kernels.pops_roofline")(ctx) == pytest.approx(want)
    ctx.trace = dict(s, kernels=[("other", (0, 1))])
    assert reader("kernels.pops_roofline")(ctx) is None
    ctx.trace = None
    assert reader("device.idle_share")(ctx) is None


LOG = """~~~ free energy and population
    [pops: 196 tiles computed = 25.7% of N^2 incl. padding]
    [populations: 0.504s]
      [populations substages: t_best_sort=0.035, t_plan=0.036, t_sweep=0.467]
    [nn: 480 tiles computed = 62.9% of N^2 incl. padding, tiered phase 2]
    [nearest neighbors: 3.910s]
    [screening setup: 0.100s]
    [screener built during nearest neighbors in 0.029s]
    [screening fixpoint: 3 sweeps, 7 tiles/sweep, 21 swept, bidir]
    [screening 0.50: 0.065s]
    [screening 1.00: 0.277s]
"""


def test_log_metrics():
    assert stages.walls(LOG) == {"populations": 0.504,
                                 "nearest neighbors": 3.91,
                                 "screening setup": 0.1,
                                 "screening 0.50": 0.065,
                                 "screening 1.00": 0.277}
    jobs = [{"measured": dict(stages.measured(LOG, wall), maxrss=rss)}
            for wall, rss in ((6.0, 3e9), (7.0, 4e9))]
    ctx = SimpleNamespace(jobs=jobs)
    assert reader("nn.tiles")(ctx) == 480
    assert reader("populations.best_sort_s")(ctx) == pytest.approx(0.035)
    assert reader("screening.wall_s")(ctx) == pytest.approx(0.442)
    assert reader("screening.setup_s")(ctx) == pytest.approx(0.1)
    assert reader("cli.outside_stages_s")(ctx) == pytest.approx(
        6.5 - 0.504 - 3.91 - 0.442)
    assert reader("peak_host_GB")(ctx) == pytest.approx(4.0)
    api = SimpleNamespace(jobs=[{"wall": 2.0, "measured": {
        "populations": 0.51, "nearest_neighbors": 0.3, "screening": 1.0}}])
    assert reader("populations.wall_s")(api) == pytest.approx(0.51)
    assert reader("nn.wall_s")(api) == pytest.approx(0.3)
    assert reader("cli.outside_stages_s")(api) is None
    assert reader("peak_host_GB")(api) is None
    # a log without a stage gives nothing to read, not 0
    assert stages.measured("[populations: 1.0s]", 2.0)["screening"] is None


def test_text_tables(tmp_path):
    path = tmp_path / "nn"
    rows = [(5, 1.5e-05, 0, 0.0), (12, 0.00126656, 3, 2.5),
            (0, 6.80222e-18, 9999999, 123456.0)]
    path.write_text("# header\n# Created now\n" + "".join(
        f"{a} {b:g} {c} {d:g}\n" for a, b, c, d in rows))
    got = textfiles.read_table(str(path), 4)
    assert np.array_equal(got, np.asarray(rows, dtype=np.float64))
    digest = textfiles.body_digest(str(path))
    path.write_text("# header\n# Created later\n" + "".join(
        f"{a} {b:g} {c} {d:g}\n" for a, b, c, d in rows))
    assert textfiles.body_digest(str(path)) == digest
    fe = np.asarray([0.0, 1.234567, 9.87654321, 1e-7], dtype=np.float32)
    text = "".join("%e\n" % float(v) for v in -np.log(np.exp(-fe)))
    assert np.array_equal(textfiles.parse_numbers(text.encode()),
                          np.asarray(text.split(), dtype=np.float64))
    with pytest.raises(ValueError):
        textfiles.parse_numbers(b"1 2 nan\n")
