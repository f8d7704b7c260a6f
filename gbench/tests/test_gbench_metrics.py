"""The benchmark's arithmetic: the roofline, the trace's union and gap
labels, the percentile over every query, and the readers on a made-up
run."""

import collections
import statistics

import pytest
import torch

from gbench import harness, roofline, stats, trace
from conftest import ROOT

BENCH = harness.Bench(ROOT)


def test_bound_and_bytes():
    # chip_smoke.py's bound: bytes over 3.35 TB/s, flops over 67 TFLOP/s.
    assert roofline.bound(3.35e9)["bound_ms"] == pytest.approx(1.0)
    assert roofline.bound(3.35e9)["bound_by"] == "bytes"
    b = roofline.bound(1e6, 67e9 * 2)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(2.0)
    assert roofline.pull_bytes(100, 10, 3, 2) == 4 * 2 * 100 + 4 * 3 * 10
    assert roofline.bitmask_bytes(33) == 8
    # K1 a level: indices, n + 1 offsets, two masks of n bits.
    n, e = 1000, 5000
    assert roofline.k1_level_bytes(n, e) == 4 * e + 4 * (n + 1) + 2 * 128


def test_union_and_gaps():
    busy, gaps = trace._union([(5, 8), (1, 3), (2, 4), (7, 9), (20, 30)],
                              0, 25)
    assert busy == 3 + 4 + 5
    assert gaps == [(0, 1), (4, 5), (9, 20)]
    busy, gaps = trace._union([], 0, 10)
    assert busy == 0 and gaps == [(0, 10)]


def test_gap_labels_take_the_innermost_open_event():
    host = [("query", 0, 100), ("aten::index", 10, 30), ("span:f", 5, 60),
            ("aten::copy_", 70, 80)]
    got = trace._label_gaps([(12, 18), (40, 50), (72, 74), (90, 95)], host)
    assert got == collections.Counter({"aten::index": 6, "span:f": 10,
                                       "aten::copy_": 2, "query": 5})
    # A gap is split among the events open over its parts.
    got = trace._label_gaps([(25, 65), (78, 100)], host)
    assert got == collections.Counter({"aten::index": 5, "span:f": 30,
                                       "query": 5 + 20, "aten::copy_": 2})
    assert trace._label_gaps([(200, 210)], host) == {"(no host event)": 10}
    assert trace._label_gaps([(95, 110)], host) == {"query": 5,
                                                   "(no host event)": 10}


def test_device_trace_window_from_markers():
    S = trace.SENTINEL
    evs = [(S, True, 0, 1, False), (S, True, 1, 2, False),
           ("k1", True, 3, 5, False), ("Memcpy DtoH", True, 6, 7, False),
           ("gbench.window", True, 2, 9, True), ("k0", True, 0.5, 1.5, False),
           ("cudaStreamSynchronize", False, 5, 6, False),
           ("cudaLaunchKernel", False, 2.5, 2.6, False),
           ("cudaDeviceSynchronize", False, 8, 9.4, False),
           ("cudaLaunchKernel", False, 9.5, 9.6, False),
           (S, True, 10, 11, False)]
    lo, hi = trace._window_of_markers(evs)
    assert (lo, hi) == (2, 10)
    t = trace._device_trace(evs, 2, lo, hi)
    assert [n for n, _, _ in t.device] == ["k1", "Memcpy DtoH"]
    assert t.busy_us == 3 and t.window_us == 8
    assert +t.runtime == {"cudaStreamSynchronize": 1, "cudaLaunchKernel": 1}
    assert trace._window_of_markers(evs[2:-1]) is None


def test_percentile_counts_every_query():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    assert stats.percentile([7.0], 95) == 7.0
    q1, med, q3 = statistics.quantiles([1, 2, 3, 4, 10], n=4)
    assert stats.spread([1, 2, 3, 4, 10]) == (q3 - q1) / med


def _run(trace_obj=None, device="cuda"):
    qs = [harness.Query(root=i, wall_s=0.1 * (i + 1), span_ms=20.0,
                        work=10**8) for i in range(20)]
    return harness.Run(workload={}, config={}, traffic={},
                       device=torch.device(device),
                       spans={"setup_s": 21.0, "build_s": 7.0,
                              "upload_s": 8.0},
                       queries=qs, window_s=21.0,
                       memory_peak_bytes=3 * 2**30, trace=trace_obj,
                       graph={"num_nodes": 1 << 22, "num_edges": 128 << 20})


def _read(name, run):
    return BENCH.plugin("metrics", name).read(run)


def test_end_to_end_readers():
    run = _run()
    assert _read("gteps", run) == pytest.approx(20 * 1e8 / 21.0 / 1e9)
    assert _read("query_p95_ms", run) == pytest.approx(
        stats.percentile([100.0 * (i + 1) for i in range(20)], 95))
    assert _read("peak_mem_gib", run) == 3.0
    assert _read("peak_mem_gib", _run(device="cpu")) is None
    assert _read("setup_s", run) == 21.0
    assert _read("build_s", run) == 7.0 and _read("upload_s", run) == 8.0
    assert _read("entry_ms_per_query", run) == pytest.approx(
        statistics.mean(100.0 * (i + 1) - 20.0 for i in range(20)))


def test_trace_readers():
    k1 = "void (anonymous namespace)::pull_reached_words_kernel(ReachArgs)"
    dev = [(k1, 0.0, 400.0), ("csc_tile_rows_kernel<256>", 400.0, 420.0),
           (k1, 500.0, 900.0), ("Memcpy DtoH (Device -> Pageable)",
                                1000.0, 1100.0),
           ("void at::native::index_elementwise_kernel", 1200.0, 1300.0)]
    t = trace.Trace(queries=2, window=(0.0, 2000.0), device=dev,
                    runtime=collections.Counter(
                        {"cudaStreamSynchronize": 9, "cudaLaunchKernel": 50,
                         "cudaDeviceSynchronize": 1}),
                    busy_us=920.0, idle_by_host=[])
    run = _run(t)
    need = roofline.bound(2 * roofline.k1_level_bytes(1 << 22, 128 << 20))
    assert _read("k1_roofline", run) == pytest.approx(
        100 * need["bound_ms"] / 0.820)
    assert _read("device_idle_pct", run) == pytest.approx(54.0)
    assert _read("host_syncs_per_query", run) == 5.0
    assert _read("operator_device_ms_per_query", run) == pytest.approx(0.05)
    # Nothing to read: no K1 launch, no trace, no device interval.
    t.device = dev[3:]
    assert _read("k1_roofline", run) is None
    for name in ("k1_roofline", "device_idle_pct", "host_syncs_per_query",
                 "operator_device_ms_per_query"):
        assert _read(name, _run(None)) is None


def test_k3_roofline_reads_its_three_passes():
    """K3 a launch: the prologue, pass 1 and pass 2, counted by pass 2;
    its bytes are the CSC's indices and three vectors of a row each."""
    dev = [("void csc_tile_rows_kernel<2048, int>(...)", 0.0, 10.0),
           ("void pull_tiles_kernel<int>(PullArgsT<int>)", 10.0, 900.0),
           ("void pull_finish_kernel<int>(PullArgsT<int>, FinishArgs)",
            900.0, 950.0)] * 3 + [
           ("void at::native::index_elementwise_kernel", 1000.0, 1300.0)]
    t = trace.Trace(queries=1, window=(0.0, 2000.0), device=dev,
                    runtime=collections.Counter(), busy_us=1250.0,
                    idle_by_host=[])
    run = _run(t)
    e, n = 128 << 20, 1 << 22
    need = roofline.bound(3 * (4 * e + 3 * 4 * n))
    assert _read("k3_roofline", run) == pytest.approx(
        100 * need["bound_ms"] / (3 * 0.950))
    t.device = dev[-1:]
    assert _read("k3_roofline", run) is None
    assert _read("k3_roofline", _run(None)) is None
