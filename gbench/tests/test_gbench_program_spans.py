"""The readers of the program's spans and counters on made-up runs: idle
inside and outside spans, kernels attributed to a span by the launch
their correlation id names, and a program that keeps none of it."""

import collections

import pytest
import torch

from gbench import harness, program_spans as ps, trace
from conftest import ROOT

BENCH = harness.Bench(ROOT)
TRAFFIC = {"entry": {"call": "gunrock_tpu_torch.bfs"}}
FILL = "void at_cuda_detail::cub::DeviceSegmentedReduceKernel"


def _read(name, run):
    return BENCH.plugin("metrics", name).read(run)


def _run(t=None, device="cuda"):
    return harness.Run(workload={}, config={}, traffic=TRAFFIC,
                       device=torch.device(device), spans={}, queries=[],
                       window_s=0.0, memory_peak_bytes=0, trace=t, graph={})


def _span_trace():
    """One query over [0, 1000] us: a push level [100, 300] whose kernel
    runs [120, 200], a pull level [300, 500] with none, a pred fill
    [500, 700] launching a kernel that runs [690, 760], past its span,
    then the copy [700, 800] (a copy [710, 790]) and the record [800,
    900], the call [50, 950]. The device is idle over [0, 120], [200,
    690] and [790, 1000]."""
    spans = [(1, None, 1, "bfs", 50.0, 950.0, {}),
             (2, 1, 1, "bfs.process", 80.0, 700.0, {}),
             (3, 2, 1, "bfs.level", 100.0, 300.0, {"kind": "push"}),
             (4, 2, 1, "bfs.level", 300.0, 500.0, {"kind": "pull"}),
             (5, 2, 1, "bfs.fill_preds", 500.0, 700.0, {}),
             (6, 1, 1, "bfs.copy", 700.0, 800.0, {}),
             (7, 1, 1, "bfs.record", 800.0, 900.0, {})]
    device = [("bitmask_gather_kernel", 120.0, 200.0),
              (FILL, 690.0, 760.0),
              ("Memcpy DtoH (Device -> Pageable)", 710.0, 790.0)]
    return ps.SpanTrace(queries=1, window=(0.0, 1000.0), device=device,
                        runtime=collections.Counter(), busy_us=180.0,
                        idle_by_host=[], spans=spans,
                        launch_us=[110.0, 510.0, 705.0],
                        syncs_us=[150.0, 250.0, 600.0, 720.0], wall_s=0.001)


def test_loop_idle_takes_process_less_fill_over_levels():
    t = _span_trace()
    # Idle in bfs.process [80, 700]: 80-120, 200-690 = 530; in the
    # fill [500, 690] = 190; (530 - 190) us over 2 levels.
    assert _read("loop_idle_ms_per_level", _run(t)) == pytest.approx(0.170)
    t.spans = [sp for sp in t.spans if sp[3] != "bfs.level"]
    assert _read("loop_idle_ms_per_level", _run(t)) is None


def test_pred_fill_counts_kernels_launched_inside_its_span():
    t = _span_trace()
    # The fill's kernel counts whole, though it ends past the span; the
    # copy launched inside the copy span and the push level's kernel do
    # not count.
    assert _read("pred_fill_device_ms_per_query",
                 _run(t)) == pytest.approx(0.070)
    t.launch_us = [110.0, None, 705.0]     # unmatched: not the fill's
    assert _read("pred_fill_device_ms_per_query", _run(t)) == 0.0
    t.queries = 2
    t.launch_us = [510.0, 520.0, 705.0]
    assert _read("pred_fill_device_ms_per_query",
                 _run(t)) == pytest.approx((0.080 + 0.070) / 2)


def test_idle_by_kind_labels_each_gap_by_its_innermost_span():
    got = ps.idle_by_kind(_span_trace())
    assert got == pytest.approx({
        "push": 0.020 + 0.100, "pull": 0.200, "fill_preds": 0.190,
        "process_rest": 0.020, "copy": 0.010, "record": 0.100,
        "entry": 0.030 + 0.050, "outside": 0.050 + 0.050})
    assert sum(got.values()) == pytest.approx(1.0 - 0.180)


def test_syncs_and_launch_shares_inside_spans():
    t = _span_trace()
    assert ps.syncs_inside(t, "bfs.process") == 3
    assert ps.syncs_inside(t, "bfs.copy") == 1
    assert ps.launched_inside_share(t, "bfs.level") == 0.5
    assert ps.launched_inside_share(t, "bfs") == 1.0
    assert ps.launched_inside_share(t, "bfs.sweeps") is None


def test_span_readers_read_nothing_from_the_harness_trace():
    t = trace.Trace(queries=2, window=(0.0, 10.0),
                    device=[("k", 1.0, 2.0)], runtime=collections.Counter(),
                    busy_us=1.0, idle_by_host=[])
    for name in ("loop_idle_ms_per_level", "pred_fill_device_ms_per_query"):
        assert _read(name, _run(t)) is None
        assert _read(name, _run(None)) is None


def test_span_trace_matches_launches_by_correlation():
    S = trace.SENTINEL
    evs = [(S, True, 0, 1, False, 0), (S, True, 1, 2, False, 0),
           ("cudaLaunchKernel", False, 3.0, 3.5, False, 7),
           ("cudaMemcpyAsync", False, 5.0, 5.5, False, 8),
           ("cudaStreamSynchronize", False, 5.6, 6.5, False, 9),
           ("k1", True, 4, 5, False, 7),
           ("Memcpy DtoH", True, 6, 6.4, False, 8),
           ("k2", True, 7, 8, False, 11),
           (S, True, 10, 11, False, 0)]
    records = [(1, None, 1, "bfs", 2500, 9000, {})]
    t = ps.span_trace(evs, records, 1, 0.5)
    assert [n for n, _, _ in t.device] == ["k1", "Memcpy DtoH", "k2"]
    assert t.launch_us == [3.0, 5.0, None]
    assert t.syncs_us == [5.6]
    assert t.spans == [(1, None, 1, "bfs", 2.5, 9.0, {})]
    assert t.busy_us == pytest.approx(2.4) and t.wall_s == 0.5
    assert ps.span_trace(evs[2:-1], records, 1, 0.5) is None


class _Program:
    """Stands in for the program's counts and splits."""

    def __init__(self, counts, splits):
        self.counts, self.splits = counts, splits

    def __call__(self, dotted):
        return {ps.COUNTS: self.counts, ps.SPLITS: self.splits}.get(dotted)


def test_counter_readers(monkeypatch):
    monkeypatch.setattr(ps, "program", _Program(
        {"host_reads": 950, "levels": 100},
        {"bfs.copy": [4, 0.040], "bfs.record": [4, 0.100],
         "bfs.process": [4, 2.0]}))
    run = _run()
    assert _read("host_reads_per_level", run) == 9.5
    assert _read("copy_ms_per_query", run) == pytest.approx(10.0)
    assert _read("record_ms_per_query", run) == pytest.approx(25.0)
    for name in ("host_reads_per_level", "copy_ms_per_query",
                 "record_ms_per_query"):
        assert _read(name, _run(device="cpu")) is None


@pytest.mark.parametrize("counts,splits", [
    (None, None), ({"host_reads": 0, "levels": 0}, {}),
    ({"host_reads": 5, "levels": 0}, {"bfs.process": [1, 0.1]})])
def test_counter_readers_of_a_program_without_them(monkeypatch, counts,
                                                   splits):
    """The parent's program: no counts or splits, or none of a query."""
    monkeypatch.setattr(ps, "program", _Program(counts, splits))
    for name in ("host_reads_per_level", "copy_ms_per_query",
                 "record_ms_per_query"):
        assert _read(name, _run()) is None


def test_program_names_resolve_or_read_none():
    import gunrock_tpu_torch.enactor as E
    assert ps.program(ps.COUNTS) is E.COUNTS
    assert ps.program(ps.SPLITS) is E.SPLITS
    assert ps.program(ps.TRACING) is E.tracing
    assert ps.program("gunrock_tpu_torch.enactor.NO_SUCH_NAME") is None
