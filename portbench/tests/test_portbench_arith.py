"""The yardstick's arithmetic on a synthetic trace: idle share, gaps and
their labels, span subtraction, roofline and mfu."""
import pytest

from pbench import devtrace, spans, work
from pbench.main import Run


def ev(name, cat, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def synthetic():
    # markers at 1000 us and 11000 us (host clock 100.0 s at the first);
    # a 1 ms copy, a 2 ms kernel overlapping it by 0.5 ms, a 1 ms kernel
    raw = [ev("mark", "kernel", 1000, 10),
           ev("Memcpy HtoD", "gpu_memcpy", 2000, 1000),
           ev("bsmm_pairs_kernel<32, float>", "kernel", 2500, 2000),
           ev("run_offsets_kernel", "kernel", 7000, 1000),
           ev("cpu_op", "cpu_op", 3000, 5000),
           ev("mark", "kernel", 11000, 10)]
    return devtrace.from_chrome_events(raw, 100.0)


def test_idle_share_is_one_minus_the_union_over_the_window():
    t = synthetic()
    assert t.window_s == pytest.approx(0.00999)
    assert t.busy_s == pytest.approx(0.0035)
    assert t.idle_share == pytest.approx(1 - 0.0035 / 0.00999)
    assert t.kernel_s() == pytest.approx(0.003)
    assert t.kernel_s(("bsmm_pairs_kernel",)) == pytest.approx(0.002)
    assert [n for n, _ in t.top_ops(2)] == ["bsmm_pairs_kernel<32, float>",
                                           "Memcpy HtoD"]
    gaps = [(round(a - 100, 5), round(b - 100, 5)) for a, b in t.gaps()]
    assert gaps == [(0.00001, 0.001), (0.0035, 0.006), (0.007, 0.01)]


def test_gap_labels_follow_the_host_span_open():
    sp = [("register", 100.0, 100.0035), ("flush", 100.0035, 100.008),
          (spans.DISPATCH, 100.0065, 100.0075)]
    assert spans.label_at(sp, 100.001) == "register"
    assert spans.label_at(sp, 100.004) == "pack"
    assert spans.label_at(sp, 100.007) == "dispatch"
    assert spans.label_at(sp, 100.009) == "between"
    assert spans.label_gap(sp, 100.0035, 100.0066) == "pack"


def test_span_subtraction():
    sp = [("flush", 0.0, 1.0), (spans.DISPATCH, 0.2, 0.3),
          (spans.DISPATCH, 0.5, 0.6), ("flush", 2.0, 3.0),
          (spans.DISPATCH, 2.5, 2.75), (spans.DISPATCH, 5.0, 6.0)]
    assert spans.total(sp, "flush") == pytest.approx(2.0)
    assert spans.within(sp, spans.DISPATCH, "flush") == pytest.approx(0.45)
    assert spans.self_time(sp, "flush", spans.DISPATCH) == pytest.approx(1.55)


def test_recorder_closes_spans_in_order():
    t = iter([1.0, 2.0, 3.0, 5.0])
    rec = spans.Recorder(lambda: next(t))
    with rec.span("register"):
        pass
    with rec.span("flush"):
        pass
    assert rec.spans == [("register", 1.0, 2.0), ("flush", 3.0, 5.0)]


def test_least_time_roofline_and_mfu():
    import numpy as np
    keys = np.array([[0, 0], [0, 1], [1, 1]])
    # three pairs over A blocks {0, 1} and B blocks {0, 2}, 2 C blocks
    w = work.product_work(keys, keys, np.array([0, 1, 1]),
                          np.array([0, 2, 2]), 2, 32, symmetric=False)
    assert w.flops == 3 * 2 * 32 ** 3
    assert w.bytes == (2 + 2 + 2) * 32 * 32 * 4
    # symmetric: (0, 1) read as A and (1, 0) would be one stored block
    ws = work.product_work(keys, keys, np.array([0, 1]), np.array([1, 2]),
                           2, 32, symmetric=True)
    assert ws.input_blocks == 3
    least, bound = work.least_s(w)
    assert bound == "bytes"
    assert least == pytest.approx(w.bytes / 3.35e12)
    assert work.least_s(w, chips=4)[0] == pytest.approx(least / 4)
    t = synthetic()
    run = Run(products=2, product_s=0.5, chips=1, work=w, spans=[],
              traces=[t], counters=[])
    names = ("bsmm_pairs_kernel", "run_offsets_kernel")
    assert work.roofline_pct(run, names) == pytest.approx(
        100 * least / (0.003 / 2))
    assert work.roofline_pct(run, ("batched_gemm_kernel",)) is None
    assert work.roofline_pct(Run(products=2, product_s=0.5, chips=1, work=w,
                                 spans=[], traces=[], counters=[]),
                             names) is None
    from pbench.bench import HERE, load_metric
    mfu = load_metric(HERE, "mfu").read(run)
    assert mfu == pytest.approx(100 * w.flops / (0.5 * 165e12))
    assert load_metric(HERE, "idle_share").read(run) == pytest.approx(
        100 * t.idle_share)


def test_comm_mb_reads_the_busiest_rank():
    from pbench.bench import HERE, load_metric
    c = {"fetched_bytes": [0, 10, 0, 0],
         "collective_bytes": [2_000_000, 3_000_000, 1_000_000, 0]}
    run = Run(products=2, product_s=1.0, chips=4, work=None, spans=[],
              traces=[], counters=[c])
    assert load_metric(HERE, "comm_mb").read(run) == pytest.approx(1.500005)
    run.counters = []
    assert load_metric(HERE, "comm_mb").read(run) is None
