"""The program's own spans against the benchmark's: each lies inside its
harness twin, the harness's readings of a fixed span list stay as they
are, and on the card the device trace and the program's spans share one
clock (every kernel of the multiply runs inside a ``kernel.dispatch``)."""
import time

import pytest

from pbench import bench, cell as cellmod, spans
from pbench.main import Run

CELLS = ["banded.eager", "overlap_s2.eager", "overlap_s2.replay"]
#: the harness span each program span lies inside, by the program's name
TWIN = {"engine.flush": "flush", "engine.wave": "flush",
        "engine.gather": "flush", "engine.scatter": "flush",
        "engine.host_fill": "flush", "kernel.dispatch": "flush",
        "copy.h2d": "flush", "copy.d2h": "flush",
        "qt.multiply": "register", "qt.sym_square": "register",
        "plan.run": "rebind", "plan.rebind": "rebind",
        "plan.replay": "rebind"}


def _cell_parts(root, name):
    b = bench.load_benchmark(root)
    c = bench.find_cell(b, name)
    cfg = bench.load_config(root, b, c["config"])
    return cfg, bench.load_mix(bench.HERE, c["traffic"])


def _traced_products(root, name, products=2):
    """The harness's host spans and the program's (on the same clock) of
    ``products`` products after a warm one, on the host."""
    from repro_torch import Session
    from repro_torch.core.engine import TorchEngine
    from repro_torch.obs.tracer import Tracer

    cfg, mix = _cell_parts(root, name)
    pattern = bench.load_pattern(bench.HERE, cfg).make(cfg)
    op = bench.load_operator(bench.HERE, cfg)
    driver = bench.load_driver(bench.HERE, mix)
    tracer = Tracer()
    sess = Session(engine=TorchEngine(kernel=cfg["kernel"], device="cpu"),
                   leaf_n=int(cfg["leaf_n"]), bs=int(cfg["bs"]),
                   lazy=driver.LAZY, trace=tracer)
    rec = spans.Recorder(time.perf_counter)
    traffic = driver.start(cellmod.Context(sess, op, mix, 7, rec, pattern,
                                           []))
    traffic.warm()
    rec.spans.clear()
    t_first = time.perf_counter()
    for n in range(products):
        traffic.issue(n)
        with rec.span("flush"):
            sess.flush()
    ep = tracer.epoch
    prog = [(s.name, s.t0 + ep, s.t1 + ep) for s in tracer.spans
            if s.t0 + ep >= t_first]
    return rec.spans, prog


@pytest.mark.parametrize("cell", CELLS)
def test_program_spans_lie_inside_their_harness_twins(tiny_root, cell):
    own, prog = _traced_products(tiny_root, cell)
    seen = set()
    for name, a, b in prog:
        twin = TWIN.get(name)
        if twin is None:
            continue
        seen.add(name)
        assert any(n == twin and t0 <= a and b <= t1
                   for n, t0, t1 in own), (name, twin)
    assert {"engine.gather", "engine.scatter", "kernel.dispatch",
            "copy.h2d", "copy.d2h", "engine.flush"} <= seen
    root = {"banded.eager": "qt.multiply", "overlap_s2.eager":
            "qt.sym_square", "overlap_s2.replay": "plan.rebind"}[cell]
    assert root in seen


def test_readings_of_a_fixed_span_list():
    """``register_ms``, ``rebind_ms``, ``pack_ms`` and ``dispatch_ms``, and
    the gap labels, on a recorded list of two products."""
    recorded = [("register", 0.0, 1.0), ("flush", 1.0, 3.0),
                ("kernel.dispatch", 1.5, 2.0), ("free", 3.0, 3.1),
                ("rebind", 3.1, 3.35), ("flush", 3.35, 4.35),
                ("kernel.dispatch", 4.0, 4.25)]
    run = Run(products=2, spans=recorded)
    got = {m: bench.load_metric(bench.HERE, m).read(run)
           for m in ("register_ms", "rebind_ms", "pack_ms", "dispatch_ms")}
    assert got == pytest.approx({"register_ms": 500.0, "rebind_ms": 125.0,
                                 "pack_ms": 1125.0, "dispatch_ms": 375.0})
    labels = [spans.label_gap(recorded, a, b) for a, b in
              ((0.1, 0.9), (1.1, 1.4), (1.6, 1.9), (3.2, 3.3), (4.4, 5.0))]
    assert labels == ["register", "pack", "dispatch", "rebind", "between"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["banded.eager", "overlap_s2.replay"])
def test_every_kernel_runs_inside_a_dispatch_span(tiny_root, cuda, cell):
    """The device trace and the program's spans share the host's clock:
    each kernel of the multiply lies inside a ``kernel.dispatch`` span of
    the program, within 1 ms (run: ``python -m pytest -q -m cuda
    portbench/tests`` on a machine with a card)."""
    cfg, mix = _cell_parts(tiny_root, cell)
    res = cellmod.rank_main(0, 1, {
        "cfg": cfg, "mix": mix, "seed": 2 ** 31 + 3, "seconds": 1.0,
        "trace": True, "device": "cuda", "backend": "nccl", "plant": None})
    assert res["failed"] == 0
    dispatch = [(a, b) for n, a, b in res["spans"] if n == spans.DISPATCH]
    kernels = [(a, b) for n, cat, a, b in res["trace"].events
               if cat == "kernel" and "bsmm_pairs" in n]
    assert dispatch and len(kernels) >= res["products"]
    # seconds by which each kernel sticks out of the nearest dispatch span
    out = [min(max(d0 - a, b - d1, 0.0) for d0, d1 in dispatch)
           for a, b in kernels]
    assert max(out) <= 1e-3, (max(out), sum(x > 0 for x in out),
                              len(out))


def _fixed_record():
    """Two products' program records: set-up's two constructions, two
    registrations (one with a nested root span and a collector pass), a
    flush and a rebind."""
    sp = [("qt.from_coo", 1.0, 1.5, 0, None, {}),
          ("qt.from_coo", 2.0, 3.0, 1, None, {}),
          ("qt.multiply", 10.0, 11.0, 2, None, {"pairs_s": 0.4}),
          ("gc.collect", 10.5, 10.6, 3, 2, {"generation": 0}),
          ("qt.sym_square", 12.0, 13.0, 4, None, {"pairs_s": 0.5}),
          ("qt.multiply", 12.2, 12.6, 5, 4, {"pairs_s": 0.2}),
          ("engine.flush", 14.0, 16.0, 6, None, {}),
          ("engine.wave", 14.2, 15.2, 7, 6, {}),
          ("engine.gather", 14.2, 14.5, 8, 7, {}),
          ("kernel.dispatch", 14.5, 14.9, 9, 7, {}),
          ("copy.h2d", 14.5, 14.6, 10, 9, {}),
          ("copy.d2h", 14.7, 14.9, 11, 9, {}),
          ("engine.scatter", 14.9, 15.1, 12, 7, {}),
          ("engine.host_fill", 15.3, 15.8, 13, 6, {}),
          ("gc.collect", 15.4, 15.5, 14, 13, {"generation": 1}),
          ("plan.run", 16.9, 17.5, 15, None, {}),
          ("plan.rebind", 17.0, 17.3, 16, 15, {})]
    return {"spans": sp, "window": (10.0, 20.0),
            "counters": {"engine.pairs_s": 0.9, "gc.collect_s": 0.2},
            "held_bytes": 5e6}


def test_program_readings_of_a_fixed_record():
    """The twelve readings of the program's records, each by hand."""
    run = Run(products=2, program=_fixed_record())
    want = {"from_coo_s": 0.75,
            # (0.9 - 0.4) + (0.6 - (0.5 - 0.2)) + (0.4 - 0.2) s
            "recurse_ms": 500.0, "pairs_ms": 450.0,
            "plan_rebind_ms": 150.0,
            # engine.flush's self 0.5 s and engine.wave's 0.1 s
            "schedule_ms": 300.0, "gather_ms": 150.0, "scatter_ms": 100.0,
            # less the collector's pass inside it
            "host_fill_ms": 200.0, "h2d_ms": 50.0, "d2h_ms": 100.0,
            "gc_ms": 100.0, "held_mb": 5.0}
    got = {m: bench.load_metric(bench.HERE, m).read(run) for m in want}
    assert got == pytest.approx(want)
    assert spans.program_self(run, "engine.gather") == pytest.approx(0.15)
    assert spans.program_counter(run, "gc.collect_s") == 0.2
    assert spans.program_counter(run, "engine.pairs") is None
    # a run without the program's records reads nothing
    bare = Run(products=2, program=None)
    assert {m: bench.load_metric(bench.HERE, m).read(bare)
            for m in want} == dict.fromkeys(want)
