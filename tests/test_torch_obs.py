"""The port's tracer inside the multiply: spans of each host layer, their
``id``/``parent``/``step`` links, the engine's registration counters, the
graph's held bytes and the collector's spans.

Tiny banded and overlap patterns on the CPU engine (the kernels' plain
versions); nothing here needs a card or the reference.
"""
import gc
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core.engine import TorchEngine  # noqa: E402
from repro_torch.core.patterns import (banded_pairs,  # noqa: E402
                                       divide_space_order, overlap_pairs,
                                       particle_cloud)
from repro_torch.obs import tracer as trmod  # noqa: E402
from repro_torch.obs.tracer import NOOP, Tracer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, LEAF_N, BS = 128, 32, 8
#: the spans one flush of a kernel wave opens, by parent
WAVE = {"engine.wave": "engine.flush", "engine.gather": "engine.wave",
        "kernel.dispatch": "engine.wave", "engine.scatter": "engine.wave",
        "copy.h2d": "kernel.dispatch", "copy.d2h": "kernel.dispatch"}


def _values(seed):
    def fn(r, c):
        rng = np.random.default_rng(seed)
        return 1.0 + rng.random(len(r))
    return fn


def _session(trace, lazy=False):
    return repro_torch.Session(engine=TorchEngine(device="cpu"),
                               leaf_n=LEAF_N, bs=BS, lazy=lazy, trace=trace)


def _overlap():
    coords = particle_cloud(6, 3, seed=7)
    rows, cols = overlap_pairs(coords, 4.5,
                               order=divide_space_order(coords))
    keep = (rows < N) & (cols < N)
    return rows[keep], cols[keep]


class _Products:
    """Two products of one traffic on one session: ``issue(k)`` registers
    product ``k`` (or rebinds a plan) and returns its root span name."""

    def __init__(self, kind, trace):
        self.kind = kind
        self.sess = _session(trace, lazy=kind == "replay")
        s = self.sess
        if kind == "banded":
            rows, cols = banded_pairs(N, 9)
            self.a = s.from_pattern(rows, cols, N, value_fn=_values(1))
            self.b = s.from_pattern(rows, cols, N, value_fn=_values(2))
        else:
            rows, cols = _overlap()
            self.s = [s.from_pattern(rows, cols, N, upper=True,
                                     value_fn=_values(k), name="S")
                      for k in (1, 2)]
            if kind == "replay":
                self.plan = s.compile(self.s[0].sym_square())
                self.plan.run(flush=False)
        s.flush()               # set-up is a step of its own

    def issue(self, k):
        if self.kind == "banded":
            return self.a @ self.b, "qt.multiply"
        if self.kind == "overlap":
            return self.s[k % 2].sym_square(), "qt.sym_square"
        return self.plan.run(flush=False, S=self.s[k % 2]), "plan.run"

    def run(self, products=2):
        out = []
        for k in range(products):
            c, root = self.issue(k)
            self.sess.flush()
            out.append((c, root))
        return out


KINDS = ["banded", "overlap", "replay"]


def _check_links(spans):
    """Every parent encloses its child, opened before it, one level up."""
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s.parent is None:
            assert s.depth == 0
            continue
        p = by_id[s.parent]
        assert p.id < s.id and p.depth + 1 == s.depth
        assert p.t0 <= s.t0 and s.t1 <= p.t1
        assert s.step == p.step


@pytest.mark.parametrize("kind", KINDS)
def test_span_names_parents_and_steps(kind):
    """Each product's registration (or rebind) and its flush share one
    step; the wave's spans nest as the engine opens them."""
    p = _Products(kind, trace=True)
    tr = p.sess.tracer
    step0 = tr.step
    roots = [root for _, root in p.run(2)]
    assert tr.step == step0 + 2
    spans = [s for s in tr.spans if s.name != "gc.collect"]
    _check_links(tr.spans)
    by_id = {s.id: s for s in tr.spans}
    for k, root in enumerate(roots):
        mine = [s for s in spans if s.step == step0 + k]
        names = {s.name for s in mine}
        assert {root, "engine.flush"} | set(WAVE) <= names
        assert names <= {root, "engine.flush", "engine.host_fill",
                         "plan.rebind", "plan.replay"} | set(WAVE)
        for s in mine:
            parent = by_id[s.parent].name if s.parent is not None else None
            if s.name in WAVE:
                assert parent == WAVE[s.name]
            elif s.name == "engine.host_fill":
                assert parent == "engine.flush"
            elif s.name in ("plan.rebind", "plan.replay"):
                assert parent == "plan.run"
            else:
                assert parent is None
        (top,) = [s for s in mine if s.name == root]
        (flush,) = [s for s in mine if s.name == "engine.flush"]
        assert top.t1 <= flush.t0
    if kind == "overlap":       # the symmetric partials add on the host
        fills = tr.find("engine.host_fill")
        assert fills and all(f.attrs["adds"] > 0 for f in fills)


@pytest.mark.parametrize("kind", KINDS)
def test_engine_pairs_counter_equals_batched_pairs(kind):
    p = _Products(kind, trace=True)
    tr = p.sess.tracer
    before = dict(tr.counters)
    pairs0 = p.sess.engine_stats()["batched_pairs"]
    p.run(2)
    moved = p.sess.engine_stats()["batched_pairs"] - pairs0
    assert moved > 0
    assert tr.counters["engine.pairs"] - before.get("engine.pairs", 0) \
        == moved
    assert tr.counters["engine.leaf_tasks"] > \
        before.get("engine.leaf_tasks", 0)
    assert tr.counters["engine.pairs_s"] > before.get("engine.pairs_s", 0)


@pytest.mark.parametrize("kind", KINDS)
def test_gather_span_counts_pairs_and_unique_blocks(kind):
    """Each ``engine.gather`` span carries its wave's pairs and unique
    operand blocks, as the wave record has them: their ratio is the
    operand reuse the slot numbering finds."""
    p = _Products(kind, trace=True)
    p.run(2)
    spans = p.sess.tracer.find("engine.gather")
    waves = p.sess.engine_stats()["wave_log"]
    assert len(spans) == len(waves) > 0
    for sp, w in zip(spans, waves):
        assert sp.attrs["pairs"] == w["pairs"] > 0
        assert sp.attrs["unique_blocks"] == w["unique_blocks"]
        assert 2 <= w["unique_blocks"] <= 2 * w["pairs"]


@pytest.mark.parametrize("kind", ["banded", "overlap"])
def test_root_span_reports_the_counters_it_moved(kind):
    p = _Products(kind, trace=True)
    tr = p.sess.tracer
    before = dict(tr.counters)
    _, root = p.issue(0)
    (sp,) = tr.find(root)
    for k in ("leaf_tasks", "pairs", "pairs_s"):
        assert sp.attrs[k] == pytest.approx(
            tr.counters["engine." + k] - before.get("engine." + k, 0))
    assert sp.attrs["pairs"] > 0 and sp.attrs["tasks"] > 0


@pytest.mark.parametrize("program", ["add", "transpose", "scale", "syrk",
                                     "sym_multiply"])
def test_each_task_program_has_a_root_span(program):
    s = _session(True)
    rows, cols = banded_pairs(N, 9)
    a = s.from_pattern(rows, cols, N, value_fn=_values(1))
    b = s.from_pattern(rows, cols, N, value_fn=_values(2))
    sym = s.from_pattern(rows, cols, N, upper=True, value_fn=_values(3))
    calls = {"add": lambda: a + b, "transpose": lambda: a.T + b,
             "scale": lambda: 2.0 * a, "syrk": lambda: a.syrk(),
             "sym_multiply": lambda: sym.sym_multiply(b)}
    calls[program]()
    (sp,) = s.tracer.find("qt." + program)
    assert sp.parent is None and sp.attrs["tasks"] > 0
    assert set(sp.attrs) >= {"n", "tasks", "leaf_tasks", "pairs", "pairs_s"}
    # the recursion's own calls are below the root: one span each
    names = [x.name for x in s.tracer.spans if x.name.startswith("qt.")]
    assert names.count("qt." + program) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_held_bytes_equals_the_sum_over_nodes(kind):
    p = _Products(kind, trace=False)
    p.run(2)
    g = p.sess.graph
    assert g.held_bytes == sum(n.out_nbytes for n in g.nodes
                               if n.value is not None) > 0
    graph = next(m for m in p.sess.metrics() if m.source == "graph")
    assert graph["held_bytes"].total == g.held_bytes
    assert graph["nodes"].total == len(g.nodes)


def test_gc_collect_inside_a_span_is_its_child():
    tr = Tracer()
    with tr.span("outer"):
        gc.collect()
    outer = tr.find("outer")[0]
    kids = [s for s in tr.find("gc.collect") if s.parent == outer.id]
    assert len(kids) == 1
    (k,) = kids
    assert k.track == "host" and k.attrs["generation"] == 2
    assert k.depth == 1 and outer.t0 <= k.t0 <= k.t1 <= outer.t1


def test_the_clock_leaves_the_collector_out():
    tr = Tracer()
    big = [[i] for i in range(200_000)]      # something to collect over
    c0, t0 = tr.clock(), tr.counters.get("gc.collect_s", 0.0)
    w0 = time.perf_counter()
    gc.collect()
    wall = time.perf_counter() - w0
    gc_s = tr.counters["gc.collect_s"] - t0
    assert 0 < gc_s <= wall
    assert tr.clock() - c0 == pytest.approx(wall - gc_s, abs=1e-3)
    assert big


def test_a_hundred_tracers_leave_one_hook():
    Tracer()
    hooks = gc.callbacks.count(trmod._gc_hook)
    for _ in range(100):
        Tracer()
    gc.collect()
    assert hooks == gc.callbacks.count(trmod._gc_hook) == 1
    live = Tracer()
    assert live in trmod._RECORDING


def test_counters_and_noop():
    tr = Tracer()
    tr.add("x")
    tr.add("x", 2.5)
    assert tr.counters == {"x": 3.5}
    tr.clear()
    assert tr.counters == {} and tr.spans == []
    NOOP.add("x")
    assert dict(NOOP.counters) == {}


def test_an_untraced_session_installs_no_hook():
    """A fresh interpreter that multiplies untraced holds no collector
    hook of the tracer's and records nothing."""
    code = (
        "import gc, numpy as np\n"
        "import repro_torch\n"
        "from repro_torch.core.engine import TorchEngine\n"
        "from repro_torch.obs import tracer\n"
        "s = repro_torch.Session(engine=TorchEngine(device='cpu'), "
        "leaf_n=16, bs=4)\n"
        "a = s.from_dense(np.eye(64) + np.eye(64, k=1))\n"
        "(a @ a).to_dense(); s.flush(); gc.collect()\n"
        "print(tracer._gc_hook in gc.callbacks, len(tracer._RECORDING), "
        "len(s.tracer.spans), s.tracer is tracer.NOOP)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "0", "0", "True"]


@pytest.mark.parametrize("kind", KINDS)
def test_tracing_changes_no_graph_count_or_wave(kind):
    """Traced and untraced runs of the same products register the same
    graph and run the same waves with the same numbers."""
    runs = []
    for trace in (False, True):
        p = _Products(kind, trace=trace)
        outs = p.run(2)
        g = p.sess.graph
        st = p.sess.engine_stats()
        waves = [{k: v for k, v in w.items() if k != "wall_s"}
                 for w in st["wave_log"]]
        runs.append({
            "nodes": [(n.kind, n.parent, [(d.nid, d.fetch) for d in n.deps],
                       n.children, n.alias_of, n.out_nbytes, n.flops,
                       n.level) for n in g.nodes],
            "kinds": p.sess.task_counts(), "waves": waves,
            "held": g.held_bytes,
            "c": [c.to_dense() for c, _ in outs]})
    plain, traced = runs
    for k in ("nodes", "kinds", "waves", "held"):
        assert plain[k] == traced[k], k
    for x, y in zip(plain["c"], traced["c"]):
        np.testing.assert_array_equal(x, y)
