"""``Session.free`` lets go of the host chunks the task graph keeps.

An eager loop that frees each product holds its host memory flat, the
graph keeps its nodes and counts, and nothing a live handle, a compiled
plan, a pending lazy expression or the transpose cache still reads is
dropped.  Tiny banded and overlap patterns on the CPU engine (the kernels'
plain versions) and on the numpy engine; nothing here needs a card or the
reference.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.api.expr import Input, MatMul  # noqa: E402
from repro_torch.core.engine import TorchEngine  # noqa: E402
from repro_torch.core.patterns import (banded_mask,  # noqa: E402
                                       divide_space_order, overlap_mask,
                                       particle_cloud, values_for_mask)
from repro_torch.obs.tracer import Tracer  # noqa: E402

N, LEAF_N, BS = 64, 16, 4
#: |C - C_ref| over (|A| |B|), elementwise: the benchmark's float32 limit
REL = 1e-4
KINDS = ["banded", "overlap"]
ENGINES = ["torch", "numpy"]


def _engine(name):
    return TorchEngine(device="cpu") if name == "torch" else "numpy"


def _session(engine="torch", **kw):
    return repro_torch.Session(engine=_engine(engine), leaf_n=LEAF_N, bs=BS,
                               **kw)


def _dense(kind, seed):
    if kind == "banded":
        return values_for_mask(banded_mask(N, 5), seed=seed)
    coords = particle_cloud(4, 3, seed=7)
    mask = overlap_mask(coords, 4.0, order=divide_space_order(coords))
    return values_for_mask(mask != 0, seed=seed, symmetric=True)


class _Loop:
    """One session's operands of a kind: ``product()`` registers a fresh
    ``A @ B`` (banded) or ``S.sym_square()`` (overlap) and flushes it."""

    def __init__(self, kind, engine="torch", **kw):
        self.kind = kind
        self.sess = _session(engine, **kw)
        self.a = _dense(kind, 1)
        if kind == "banded":
            self.b = _dense(kind, 2)
            self.ops = (self.sess.from_dense(self.a),
                        self.sess.from_dense(self.b))
        else:
            self.b = self.a
            self.ops = (self.sess.from_dense(self.a, upper=True),)
        self.sess.flush()

    def product(self):
        if self.kind == "banded":
            c = self.ops[0] @ self.ops[1]
        else:
            c = self.ops[0].sym_square()
        self.sess.flush()
        return c

    def check(self, c):
        _check_product(c.to_dense(), self.a, self.b)


def _check_product(got, a, b):
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a) @ np.abs(b)
    err = np.abs(got - want) / np.where(scale > 0, scale, 1.0)
    assert err.max() <= REL


def _held_by_nodes(g):
    return sum(n.out_nbytes for n in g.nodes if n.value is not None)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", KINDS)
def test_an_eager_loop_that_frees_holds_host_memory_flat(kind, engine):
    loop = _Loop(kind, engine)
    g = loop.sess.graph
    held = []
    for _ in range(4):
        loop.sess.free(loop.product())
        held.append(g.held_bytes)
        assert g.held_bytes == _held_by_nodes(g)
    assert held[1:] == held[:-1]
    graph = next(m for m in loop.sess.metrics() if m.source == "graph")
    assert graph["held_bytes"].total == held[-1]
    assert graph["freed_bytes"].total == g.freed_bytes > 0


@pytest.mark.parametrize("kind", KINDS)
def test_free_keeps_nodes_counts_and_waves(kind):
    """A loop that frees registers the same graph and runs the same waves
    as one that keeps every product."""
    runs = []
    for free in (False, True):
        loop = _Loop(kind)
        for _ in range(3):
            c = loop.product()
            if free:
                loop.sess.free(c)
        g = loop.sess.graph
        waves = [{k: v for k, v in w.items() if k != "wall_s"}
                 for w in loop.sess.engine_stats()["wave_log"]]
        runs.append({
            "nodes": [(n.nid, n.kind, n.parent, n.payload,
                       [(d.nid, d.fetch) for d in n.deps], n.children,
                       n.alias_of, n.out_nbytes, n.flops, n.level)
                      for n in g.nodes],
            "kinds": loop.sess.task_counts(), "waves": waves})
    kept, freed = runs
    for k in ("nodes", "kinds", "waves"):
        assert kept[k] == freed[k], k


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", KINDS)
def test_products_kept_beside_freed_ones_stay_correct(kind, engine):
    loop = _Loop(kind, engine)
    kept = []
    for k in range(5):
        c = loop.product()
        if k in (0, 2):
            kept.append(c)
        else:
            loop.sess.free(c)
    for c in kept:
        loop.check(c)
    loop.check(loop.product())        # the operands survived every free


@pytest.mark.parametrize("kind", KINDS)
def test_freed_bytes_equal_the_drop_in_held_bytes(kind):
    loop = _Loop(kind, trace=Tracer())
    g, tr = loop.sess.graph, loop.sess.tracer
    c = loop.product()
    held = g.held_bytes
    loop.sess.free(c)
    assert g.freed_bytes == held - g.held_bytes > 0
    assert tr.counters["graph.freed_bytes"] == g.freed_bytes
    assert tr.counters["graph.freed_chunks"] > 0
    loop.sess.free(c)                  # a second free lets go of nothing
    assert g.freed_bytes == held - g.held_bytes


@pytest.mark.parametrize("freed", ["bound_input", "output", "other"])
def test_a_compiled_plan_survives_a_free(freed):
    """The plan binds an eager product as its input: freeing that product,
    the plan's output or an unrelated product leaves the plan's program
    and inputs whole, and a rebinding run afterwards is correct."""
    loop = _Loop("banded")
    sess = loop.sess
    x = loop.product()
    xd = x.to_dense()
    plan = sess.compile(MatMul(Input(x.node, N), Input(x.node, N)))
    out = plan.run()
    _check_product(out.to_dense(), xd, xd)
    victim = {"bound_input": x, "output": out,
              "other": loop.product()}[freed]
    sess.free(victim)
    for nid in plan.nodes:
        node = sess.graph.nodes[nid]
        assert node.out_nbytes == 0 or node.value is not None
    _check_product(plan.run().to_dense(), xd, xd)
    new = _dense("banded", 3)
    _check_product(plan.run(**{plan.input_names[0]: new}).to_dense(),
                   new, new)


def test_a_lazy_plan_output_survives_a_free():
    loop = _Loop("overlap", lazy=True)
    sess, s = loop.sess, loop.ops[0]
    plan = sess.compile(s.sym_square())
    out = plan.run()
    held = sess.graph.held_bytes
    sess.free(out)
    assert sess.graph.held_bytes == held
    loop.check(out)
    new = _dense("overlap", 4)
    _check_product(plan.run(**{plan.input_names[0]: new}).to_dense(),
                   new, new)


def test_a_cached_transpose_survives_a_free():
    """``A.T + B`` materialises A's transpose through the session-wide
    cache: freeing the sum keeps it, and the next ``A.T + B`` reuses it."""
    loop = _Loop("banded")
    sess = loop.sess
    a, b = loop.ops
    d = a.T + b
    sess.flush()
    (tnid,) = [t for t in sess._transpose_cache.values() if t is not None]
    sess.free(d)
    assert sess.graph.value_of(tnid) is not None
    n0 = len(sess.graph.nodes)
    e = a.T + b
    np.testing.assert_allclose(e.to_dense(), loop.a.T + loop.b, atol=1e-6)
    assert sess.graph.nodes[n0].kind != "transpose"


def test_a_live_operand_keeps_the_subtrees_an_add_shares():
    """An add whose other operand is NIL returns its operand's tree: the
    sum's free leaves that tree to the operand, which stays readable."""
    loop = _Loop("banded")
    sess = loop.sess
    a = loop.ops[0]
    d = a + sess.zeros(N)
    assert d.node == a.node
    held = sess.graph.held_bytes
    sess.free(d)
    assert sess.graph.held_bytes == held
    np.testing.assert_array_equal(a.to_dense(), loop.a)


def test_a_later_sum_keeps_the_subtrees_it_shares_with_a_freed_operand():
    """``D = C + E`` with E NIL outside its first quadrant shares C's
    other quadrants: freeing C keeps them, and D stays readable."""
    loop = _Loop("banded")
    sess = loop.sess
    c = loop.product()
    cd = c.to_dense()
    e = np.zeros((N, N), dtype=np.float32)
    e[:N // 2, :N // 2] = loop.a[:N // 2, :N // 2]
    d = c + sess.from_dense(e)
    sess.flush()
    shared = set(_tree(sess.graph, c.node)) & set(_tree(sess.graph, d.node))
    assert shared
    sess.free(c)
    assert all(sess.graph.nodes[nid].value is not None for nid in shared)
    np.testing.assert_allclose(d.to_dense(), cd + e, rtol=1e-6, atol=1e-6)


def test_a_pending_lazy_expression_keeps_its_inputs():
    """In a lazy session ``Y = X @ X`` is still pending when X is freed:
    X's chunks stay, and forcing Y gives the product."""
    loop = _Loop("banded", lazy=True)
    sess, x = loop.sess, loop.ops[0]
    y = x @ x
    held = sess.graph.held_bytes
    sess.free(x)
    assert sess.graph.held_bytes == held
    _check_product(y.to_dense(), loop.a, loop.a)


@pytest.mark.parametrize("kind", KINDS)
def test_dedup_shared_content_survives_a_free(kind):
    """Under dedup the operand built twice shares its leaves' chunk ids:
    freeing one copy after a simulation leaves the twin readable and its
    products correct, and the store keeps the shared chunks.  Before a
    simulation a free lets go of nothing, since the content decides the
    simulator's dedup hits."""
    loop = _Loop(kind, dedup=True, p=2)
    sess, g = loop.sess, loop.sess.graph
    twin = sess.from_dense(loop.a, upper=kind == "overlap")
    c = loop.product()
    held = g.held_bytes
    sess.free(c)
    assert g.held_bytes == held and g.freed_bytes == 0
    rep = sess.simulate()
    assert sum(rep.dedup_hits) > 0
    owned = sum(s.owned_bytes for s in sess.scheduler.store.stats)
    released = sess.free(loop.ops[0])
    assert g.value_of(loop.ops[0].node) is None
    assert 0 < released < owned
    np.testing.assert_array_equal(twin.to_dense(), loop.a)
    c = (twin @ twin) if kind == "banded" else twin.sym_square()
    _check_product(c.to_dense(), loop.a, loop.a)


def _tree(g, nid):
    from repro_torch.api.plan import _subtree_nids
    return _subtree_nids(g, nid)
