"""The truncated multiply ``X.multiply(X, tau)`` (SpAMM's norm test,
DESIGN.md §5) on the CPU engine, held to a plain float64 reference
written here: block norms from the float32 blocks the program stores,
the keep rule ``sqrt(|X_IK|^2 |X_KJ|^2) >= tau``, and the products of
the kept pairs.  Also: the tracer's ``trunc.*`` counters against the
:class:`~repro_torch.core.multiply.TruncationReport`, an eager loop that
frees its truncated products keeping no frozen pair lists while a
compiled truncated plan still replays its own, and tau = 0 as the exact
product.  Nothing here needs a card or the reference package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.api.expr import Input, MatMul  # noqa: E402
from repro_torch.core.engine import TorchEngine  # noqa: E402
from repro_torch.obs.tracer import Tracer  # noqa: E402

N, LEAF_N, BS = 512, 128, 16
G = N // BS
#: |C - C_ref| over (|X| |X|) of the kept pairs, elementwise: float32's
#: rounding of sums of a few hundred products
REL = 1e-5
#: taus at which leaf tasks prune block pairs but no leaf product is
#: pruned whole ("pairs"), and at which whole leaf products go too
#: ("subtrees")
TAUS = {"pairs": 1e-6, "subtrees": 1e-3}


def _decaying(seed, length=16.0, width=200):
    """A band of half-width ``width`` whose values decay as
    exp(-|i - j| / length) (1 + noise/10), in float32."""
    rng = np.random.default_rng(seed)
    i = np.arange(N)
    d = np.abs(i[:, None] - i[None])
    a = np.exp(-d / length) * (1 + 0.1 * rng.uniform(-0.5, 0.5, (N, N)))
    return np.where(d <= width, a, 0.0).astype(np.float32)


def _blocks(a):
    """(G, G, BS, BS) float64 view of the blocks of ``a``."""
    x = torch.from_numpy(np.asarray(a, np.float64))
    return x.reshape(G, BS, G, BS).permute(0, 2, 1, 3)


def _keep(a, tau):
    """(G, G, G) mask over block pairs (I, K) x (K, J) of the stored
    blocks: those whose norm product reaches tau (every one at tau 0)."""
    n2 = (_blocks(a) ** 2).sum((2, 3))
    stored = n2 > 0
    pairs = stored[:, :, None] & stored[None]
    return pairs & (torch.sqrt(n2[:, :, None] * n2[None]) >= tau)


def _reference(x, y, keep):
    """C = sum of X_IK Y_KJ over the kept pairs, in float64, by blocks;
    returns C's blocks, their scale (|X| |Y| of the kept pairs) and the
    mask of C's stored blocks."""
    bx, by, k = _blocks(x), _blocks(y), keep.double()
    c = torch.einsum("ikj,ikab,kjbc->ijac", k, bx, by)
    scale = torch.einsum("ikj,ikab,kjbc->ijac", k, bx.abs(), by.abs())
    return c, scale, keep.any(1)


def _check(m, x, y, keep):
    """The program's C against the reference: the same stored blocks
    (a kept pair's product may be zero), each element within float32's
    rounding."""
    c, scale, stored = _reference(x, y, keep)
    assert _stored(m) == {tuple(k) for k in torch.nonzero(stored).tolist()}
    err = (_blocks(m.to_dense()) - c).abs()
    assert bool((err <= REL * scale).all()), float((err / scale.clamp(
        min=1e-300)).max())


def _session(**kw):
    return repro_torch.Session(engine=TorchEngine(device="cpu"),
                               leaf_n=LEAF_N, bs=BS, **kw)


def _stored(m):
    """The program's C block keys, from its leaves (not from a dense
    readback, where a stored block could read zero)."""
    g, out, stack = m.session.graph, set(), [(m.node, 0, 0)]
    while stack:
        nid, r0, c0 = stack.pop()
        ch = None if nid is None else g.value_of(nid)
        if ch is None:
            continue
        if ch.is_leaf:
            out |= {(r0 // BS + i, c0 // BS + j) for i, j in ch.leaf.blocks}
            continue
        h = ch.n // 2
        for q, (dr, dc) in enumerate(((0, 0), (0, h), (h, 0), (h, h))):
            stack.append((ch.children[q], r0 + dr, c0 + dc))
    return out


@pytest.mark.parametrize("where", list(TAUS))
def test_truncated_square_matches_the_plain_reference(where):
    tau = TAUS[where]
    a = _decaying(1)
    sess = _session()
    x = sess.from_dense(a)
    c = x.multiply(x, tau=tau)
    rep = c.truncation
    keep = _keep(a, tau)
    assert rep.pruned_leaf_pairs > 0
    assert (rep.pruned_subtrees > 0) == (where == "subtrees")
    _check(c, a, a, keep)
    # the bound covers what was dropped
    exact = a.astype(np.float64) @ a.astype(np.float64)
    err = np.linalg.norm(exact - c.to_dense())
    assert 0 < err <= rep.error_bound


@pytest.mark.parametrize("where", list(TAUS))
def test_truncation_report_equals_the_tuple_paths(where):
    """The report of the column path against that of the host reference
    enumerator's one tuple a pair (the numpy engine's truncated path):
    the same counts and flops, and ``error_bound`` to the bit (within
    1e-12 relative, float64 summation's rounding, at the least)."""
    tau = TAUS[where]
    a = _decaying(8)
    got = _session().from_dense(a)
    got = got.multiply(got, tau=tau).truncation
    ref = repro_torch.Session(engine="numpy", leaf_n=LEAF_N, bs=BS)
    ref = ref.from_dense(a)
    ref = ref.multiply(ref, tau=tau).truncation
    assert got.pruned_leaf_pairs == ref.pruned_leaf_pairs > 0
    assert got.pruned_subtrees == ref.pruned_subtrees
    assert got.pruned_by_level == ref.pruned_by_level
    assert got.pruned_flops == ref.pruned_flops
    assert got.error_bound == pytest.approx(ref.error_bound, rel=1e-12, abs=0)
    assert got.error_bound == ref.error_bound


@pytest.mark.parametrize("where", list(TAUS))
def test_trunc_counters_equal_the_truncation_report(where):
    tau = TAUS[where]
    a = _decaying(2)
    sess = _session(trace=Tracer())
    x = sess.from_dense(a)
    sess.flush()
    tr = sess.tracer
    tr.clear()
    c = x.multiply(x, tau=tau)
    sess.flush()
    rep = c.truncation
    cnt = tr.counters
    assert cnt["trunc.pairs_pruned"] == rep.pruned_leaf_pairs > 0
    assert cnt.get("trunc.subtrees_pruned", 0) == rep.pruned_subtrees
    assert cnt["trunc.test_s"] > 0
    assert cnt["engine.pairs"] == int(_keep(a, tau).sum())
    root, = [s for s in tr.spans if s.name == "qt.multiply"]
    assert root.attrs["error_bound"] == rep.error_bound > 0
    assert root.attrs["pruned_pairs"] == rep.pruned_leaf_pairs


def test_an_exact_multiply_counts_no_truncation():
    a = _decaying(3)
    sess = _session(trace=Tracer())
    x = sess.from_dense(a)
    sess.flush()
    c = x.multiply(x, tau=0.0)
    sess.flush()
    assert not any(k.startswith("trunc.") for k in sess.tracer.counters)
    root, = [s for s in sess.tracer.spans if s.name == "qt.multiply"]
    assert "error_bound" not in root.attrs
    assert c.error_bound == 0.0
    _check(c, a, a, _keep(a, 0.0))


def test_freed_products_keep_no_frozen_pairs_and_a_plan_replays_its_own():
    tau = TAUS["pairs"]
    a = _decaying(4)
    sess = _session()
    x = sess.from_dense(a, name="X")
    g = sess.graph
    plan = sess.compile(MatMul(Input(x.node, N), Input(x.node, N), tau=tau))
    out = plan.run()
    frozen = [nid for nid in plan.nodes if g.nodes[nid].replay is not None]
    assert frozen
    for _ in range(5):
        c = x.multiply(x, tau=tau)
        sess.flush()
        prog = list(c._prog)
        assert any(g.nodes[nid].replay is not None for nid in prog)
        sess.free(c)
        assert all(g.nodes[nid].replay is None for nid in prog)
    assert all(g.nodes[nid].replay is not None for nid in frozen)
    # a replay multiplies the pairs frozen at compilation, not those the
    # new values' norms would keep
    keep = _keep(a, tau)
    new = _decaying(5, length=12.0)
    assert not torch.equal(_keep(new, tau), keep)
    got = plan.run(**{plan.input_names[0]: new})
    _check(got, new, new, keep)
    _check(out, new, new, keep)      # replays fill in place


def test_tau_zero_is_the_exact_product():
    a = _decaying(6)
    sess = _session()
    x = sess.from_dense(a)
    c = x.multiply(x, tau=0.0)
    keep = _keep(a, 0.0)
    _check(c, a, a, keep)
    assert c.truncation.pruned_leaf_pairs == 0
    assert c.truncation.pruned_subtrees == 0


def test_block_norms_sum_float32_squares_in_float64():
    from repro_torch.core.leaf import LeafMatrix
    rng = np.random.default_rng(7)
    blk = rng.uniform(-1, 1, (BS, BS)).astype(np.float32)
    leaf = LeafMatrix(BS, BS, {(0, 0): blk}, dtype=np.float32)
    b64 = blk.astype(np.float64)
    assert leaf.block_norm2((0, 0)) == pytest.approx(
        float((b64 * b64).sum()), rel=1e-14, abs=0)
    assert leaf.norm2() == leaf.block_norm2((0, 0))
