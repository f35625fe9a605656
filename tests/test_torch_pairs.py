"""The torch engine's block pairs as columns (``core/engine.py``):
registration's C structure and pair count from the operands' block masks,
a truncated multiply's kept pairs frozen as columns, and the wave-wide
join in ``number_wave``, all held to the host reference enumerator
``leaf_task_pairs``.

Every multiply kind and variant runs at tau 0; the plain multiply also at
a tau that prunes about half its pairs (the symmetric kinds take no tau).
Tiny decaying banded and overlap patterns on the CPU engine (the
kernels' plain versions); nothing here needs a card.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core.patterns import (banded_pairs,  # noqa: E402
                                       divide_space_order, overlap_pairs,
                                       particle_cloud)
from repro_torch.obs.tracer import Tracer  # noqa: E402
from repro_torch.serve import WaveCoalescer  # noqa: E402
from test_torch_gather import task_pairs  # noqa: E402

N, LEAF_N, BS = 128, 32, 4
#: prunes 2098 of the banded product's 4498 block pairs, no leaf product
#: whole
TAU = 0.2


def _values(seed):
    def fn(r, c):
        rng = np.random.default_rng(seed)
        return np.exp(-np.abs(r - c) / 6.0) * (1 + 0.1 * rng.random(len(r)))
    return fn


def _session(**kw):
    return repro_torch.Session(engine=t_engine.TorchEngine(device="cpu"),
                               leaf_n=LEAF_N, bs=BS, **kw)


def _banded(s, seed, d=24):
    rows, cols = banded_pairs(N, d)
    return s.from_pattern(rows, cols, N, value_fn=_values(seed))


def _overlap(s, seed):
    coords = particle_cloud(6, 3, seed=7)
    rows, cols = overlap_pairs(coords, 4.5, order=divide_space_order(coords))
    keep = (rows < N) & (cols < N)
    return s.from_pattern(rows[keep], cols[keep], N, upper=True,
                          value_fn=_values(seed))


def _multiply(ta, tb):
    def product(s, tau):
        a, b = _banded(s, 1), _banded(s, 2)
        return (a.T if ta else a).multiply(b.T if tb else b, tau=tau)
    return product


#: each product: (session, tau) -> C; the symmetric kinds take no tau
PRODUCTS = {
    "ab": _multiply(False, False),
    "at_b": _multiply(True, False),
    "a_bt": _multiply(False, True),
    "at_bt": _multiply(True, True),
    "sym_square": lambda s, tau: _overlap(s, 1).sym_square(),
    "syrk": lambda s, tau: _banded(s, 1).syrk(),
    "syrk_trans": lambda s, tau: _banded(s, 1).syrk(trans=True),
    "sym_multiply_left": lambda s, tau: _overlap(s, 1).sym_multiply(
        _banded(s, 2), side="left"),
    "sym_multiply_right": lambda s, tau: _overlap(s, 1).sym_multiply(
        _banded(s, 2), side="right"),
}
CASES = [(p, 0.0) for p in PRODUCTS] + [
    (p, TAU) for p in ("ab", "at_b", "a_bt", "at_bt")]
IDS = [f"{p}-tau{tau:g}" for p, tau in CASES]


def _waves(monkeypatch, product, tau, **kw):
    """Run the product; returns (C, its session, each wave's tasks)."""
    waves = []
    gather = t_engine.gather_wave

    def record(tasks, tracer=None):
        waves.append(list(tasks))
        return gather(tasks, tracer)

    monkeypatch.setattr(t_engine, "gather_wave", record)
    s = _session(**kw)
    c = PRODUCTS[product](s, tau)
    s.flush()
    assert waves
    return c, s, waves


def _k(num, codes):
    """The inner index k of each first-operand code."""
    return np.array([key[0] if tr else key[1]
                     for _, key, tr in num.blocks(codes)], np.int64)


@pytest.mark.parametrize("product,tau", CASES, ids=IDS)
def test_registration_and_wave_rows_equal_the_reference(monkeypatch,
                                                        product, tau):
    """Each task's C keys and pair count, from registration, equal the
    reference enumerator's ``sorted({out_key})`` and ``len(pairs)``; the
    wave's (task, slot, code_a, code_b) rows equal those built from its
    pairs, row for row in the documented order (so as a multiset too)."""
    c, _, waves = _waves(monkeypatch, product, tau)
    if tau:
        assert 0.3 < c.truncation.pruned_leaf_pairs / (
            c.truncation.pruned_leaf_pairs + sum(
                len(task_pairs(t)) for w in waves for t in w)) < 0.7
    for tasks in waves:
        num = t_engine.number_wave(tasks)
        cells = num.grid * num.grid
        ix = {id(x): n for n, x in enumerate(num.leaves)}
        want = []
        for n, t in enumerate(tasks):
            pairs = task_pairs(t)
            assert list(t.out.blocks) == sorted({p[6] for p in pairs})
            assert t.n_pairs == len(pairs) > 0
            srcs = {"a": t.a_leaf, "b": t.b_leaf}
            slot = {key: num.slot_base[n] + x
                    for x, key in enumerate(t.out.blocks)}

            def code(src, key, tr):
                return (ix[id(srcs[src])] * cells + key[0] * num.grid
                        + key[1]) * 2 + tr
            want += [(n, slot[p[6]], code(*p[:3]), code(*p[3:6]))
                     for p in pairs]
        got = list(zip(num.task.tolist(), num.slot.tolist(),
                       num.code[:, 0].tolist(), num.code[:, 1].tolist()))
        assert got == want
        assert sorted(got) == sorted(want)


@pytest.mark.parametrize("product,tau", CASES, ids=IDS)
def test_each_c_block_takes_its_pairs_in_ascending_k(monkeypatch, product,
                                                      tau):
    """Sorted stably by C slot, as the kernel takes them, each slot's
    pairs come in task order, then strictly ascending k."""
    _, _, waves = _waves(monkeypatch, product, tau)
    for tasks in waves:
        num = t_engine.number_wave(tasks)
        order = np.argsort(num.slot, kind="stable")
        slot, task = num.slot[order], num.task[order]
        k = _k(num, num.code[order, 0])
        same = slot[1:] == slot[:-1]
        assert same.any()
        # a slot belongs to one task, so its pairs differ in k alone
        assert (task[1:][same] == task[:-1][same]).all()
        assert (k[1:][same] > k[:-1][same]).all()


def _coalesced(product, tau):
    """C of the product, its session's wave merged with an S2 square's of
    another session through the coalescer."""
    s1, s2 = _session(), _session()
    c = PRODUCTS[product](s1, tau)
    _overlap(s2, 5).sym_square()
    co = WaveCoalescer()
    co.flush([s1.graph, s2.graph])
    assert co.merged_waves >= 1
    return c


@pytest.mark.parametrize("product,tau", CASES, ids=IDS)
def test_c_is_the_same_bits_alone_and_coalesced(product, tau):
    s = _session()
    alone = PRODUCTS[product](s, tau)
    s.flush()
    x, y = alone.to_dense(), _coalesced(product, tau).to_dense()
    assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("product,tau", [("ab", 0.0), ("ab", TAU),
                                         ("sym_square", 0.0),
                                         ("sym_multiply_right", 0.0)])
def test_pairs_joined_counts_the_join(product, tau):
    """``engine.pairs_joined`` equals ``engine.pairs`` at tau 0 and is 0
    where every task froze its kept pairs."""
    s = _session(trace=Tracer())
    PRODUCTS[product](s, tau)
    s.flush()
    cnt = s.tracer.counters
    assert cnt["engine.pairs"] == s.engine_stats()["batched_pairs"] > 0
    assert cnt["engine.pairs_joined"] == (0 if tau else cnt["engine.pairs"])


def test_a_wave_mixing_frozen_and_joined_tasks_keeps_task_order(
        monkeypatch):
    """A truncated product and an exact one in one wave: the frozen
    columns fall in their tasks' places, and the join counts only the
    exact product's pairs."""
    waves = []
    gather = t_engine.gather_wave

    def record(tasks, tracer=None):
        waves.append(list(tasks))
        return gather(tasks, tracer)

    monkeypatch.setattr(t_engine, "gather_wave", record)
    s = _session(trace=Tracer())
    a, b = _banded(s, 1), _banded(s, 2, d=12)
    s.flush()
    a.multiply(b, tau=TAU)
    a.T @ b
    s.flush()
    frozen = {id(t) for w in waves for t in w if t.kept is not None}
    mixed = [w for w in waves if 0 < sum(id(t) in frozen for t in w)
             < len(w)]
    assert mixed
    for tasks in mixed:
        num = t_engine.number_wave(tasks)
        assert (np.diff(num.task) >= 0).all()
        assert np.bincount(num.task).tolist() == [t.n_pairs for t in tasks]
    cnt = s.tracer.counters
    assert cnt["engine.pairs_joined"] == sum(
        t.n_pairs for w in waves for t in w if id(t) not in frozen) > 0


@pytest.mark.parametrize("path", ["execute", "reexecute"])
def test_the_tuple_enumerator_is_never_reached_at_tau_zero(monkeypatch,
                                                           path):
    """At tau 0 the engine builds no Python object a block pair: the
    reference enumerator, patched to raise, is never called on
    registration or replay, and no pending task holds a list."""
    s = _session(lazy=True)
    ins = [_banded(s, 1), _banded(s, 2, d=12), _overlap(s, 3)]
    plans = [s.compile(ins[0].T @ ins[1]), s.compile(ins[2].sym_square())]
    for plan in plans:
        plan.run()

    def boom(*args, **kw):
        raise AssertionError("leaf_task_pairs reached")

    monkeypatch.setattr(t_engine, "leaf_task_pairs", boom)
    held = []
    gather = t_engine.gather_wave

    def record(tasks, tracer=None):
        held.extend(tasks)
        return gather(tasks, tracer)

    monkeypatch.setattr(t_engine, "gather_wave", record)
    if path == "execute":
        for product in PRODUCTS:
            PRODUCTS[product](s, 0.0)
        s.flush()
    else:
        for plan in plans:
            plan.run(flush=False)
        s.flush()
    assert held
    names = {f.name for f in dataclasses.fields(t_engine._Pending)}
    assert "pairs" not in names
    for t in held:
        assert t.kept is None
        assert not any(isinstance(getattr(t, f), list) for f in names)
