"""The wave gather (``core/engine.py::gather_wave``) against the per-pair
loop it replaced, kept here as the oracle, over the pairs of the host
reference enumerator (``leaf_task_pairs``) in the wave's documented order.

Every kernel wave of each case is packed both ways: ``sa``, ``sb``,
``seg``, ``a_pack`` and ``b_pack`` must be byte-equal and ``n_slots``
equal.  Each case then runs once more with the oracle in the engine's
place, and its wave records and C must be equal to those of the run
through ``gather_wave``.  Tiny patterns on the CPU engine (the kernels'
plain versions); nothing here needs a card.
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
from repro_torch.serve import WaveCoalescer  # noqa: E402

N, LEAF_N, BS = 128, 32, 4
GATHER = t_engine.gather_wave


def task_pairs(t):
    """A wave task's block pairs from the host reference enumerator, one
    tuple a pair, in the order the wave takes them: ascending ``(k, i,
    j)`` of ``C_ij += op(A)_ik op(B)_kj``."""
    probe = dataclasses.replace(t.payload, trunc=None)
    pairs, _ = t_engine.leaf_task_pairs(probe, t.a_leaf, t.b_leaf)
    return sorted(pairs, key=lambda p: (p[1][0] if p[2] else p[1][1],
                                        *p[6]))


def _loop_gather(tasks, tracer=None):
    """The per-pair gather the engine ran before ``gather_wave``."""
    slot_base = []
    n_slots = 0
    for t in tasks:
        slot_base.append(n_slots)
        n_slots += len(t.out.blocks)
    pairs = [task_pairs(t) for t in tasks]
    n_pairs = sum(map(len, pairs))
    a_slots, b_slots, a_list, b_list = {}, {}, [], []

    def slot_of(slots, lst, leaf, key, tr):
        sk = (id(leaf), key, tr)
        s = slots.get(sk)
        if s is None:
            s = len(lst)
            slots[sk] = s
            blk = leaf.blocks[key]
            lst.append(blk.T if tr else blk)
        return s

    sa = np.empty((n_pairs,), np.int32)
    sb = np.empty((n_pairs,), np.int32)
    seg = np.empty((n_pairs,), np.int32)
    p = 0
    for base, t, t_pairs in zip(slot_base, tasks, pairs):
        key_slot = {key: base + i for i, key in enumerate(t.out.blocks)}
        srcs = {"a": t.a_leaf, "b": t.b_leaf}
        for src_a, ka, tra, src_b, kb, trb, out_key in t_pairs:
            sa[p] = slot_of(a_slots, a_list, srcs[src_a], ka, tra)
            sb[p] = slot_of(b_slots, b_list, srcs[src_b], kb, trb)
            seg[p] = key_slot[out_key]
            p += 1
    a_pack = np.stack(a_list).astype(np.float32, order="C")
    b_pack = np.stack(b_list).astype(np.float32, order="C")
    order = np.argsort(seg, kind="stable")
    return sa[order], sb[order], seg[order], a_pack, b_pack, n_slots


def _values(seed):
    def fn(r, c):
        return 1.0 + np.random.default_rng(seed).random(len(r))
    return fn


def _session(lazy=False):
    return repro_torch.Session(engine=t_engine.TorchEngine(device="cpu"),
                               leaf_n=LEAF_N, bs=BS, lazy=lazy)


def _banded(s, seed, d=9):
    rows, cols = banded_pairs(N, d)
    return s.from_pattern(rows, cols, N, value_fn=_values(seed))


def _overlap(s, seed, name=None):
    coords = particle_cloud(6, 3, seed=7)
    rows, cols = overlap_pairs(coords, 4.5, order=divide_space_order(coords))
    keep = (rows < N) & (cols < N)
    return s.from_pattern(rows[keep], cols[keep], N, upper=True,
                          value_fn=_values(seed), name=name)


# each case: () -> (C matrices, wave records of every engine and coalescer)
def _eager(build):
    def case():
        s = _session()
        cs = build(s)
        s.flush()
        return cs, s.engine_stats()["wave_log"]
    return case


def _truncated(s):
    a = _banded(s, 1)
    c = a.multiply(_banded(s, 2), tau=6.0)
    assert c.error_bound > 0        # the norm test dropped pairs
    return [c]


def _replay():
    s = _session(lazy=True)
    s1, s2 = _overlap(s, 1, "S"), _overlap(s, 2, "S")
    plan = s.compile(s1.sym_square())
    cs = [plan.run()]
    s.flush()
    cs.append(plan.run(flush=False, S=s2))
    s.flush()
    return cs, s.engine_stats()["wave_log"]


def _two_engines():
    """A banded product and an S2 square, in two sessions, coalesced."""
    s1, s2 = _session(), _session()
    cs = [_banded(s1, 1) @ _banded(s1, 2), _overlap(s2, 3).sym_square()]
    co = WaveCoalescer()
    co.flush([s1.graph, s2.graph])
    assert co.merged_waves >= 1
    return cs, (co.waves + s1.engine_stats()["wave_log"]
                + s2.engine_stats()["wave_log"])


CASES = {
    "banded_ab": _eager(lambda s: [_banded(s, 1) @ _banded(s, 2, d=5)]),
    "banded_at_b": _eager(lambda s: [_banded(s, 1).T @ _banded(s, 2, d=5)]),
    "banded_a_bt": _eager(lambda s: [_banded(s, 1) @ _banded(s, 2, d=5).T]),
    "s2_sym_square": _eager(lambda s: [_overlap(s, 1).sym_square()]),
    "syrk": _eager(lambda s: [_banded(s, 1).syrk(),
                              _banded(s, 2).syrk(trans=True)]),
    "sym_multiply": _eager(lambda s: [
        _overlap(s, 1).sym_multiply(_banded(s, 2), side="left"),
        _overlap(s, 3).sym_multiply(_banded(s, 4), side="right")]),
    "truncated": _eager(_truncated),
    "float32_operand": _eager(
        lambda s: [(_banded(s, 1) @ _banded(s, 2)) @ _banded(s, 3)]),
    "replay": _replay,
    "two_engines": _two_engines,
}


def _run(monkeypatch, case, gather):
    monkeypatch.setattr(t_engine, "gather_wave", gather)
    cs, waves = CASES[case]()
    dense = [c.to_dense() for c in cs]
    return dense, [{k: v for k, v in w.items() if k != "wall_s"}
                   for w in waves]


@pytest.mark.parametrize("case", CASES)
def test_gather_equals_the_per_pair_loop(monkeypatch, case):
    packed = []

    def checked(tasks, tracer=None):
        got, want = GATHER(tasks), _loop_gather(tasks)
        for g, w in zip(got[:5], want[:5]):
            assert g.flags.c_contiguous
            assert (g.dtype, g.shape) == (w.dtype, w.shape)
            assert g.tobytes() == w.tobytes()
        assert got[5] == want[5]
        packed.append(len(got[0]))
        return got

    c_new, waves_new = _run(monkeypatch, case, checked)
    assert packed and all(packed)
    c_old, waves_old = _run(monkeypatch, case, _loop_gather)
    assert waves_new == waves_old
    for x, y in zip(c_new, c_old, strict=True):
        assert x.dtype == y.dtype
        assert x.tobytes() == y.tobytes()
