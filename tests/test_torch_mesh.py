"""The port's mesh executor (``launch/mesh_exec.py``) against the reference's.

Pinned five ways:

1. **World of one, in process** — ``Session(engine=MeshEngine(device=
   "cpu"))`` matches the numpy engine within 1e-4 and the reference's
   ``MeshEngine`` at one device: the same task graph, wave log and
   ``comm_log``.
2. **gloo CPU ranks** (tests/torch_dist_scenarios.py, one process per
   rank): results within 1e-3 of float64 at p = 1, 4 and 8 with identical
   checksums across p; replay, rebind and free-then-reuse counters; the
   three mesh records of the committed ``BENCH_mesh_comm.json`` exactly;
   at p = 4 the whole ``comm_log`` and the task graph equal to the
   reference's ``MeshEngine`` over 4 forced host devices.
3. **Reports** — ``from_engine_stats``, ``mesh_stats_events``, the
   report's mesh table and the roofline's collective term on the port's
   stats.
4. **Contract** — no fallback: without CUDA ``MeshEngine()`` raises; a
   group smaller than ``n_dev`` raises.
5. **Planner** — :func:`~repro_torch.launch.mesh_exec.plan_wave` against
   the per-pair loops it replaced, kept here as the oracle, on every wave
   of the gather cases at 1, 2, 4 and 8 ranks and for every rank; and a
   world of one gives the bits of a ``TorchEngine``.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core.patterns import (banded_mask, random_mask,  # noqa: E402
                                 random_symmetric_mask, values_for_mask)
from repro.launch.mesh_exec import MeshEngine as RefMeshEngine  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.launch import mesh_exec  # noqa: E402
from repro_torch.launch.mesh_exec import MeshEngine  # noqa: E402
from test_torch_distributed import P4, ROOT, SCRIPT, run_ranks  # noqa: E402
from test_torch_gather import CASES as GATHER_CASES  # noqa: E402
from test_torch_gather import task_pairs  # noqa: E402

N, LEAF_N, BS = 64, 16, 4
TOL = dict(atol=1e-4)          # mesh packs float32; numpy is float64
BENCH = json.loads((ROOT / "BENCH_mesh_comm.json").read_text())


def _strip(log):
    return [{k: v for k, v in e.items() if k != "wall_s"} for e in log]


def _sessions(kernel="gemm"):
    return (repro_torch.Session(engine=MeshEngine(kernel=kernel,
                                                  device="cpu"),
                                leaf_n=LEAF_N, bs=BS),
            repro_torch.Session(engine="numpy", leaf_n=LEAF_N, bs=BS))


class TestWorldOfOne:
    """In process, no process group: rank 0 of 1, no collective call."""

    PATTERNS = {
        "banded": lambda: values_for_mask(banded_mask(N, 5), seed=1),
        "random": lambda: values_for_mask(random_mask(N, 0.1, seed=2),
                                          seed=2),
        "nil_quadrant": lambda: np.triu(
            values_for_mask(banded_mask(N, 9), seed=3)),
    }

    @pytest.mark.parametrize("kernel", ["gemm", "pairs"])
    @pytest.mark.parametrize("pattern", sorted(PATTERNS))
    def test_multiply(self, pattern, kernel):
        a = self.PATTERNS[pattern]()
        b = values_for_mask(banded_mask(N, 7), seed=4)
        mesh, ref = _sessions(kernel)
        got = (mesh.from_dense(a) @ mesh.from_dense(b)).to_dense()
        want = (ref.from_dense(a) @ ref.from_dense(b)).to_dense()
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("case", ["at_b", "a_bt", "at_bt"])
    def test_transposes(self, case):
        a = values_for_mask(banded_mask(N, 5), seed=5)
        b = values_for_mask(random_mask(N, 0.15, seed=6), seed=6)
        op = {"at_b": lambda A, B: A.T @ B,
              "a_bt": lambda A, B: A @ B.T,
              "at_bt": lambda A, B: (B @ A).T}[case]
        mesh, ref = _sessions()
        got = op(mesh.from_dense(a), mesh.from_dense(b)).to_dense()
        want = op(ref.from_dense(a), ref.from_dense(b)).to_dense()
        np.testing.assert_allclose(got, want, **TOL)

    def test_sym_square(self):
        s = values_for_mask(random_symmetric_mask(N, 0.15, seed=7),
                            seed=7, symmetric=True)
        mesh, ref = _sessions()
        got = mesh.from_dense(s, upper=True).sym_square().to_dense()
        want = ref.from_dense(s, upper=True).sym_square().to_dense()
        np.testing.assert_allclose(got, want, **TOL)

    def test_truncated_multiply_same_structure(self):
        idx = np.arange(N)
        decay = np.exp(-np.abs(idx[:, None] - idx[None, :]) / 3.0)
        a = np.random.default_rng(8).standard_normal((N, N)) * decay
        mesh, ref = _sessions()
        gm = mesh.from_dense(a).multiply(mesh.from_dense(a), tau=1e-2)
        gr = ref.from_dense(a).multiply(ref.from_dense(a), tau=1e-2)
        np.testing.assert_allclose(gm.to_dense(), gr.to_dense(), **TOL)
        assert abs(gm.error_bound - gr.error_bound) < 1e-10

    def test_nil_stays_nil(self):
        a = np.zeros((N, N))
        a[: N // 2, : N // 2] = values_for_mask(banded_mask(N // 2, 5),
                                                seed=9)
        mesh, ref = _sessions()
        got, want = (mesh.from_dense(a) @ mesh.from_dense(a),
                     ref.from_dense(a) @ ref.from_dense(a))
        assert mesh.graph.is_nil(got.node) == ref.graph.is_nil(want.node)
        np.testing.assert_allclose(got.to_dense(), want.to_dense(), **TOL)

    @pytest.mark.parametrize("kernel", ["gemm", "pairs"])
    def test_logs_equal_reference_mesh_engine(self, kernel):
        """Against the reference's MeshEngine at one device: the same task
        graph, wave log, comm_log and counters."""
        sym = values_for_mask(random_symmetric_mask(N, 0.15, seed=7), seed=7,
                              symmetric=True)
        a = values_for_mask(banded_mask(N, 5), seed=1)
        out = []
        for Sess, eng in ((repro_torch.Session,
                           MeshEngine(kernel=kernel, device="cpu")),
                          (repro.Session, RefMeshEngine(n_dev=1,
                                                        kernel=kernel))):
            sess = Sess(engine=eng, leaf_n=LEAF_N, bs=BS)
            A, S = sess.from_dense(a), sess.from_dense(sym, upper=True)
            res = [(A @ A.T).to_dense(), S.sym_square().to_dense()]
            out.append((sess.task_counts(), sess.engine_stats(), res))
        (tc, st, res), (rtc, rst, rres) = out
        assert tc == rtc
        assert _strip(st["wave_log"]) == _strip(rst["wave_log"])
        assert _strip(st["comm_log"]) == _strip(rst["comm_log"])
        for k in ("n_dev", "fetched_bytes", "fetched_blocks", "pushed_bytes",
                  "collective_bytes", "device_blocks", "device_leaves",
                  "backend", "kernel", "batched_pairs", "padded_pairs"):
            assert st[k] == rst[k], k
        assert st["collective_bytes"] == [0] and st["n_dev"] == 1
        for x, y in zip(res, rres):
            np.testing.assert_allclose(x, y, atol=1e-5)


def _loop_plan(tasks, owners, owner_map, n_dev, me):
    """The per-pair loops the mesh planned its waves with before
    ``plan_wave``, without the residency accounting.  Updates
    ``owner_map`` as the engine's ``_owner`` was."""
    # operand slots: one per distinct (leaf, key, transpose), homed on
    # the leaf's owning rank (producer, else first touch)
    slot_home, slot_leaf = {}, {}
    needs = [dict() for _ in range(n_dev)]      # ordered sets
    for t, dev in zip(tasks, owners.tolist()):
        owner_map[id(t.out)] = dev
        srcs = {"a": t.a_leaf, "b": t.b_leaf}
        for src_a, ka, tra, src_b, kb, trb, _ in task_pairs(t):
            for src, kk, tr in ((src_a, ka, tra), (src_b, kb, trb)):
                leaf = srcs[src]
                sk = (id(leaf), kk, tr)
                if sk not in slot_home:
                    slot_home[sk] = owner_map.setdefault(id(leaf), dev)
                    slot_leaf[sk] = leaf
                needs[dev].setdefault(sk)
    # per-rank own pools
    own_keys = [[] for _ in range(n_dev)]
    own_pos = {}
    for sk, h in slot_home.items():
        own_pos[sk] = len(own_keys[h])
        own_keys[h].append(sk)
    cap_own = max(1, max(len(k) for k in own_keys))
    bs = tasks[0].out.bs
    own_pool = np.zeros((cap_own, bs, bs), np.float32)
    for i, sk in enumerate(own_keys[me]):
        blk = slot_leaf[sk].blocks[sk[1]]
        own_pool[i] = blk.T if sk[2] else blk
    # shipments grouped by ring shift s = (dst - home) mod n_dev
    ship, ship_pos, fetch = {}, {}, []
    for d in range(n_dev):
        for sk in needs[d]:
            h = slot_home[sk]
            if h == d:
                continue
            s = (d - h) % n_dev
            lst = ship.setdefault(s, [[] for _ in range(n_dev)])[h]
            ship_pos[(s, sk)] = len(lst)
            lst.append(sk)
            if d == me:
                fetch.append(sk)
    shifts = sorted(ship)
    cnts = [max(len(lst) for lst in ship[s]) for s in shifts]
    seg_off, off = {}, cap_own
    for s, cnt in zip(shifts, cnts):
        seg_off[s] = off
        off += cnt
    send = []
    for s, cnt in zip(shifts, cnts):
        sel = np.zeros(cnt, np.int64)
        for i, sk in enumerate(ship[s][me]):
            sel[i] = own_pos[sk]
        send.append(sel)

    def pos_on(d, sk):
        h = slot_home[sk]
        if h == d:
            return own_pos[sk]
        s = (d - h) % n_dev
        return seg_off[s] + ship_pos[(s, sk)]

    # pair tables
    out_base, n_out = [], [0] * n_dev
    for t, dev in zip(tasks, owners.tolist()):
        out_base.append(n_out[dev])
        n_out[dev] += len(t.out.blocks)
    cap_c = max(1, max(n_out))
    my_pairs, n_pairs = [], [0] * n_dev
    for t, dev, base in zip(tasks, owners.tolist(), out_base):
        t_pairs = task_pairs(t)
        n_pairs[dev] += len(t_pairs)
        if dev != me:
            continue
        key_slot = {key: base + i for i, key in enumerate(t.out.blocks)}
        srcs = {"a": t.a_leaf, "b": t.b_leaf}
        for src_a, ka, tra, src_b, kb, trb, out_key in t_pairs:
            my_pairs.append((pos_on(me, (id(srcs[src_a]), ka, tra)),
                             pos_on(me, (id(srcs[src_b]), kb, trb)),
                             key_slot[out_key]))
    cap_p = max(1, max(n_pairs))
    sa = np.zeros(cap_p, np.int32)
    sb = np.zeros(cap_p, np.int32)
    seg = np.full(cap_p, cap_c, np.int32)
    for i, (pa, pb, pc) in enumerate(sorted(my_pairs, key=lambda x: x[2])):
        sa[i], sb[i], seg[i] = pa, pb, pc
    return dict(slot_home=slot_home, own_keys=own_keys, own_pos=own_pos,
                own_pool=own_pool, ship={s: ship[s] for s in shifts},
                ship_pos=ship_pos, cnts=cnts, fetch=fetch, send=send,
                pool_len=off, out_base=out_base, n_out=n_out,
                n_pairs=n_pairs, cap_own=cap_own, cap_c=cap_c, cap_p=cap_p,
                sa=sa, sb=sb, seg=seg)


def _same_bytes(x, y):
    assert (x.dtype, x.shape) == (y.dtype, y.shape)
    assert x.tobytes() == y.tobytes()


def _check_plan(num, tasks, owners, owner_map, n_dev, me):
    """plan_wave's tables against the oracle's, at one rank; returns the
    owner map as the engine leaves it after the wave."""
    plan = mesh_exec.plan_wave(num, owners, owner_map, n_dev, me)
    old_map = dict(owner_map)
    want = _loop_plan(tasks, owners, old_map, n_dev, me)
    keys = [(id(leaf), key, tr) for leaf, key, tr
            in num.blocks(plan.slot_code)]
    assert keys == list(want["slot_home"])
    assert plan.home.tolist() == list(want["slot_home"].values())
    assert [[keys[i] for i in o] for o in plan.own] == want["own_keys"]
    assert {keys[i]: p for o in plan.own
            for p, i in enumerate(o.tolist())} == want["own_pos"]
    ship = {s: [[keys[i] for i in lst] for lst in lists]
            for s, lists in plan.ship.items()}
    assert list(ship) == list(want["ship"]) and ship == want["ship"]
    assert {(s, sk): p for s, lists in ship.items() for lst in lists
            for p, sk in enumerate(lst)} == want["ship_pos"]
    assert [keys[i] for i in plan.fetch] == want["fetch"]
    assert plan.cap_own + sum(plan.cnts) == want["pool_len"]
    assert plan.out_base.tolist() == want["out_base"]
    for k in ("cnts", "n_out", "n_pairs", "cap_own", "cap_c", "cap_p"):
        assert getattr(plan, k) == want[k], k
    for x, y in zip(plan.send, want["send"], strict=True):
        _same_bytes(x, y)
    for k in ("sa", "sb", "seg"):
        _same_bytes(getattr(plan, k), want[k])
    _same_bytes(num.stack(plan.slot_code[plan.own[me]], plan.cap_own),
                want["own_pool"])
    new_map = dict(owner_map)
    new_map.update(plan.leaf_homes)
    new_map.update(zip((id(t.out) for t in tasks), owners.tolist()))
    assert new_map == old_map
    return new_map


class TestPlanner:
    """plan_wave on the CPU with no process group."""

    @pytest.mark.parametrize("case", [c for c in GATHER_CASES
                                      if c != "two_engines"])
    def test_plan_equals_the_per_pair_loops(self, monkeypatch, case):
        owner_maps = {n: {} for n in (1, 2, 4, 8)}
        waves = []

        def checked(tasks, tracer=None):
            num = mesh_exec.number_wave(tasks)
            nt = len(tasks)
            for n_dev, owner_map in owner_maps.items():
                owners = ((np.arange(nt) + 1) * n_dev - 1) // nt
                for me in range(n_dev):
                    after = _check_plan(num, tasks, owners, owner_map,
                                        n_dev, me)
                owner_maps[n_dev] = after
            waves.append(nt)
            return gather(tasks)

        gather = t_engine.gather_wave
        monkeypatch.setattr(t_engine, "gather_wave", checked)
        GATHER_CASES[case]()
        assert waves

    def test_world_of_one_bits_equal_torch_engine(self):
        """Every wave of the pairs route packs the same products in the
        same order on both engines, so C is the same bits."""
        a = values_for_mask(banded_mask(N, 5), seed=1)
        b = values_for_mask(random_mask(N, 0.15, seed=6), seed=6)
        s = values_for_mask(random_symmetric_mask(N, 0.15, seed=7), seed=7,
                            symmetric=True)
        got = []
        for eng in (MeshEngine(kernel="pairs", device="cpu"),
                    t_engine.TorchEngine(kernel="pairs", device="cpu")):
            sess = repro_torch.Session(engine=eng, leaf_n=LEAF_N, bs=BS)
            A, B = sess.from_dense(a), sess.from_dense(b)
            S = sess.from_dense(s, upper=True)
            outs = [A @ B, A.T @ B, (A @ B) @ A.T, S.sym_square(), A.syrk(),
                    S.sym_multiply(B), A.multiply(B, tau=0.5)]
            got.append([o.to_dense() for o in outs])
        for x, y in zip(*got, strict=True):
            _same_bytes(x, y)


class TestLifecycle:
    def test_free_then_reuse(self):
        a = np.random.default_rng(0).standard_normal((N, N)) * 0.1
        sess = repro_torch.Session(engine=MeshEngine(device="cpu"),
                                   leaf_n=LEAF_N, bs=BS)
        M = sess.from_dense(a)
        P = M @ M
        P.to_dense()
        st1 = sess.engine_stats()
        assert st1["device_leaves"] > 0
        sess.free(P)
        st2 = sess.engine_stats()
        assert st2["device_leaves"] < st1["device_leaves"]
        assert st2["device_blocks"] < st1["device_blocks"]
        assert st2["fetched_bytes"] == st1["fetched_bytes"]
        assert st2["pushed_bytes"] == st1["pushed_bytes"]
        Q = M @ M.T
        np.testing.assert_allclose(Q.to_dense(), a @ a.T, **TOL)

    def test_rebind_bumps_version_and_repushes(self):
        rng = np.random.default_rng(1)
        a = rng.standard_normal((N, N)) * 0.1
        sess = repro_torch.Session(engine=MeshEngine(device="cpu"),
                                   leaf_n=LEAF_N, bs=BS, lazy=True)
        X = sess.from_dense(a, name="X")
        plan = sess.compile(X @ X)
        np.testing.assert_allclose(plan.run().to_dense(), a @ a, **TOL)
        st1 = sess.engine_stats()
        a2 = rng.standard_normal((N, N)) * 0.1
        np.testing.assert_allclose(plan.run(X=a2).to_dense(), a2 @ a2,
                                   **TOL)
        assert sum(sess.engine_stats()["pushed_bytes"]) > \
            sum(st1["pushed_bytes"])

    def test_engine_stats_shape(self):
        a = values_for_mask(banded_mask(N, 5), seed=1)
        sess = repro_torch.Session(engine=MeshEngine(device="cpu"),
                                   leaf_n=LEAF_N, bs=BS)
        (sess.from_dense(a) @ sess.from_dense(a)).to_dense()
        st = sess.engine_stats()
        assert st["backend"] == "mesh" and st["n_dev"] == 1
        for key in ("fetched_bytes", "fetched_blocks", "pushed_bytes",
                    "collective_bytes"):
            assert len(st[key]) == 1 and all(v >= 0 for v in st[key])
        assert st["waves"] == len(st["comm_log"]) > 0

    def test_tracing_spans_carry_the_counters(self):
        a = values_for_mask(banded_mask(N, 5), seed=1)
        sess = repro_torch.Session(engine=MeshEngine(device="cpu"),
                                   leaf_n=LEAF_N, bs=BS)
        with sess.tracing() as tr:
            (sess.from_dense(a) @ sess.from_dense(a)).to_dense()
        (wave,) = tr.find("engine.wave")
        assert wave.attrs["n_dev"] == 1
        assert wave.attrs["pushed_bytes_by_dev"][0] > 0
        assert tr.find("kernel.dispatch")


    def test_traced_solve_wave_carries_no_comm_record(self):
        """An inverse Cholesky runs as an inherited solve wave with no
        comm record: its span has none, the multiply's span has its own
        (the reference's MeshEngine raises IndexError here)."""
        s = np.eye(N) * 2 + 0.1 * (np.eye(N, k=1) + np.eye(N, k=-1))
        sess = repro_torch.Session(engine=MeshEngine(device="cpu"),
                                   leaf_n=LEAF_N, bs=BS)
        with sess.tracing() as tr:
            Z = sess.from_dense(s, upper=True).inv_chol()
            P = Z.T @ Z
            P.to_dense()
        kinds = [w.attrs["kernel"] for w in tr.find("engine.wave")]
        assert kinds[0] == "inv_chol" and "gemm" in kinds
        for w in tr.find("engine.wave"):
            assert ("n_dev" in w.attrs) == (w.attrs["kernel"] == "gemm")
        assert len(sess.engine_stats()["comm_log"]) == kinds.count("gemm")

    def test_coalescer_leaves_mesh_waves_to_their_engine(self):
        """The serving coalescer merges only plain TorchEngines; a
        MeshEngine flushes its own waves and logs its comm record."""
        from repro_torch.serve import WaveCoalescer
        a = values_for_mask(banded_mask(N, 5), seed=1)
        graphs, outs = [], []
        for _ in range(2):
            sess = repro_torch.Session(engine=MeshEngine(device="cpu"),
                                       lazy=True, leaf_n=LEAF_N, bs=BS)
            x = sess.from_dense(a, name="X")
            plan = sess.compile(x @ x)
            outs.append((sess, plan.run(flush=False)))
            graphs.append(sess.graph)
        co = WaveCoalescer()
        assert co.flush(graphs) == 0
        assert co.merged_waves == 0 and co.solo_waves == 0
        for sess, out in outs:
            np.testing.assert_allclose(out.to_dense(), a @ a, **TOL)
            st = sess.engine_stats()
            assert st["waves"] == len(st["comm_log"]) == 1


class TestContract:
    def test_no_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MeshEngine()

    def test_bad_kernel(self):
        with pytest.raises(ValueError, match="kernel"):
            MeshEngine(kernel="conv", device="cpu")

    def test_n_dev_beyond_the_world_raises(self):
        sess = repro_torch.Session(engine=MeshEngine(n_dev=4, device="cpu"),
                                   leaf_n=LEAF_N, bs=BS)
        a = sess.from_dense(np.eye(N))
        with pytest.raises(ValueError, match="only 1 ranks"):
            (a @ a).to_dense()

    def test_launch_ranks_fails_with_a_rank(self):
        from repro_torch.launch.mesh import launch_ranks
        with pytest.raises(RuntimeError, match="exited with code"):
            launch_ranks(os.abort, 2, timeout=120)

    def test_production_mesh_waits_for_item_8(self):
        """The production meshes are ported (queue 1 item 8, step 4): a
        world of one is refused naming the 256 and 512 ranks they need."""
        from repro_torch.launch import mesh
        with pytest.raises(ValueError, match="world of 256 ranks"):
            mesh.make_production_mesh()
        with pytest.raises(ValueError, match="world of 512 ranks"):
            mesh.make_production_mesh(multi_pod=True)
        assert mesh.make_spmm_mesh() is None     # a world of one
        with pytest.raises(ValueError, match="n_dev=2"):
            mesh.make_spmm_mesh(2)


class TestOnRanks:
    """gloo CPU ranks, one process each."""

    @pytest.mark.parametrize("p", [1, 4, 8])
    def test_equivalence(self, p):
        out = run_ranks(p, "mesh_engine_equivalence", "bench_mesh")
        assert out["mesh_engine_equivalence"]["stats"]["n_dev"] == p

    def test_identical_results_across_rank_counts(self):
        sums = {run_ranks(p, "mesh_engine_equivalence", "bench_mesh")[
            "mesh_engine_equivalence"]["checksum"] for p in (1, 4, 8)}
        assert len(sums) == 1, sums

    @pytest.mark.parametrize("p", [1, 4])
    def test_counters(self, p):
        out = run_ranks(p, "mesh_engine_counters")["mesh_engine_counters"]
        assert out["push_replay"] < out["push_first"]
        assert out["push_replay"] < out["push_rebind"]

    @pytest.mark.parametrize("p", [2, 4, 8])
    def test_bench_record_exactly(self, p):
        """benchmarks/bench_mesh_comm.py's mesh program on p ranks gives
        the committed record, counter for counter."""
        names = ("mesh_engine_equivalence", "bench_mesh") if p != 2 else \
            ("bench_mesh",)
        got = run_ranks(p, *names)["bench_mesh"]["record"]
        (want,) = [r for r in BENCH["records"]
                   if r["scheme"] == "mesh" and r["p"] == p]
        assert got == want

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def reference(program: str) -> dict:
        """The reference's MeshEngine over 4 forced host devices."""
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, str(SCRIPT), "ref", program],
                             capture_output=True, text=True, env=env,
                             timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("RESULT ")]
        return json.loads(line[-1][len("RESULT "):])

    @pytest.mark.parametrize("program", ["mesh_engine_equivalence",
                                         "bench_mesh"])
    def test_comm_log_equals_reference_p4(self, program):
        """Per wave and per device: shifts, shipped and padded blocks, pool
        and capacities, and the fetched, pushed and collective deltas."""
        port = run_ranks(4, "mesh_engine_equivalence", "bench_mesh")[program]
        ref = self.reference(program)
        assert _strip(port["stats"]["comm_log"]) == \
            _strip(ref["stats"]["comm_log"])
        assert _strip(port["stats"]["wave_log"]) == \
            _strip(ref["stats"]["wave_log"])
        assert port["task_counts"] == ref["task_counts"]
        for k in ("fetched_bytes", "fetched_blocks", "pushed_bytes",
                  "collective_bytes", "n_dev", "waves"):
            assert port["stats"][k] == ref["stats"][k], k

    def test_equivalence_checksum_close_to_reference_p4(self):
        port = run_ranks(4, "mesh_engine_equivalence", "bench_mesh")[
            "mesh_engine_equivalence"]["checksum"]
        ref = self.reference("mesh_engine_equivalence")["checksum"]
        np.testing.assert_allclose(np.array(port.split(), float),
                                   np.array(ref.split(), float), rtol=1e-6)

    def test_free_then_reuse_on_ranks(self):
        out = run_ranks(4, "mesh_engine_counters")["mesh_engine_counters"]
        before, after = zip(*out["device_leaves_by_rank"])
        assert sum(after) < sum(before)


class TestReports:
    def _stats(self):
        return run_ranks(4, "mesh_engine_equivalence", "bench_mesh")[
            "bench_mesh"]["stats"]

    def test_metrics_from_engine_stats(self):
        from repro.obs import from_engine_stats as ref_fes
        from repro_torch.obs import from_engine_stats, validate_metrics
        st = self._stats()
        ms = from_engine_stats(st)
        assert ms.source == "engine:mesh"
        validate_metrics(ms.to_dict())
        assert ms.to_dict() == ref_fes(st).to_dict()
        assert ms["fetched_bytes"].per_worker == st["fetched_bytes"]
        assert max(ms["fetched_bytes"].per_worker) == 4352

    def test_mesh_stats_events(self):
        from repro.obs import mesh_stats_events as ref_events
        from repro_torch.obs import chrome_trace, mesh_stats_events
        st = self._stats()
        assert mesh_stats_events(st) == ref_events(st)
        tr = chrome_trace(mesh_stats_events(st))
        last = {}
        for e in sorted((e for e in tr["traceEvents"] if e["ph"] == "C"
                         and e["name"].startswith("fetched_bytes")),
                        key=lambda e: e["ts"]):
            last[e["tid"]] = e["args"]["bytes"]
        assert sum(last.values()) == sum(st["fetched_bytes"])

    def test_report_renders_the_ports_records(self):
        """The port's records of the bench's programs (mesh at p = 2, 4, 8
        on ranks, SpSUMMA's counted bytes at p = 4, 16) render the table
        the reference renders from the committed artifact."""
        from repro.launch.report import mesh_comm_table as ref_table
        from repro_torch.launch.report import mesh_comm_table
        recs = [run_ranks(p, *(("mesh_engine_equivalence", "bench_mesh")
                               if p != 2 else ("bench_mesh",)))[
            "bench_mesh"]["record"] for p in (2, 4, 8)]
        for p in (4, 16):
            by_rank = run_ranks(*((16, "summa_bytes") if p == 16
                                  else (4, *P4)))["summa_bytes"]
            recs.append({"scheme": "summa", "p": p, "n": 128 * p,
                         "coll_bytes_per_dev": max(
                             by_rank["collective_bytes_by_rank"]),
                         "pgrid": by_rank["pgrid"]})
        f = [r["max_fetched_bytes_per_dev"] for r in recs[:3]]
        doc = {"records": recs, "mesh_fetch_growth_2_to_8": f[2] / f[0],
               "flat_2_to_8": f[2] / f[0] <= 2.0,
               "summa_coll_growth_4_to_16": recs[4]["coll_bytes_per_dev"]
               / recs[3]["coll_bytes_per_dev"]}
        assert mesh_comm_table(doc) == ref_table(BENCH)

    def test_roofline_collective_term(self):
        from repro_torch.launch import roofline as RL
        st = self._stats()
        assert RL.mesh_collective_bytes(st) == 4352
        assert RL.mesh_collective_bytes({"collective_bytes": 219648}) == 219648
        rl = RL.from_mesh_stats(st)
        assert rl.n_chips == 4 and rl.coll_bytes == 4352
        assert rl.t_collective == pytest.approx(4352 / RL.NVLINK_BPS)
        assert rl.bottleneck == "collective"
