"""Multi-rank scenarios of the port, run on gloo CPU ranks in a subprocess.

The port's counterpart of tests/dist_scenarios.py: there every scenario
runs in one process over forced host devices; here

    python tests/torch_dist_scenarios.py <p> <scenario> [<scenario> ...]

starts p ranks (``repro_torch.launch.mesh.launch_ranks``, spawned
processes on one gloo group), each rank runs the named scenarios in turn
and asserts internally, and the script prints one ``RESULT <json>`` line
(rank 0's results by scenario, and every rank's for ``*_by_rank`` keys)
and ``OK``.  ``python tests/torch_dist_scenarios.py ref <scenario>``
runs a scenario's reference program on the reference's ``MeshEngine``
(one process; set ``XLA_FLAGS=--xla_force_host_platform_device_count=N``)
and prints its ``RESULT``.  tests/test_torch_mesh.py and
tests/test_torch_distributed.py drive both.
"""
import json
import os
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _setup(n, bs, band_d, seed=1):
    from repro_torch.core.patterns import (banded_mask,
                                           block_mask_from_element_mask,
                                           values_for_mask)
    a = values_for_mask(banded_mask(n, band_d), seed=seed).astype(np.float32)
    b = values_for_mask(banded_mask(n, band_d // 2 + 1),
                        seed=seed + 1).astype(np.float32)
    ma = block_mask_from_element_mask(np.abs(a) > 0, bs)
    mb = block_mask_from_element_mask(np.abs(b) > 0, bs)
    return a, b, ma, mb


def _shards(rank, *arrays):
    import torch
    return [torch.from_numpy(np.ascontiguousarray(x[rank])) for x in arrays]


def _gather_c(cb, cr, cc, grid, bs):
    """Every rank's C shard, assembled dense on every rank."""
    from repro_torch.core import distributed as dist
    parts = [dist.all_gather(None, x).numpy() for x in (cb, cr, cc)]
    return dist.gather_dense(*parts, grid, bs)


# ---------------------------------------------------------------------------
# the distributed multiplies (ports of dist_scenarios.py's scenarios)
# ---------------------------------------------------------------------------

def halo_correctness(rank, p, n=256, bs=8, use_pair_kernel=False, d=12,
                     seed=1):
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_spmm_mesh
    a, b, ma, mb = _setup(n, bs, d, seed=seed)
    plan = dist.plan_distribution(ma, mb, bs, p)
    sa = dist.distribute_morton(a, bs, plan)
    sb = dist.distribute_morton(b, bs, plan)
    comm = {}
    cb, cr, cc, npairs = dist.halo_spmm(
        make_spmm_mesh(), "dev", plan, *_shards(rank, *sa, *sb),
        use_pair_kernel=use_pair_kernel, comm=comm)
    out = _gather_c(cb, cr, cc, plan.grid, bs)
    np.testing.assert_allclose(out, a @ b, atol=1e-3)
    total_pairs = int(dist.all_gather(None, npairs.reshape(1)).sum())
    assert total_pairs > 0
    return {"collective_bytes": comm.get("collective_bytes", 0),
            "halo_hops": plan.halo_hops, "pairs": total_pairs}


def halo_random_pattern(rank, p):
    """Locality-free pattern still computes correctly (just more halo)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.patterns import (block_mask_from_element_mask,
                                           random_mask, values_for_mask)
    from repro_torch.launch.mesh import make_spmm_mesh
    n, bs = 128, 8
    a = values_for_mask(random_mask(n, 0.05, seed=3), seed=3).astype(
        np.float32)
    ma = block_mask_from_element_mask(np.abs(a) > 0, bs)
    plan = dist.plan_distribution(ma, ma, bs, p)
    sa = dist.distribute_morton(a, bs, plan)
    cb, cr, cc, _ = dist.halo_spmm(make_spmm_mesh(), "dev", plan,
                                   *_shards(rank, *sa, *sa))
    np.testing.assert_allclose(_gather_c(cb, cr, cc, plan.grid, bs), a @ a,
                               atol=1e-3)
    return {}


def halo_pair_kernel(rank, p):
    return halo_correctness(rank, p, n=128, d=10, seed=7,
                            use_pair_kernel=True)


def demand_halo_v2(rank, p, n=512, bs=8, use_pair_kernel=False):
    """Demand-routed halo: correct, and fewer bytes than the v1 ring."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_spmm_mesh
    a, b, ma, mb = _setup(n, bs, 12)
    base = dist.plan_distribution(ma, mb, bs, p)
    dplan = dist.plan_demand(ma, mb, bs, p)
    args = _shards(rank, *dist.distribute_morton(a, bs, base),
                   *dist.distribute_morton(b, bs, base))
    mesh = make_spmm_mesh()
    v1, v2 = {}, {}
    outs = []
    for fn, plan, comm in ((dist.halo_spmm, base, v1),
                           (dist.demand_spmm, dplan, v2)):
        cb, cr, cc, _ = fn(mesh, "dev", plan, *args,
                           use_pair_kernel=use_pair_kernel, comm=comm)
        outs.append(_gather_c(cb, cr, cc, plan.grid, bs))
    for out in outs:
        np.testing.assert_allclose(out, a @ b, atol=1e-3)
    assert v2["collective_bytes"] < v1["collective_bytes"], (v1, v2)
    return {"v1_bytes": v1["collective_bytes"],
            "v2_bytes": v2["collective_bytes"]}


def demand_pair_kernel(rank, p):
    return demand_halo_v2(rank, p, use_pair_kernel=True)


def summa_correctness(rank, p, perm_seed=None):
    from repro_torch.core import spsumma
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_summa_mesh
    pgrid = spsumma.summa_pgrid(p)
    n, bs = 256, 8
    a, b, ma, mb = _setup(n, bs, 12)
    grid = n // bs
    perm = None
    if perm_seed is not None:
        perm = spsumma.random_block_permutation(grid, seed=perm_seed)
        mp = np.ix_(perm, perm)
        ma, mb = ma[mp], mb[mp]
    sp = spsumma.plan_summa(ma, mb, bs, pgrid)
    args = _shards(rank, *spsumma.distribute_panels(a, bs, sp, perm=perm),
                   *spsumma.distribute_panels(b, bs, sp, perm=perm))
    cb, cr, cc, _ = spsumma.summa_spmm(make_summa_mesh(), ("pr", "pc"), sp,
                                       *args)
    out = _gather_c(cb, cr, cc, sp.grid, bs)
    want = a @ b
    if perm is not None:
        gp = np.repeat(perm, bs) * bs + np.tile(np.arange(bs), grid)
        want = want[np.ix_(gp, gp)]
    np.testing.assert_allclose(out, want, atol=1e-3)
    return {}


def summa_random_permutation(rank, p):
    return summa_correctness(rank, p, perm_seed=5)


def summa_bytes(rank, p):
    """The SpSUMMA program of benchmarks/bench_mesh_comm.py (n = 128 p,
    banded_mask(n, 12) squared, bs 8): counted bytes per rank."""
    from repro_torch.core import spsumma
    from repro_torch.core.patterns import (banded_mask,
                                           block_mask_from_element_mask,
                                           values_for_mask)
    from repro_torch.launch.mesh import make_summa_mesh
    n, bs = 128 * p, 8
    a = values_for_mask(banded_mask(n, 12), seed=1).astype(np.float32)
    ma = block_mask_from_element_mask(np.abs(a) > 0, bs)
    sp = spsumma.plan_summa(ma, ma, bs, spsumma.summa_pgrid(p))
    sh = spsumma.distribute_panels(a, bs, sp)
    comm = {}
    cb, cr, cc, _ = spsumma.summa_spmm(make_summa_mesh(), ("pr", "pc"), sp,
                                       *_shards(rank, *sh, *sh), comm=comm)
    np.testing.assert_allclose(_gather_c(cb, cr, cc, sp.grid, bs), a @ a,
                               atol=1e-3)
    return {"collective_bytes_by_rank": comm["collective_bytes"],
            "cap_panel": sp.cap_panel, "pgrid": sp.pgrid}


def summa_pgrid_validation(rank, p):
    """p=6: non-square rank counts fail fast everywhere."""
    from repro_torch.core import spsumma
    from repro_torch.launch import mesh as lmesh
    assert p == 6, f"scenario needs 6 ranks, got {p}"
    for fn in (lambda: spsumma.summa_pgrid(6),
               lambda: lmesh.make_summa_mesh(),
               lambda: lmesh.make_summa_mesh(2)):
        try:
            fn()
        except ValueError as e:
            assert "perfect-square" in str(e) or "mis-shard" in str(e), e
        else:
            raise AssertionError("expected ValueError for p=6")
    return {}


# ---------------------------------------------------------------------------
# the mesh executor (ports of dist_scenarios.py's mesh_engine_* scenarios)
# ---------------------------------------------------------------------------

def equivalence_program(Session, engine):
    """Banded, random, symmetric and NIL-quadrant operands through five
    exact multiplies (with transposes) and a truncated one; returns the
    checksums, the engine's stats and the task counts.  The same text
    runs on the port and on the reference."""
    from repro_torch.core.patterns import (banded_mask, random_mask,
                                           random_symmetric_mask,
                                           values_for_mask)
    n = 128
    a = values_for_mask(banded_mask(n, 9), seed=1)
    b = values_for_mask(random_mask(n, 0.08, seed=2), seed=2)
    s = values_for_mask(random_symmetric_mask(n, 0.12, seed=3), seed=3,
                        symmetric=True)
    a[: n // 2, n // 2:] = 0.0           # NIL quadrant
    sess = Session(engine=engine, leaf_n=32, bs=8)
    A, B = sess.from_dense(a), sess.from_dense(b)
    S = sess.from_dense(s, upper=True)
    checks, fetched = [], []
    for got_m, want in [(A @ B, a @ b), (A.T @ B, a.T @ b),
                        (A @ B.T, a @ b.T), (A.multiply(B, tau=0.0), a @ b),
                        (S.sym_square(), s @ s)]:
        got = got_m.to_dense()
        np.testing.assert_allclose(got, want, atol=1e-3)
        checks.append(float(np.abs(got).sum()))
        fetched.append(list(sess.engine_stats()["fetched_bytes"]))
    T = A.multiply(B, tau=1e-3)
    assert np.abs(T.to_dense() - a @ b).max() < 5e-2
    return {"checksum": " ".join(f"{c:.6f}" for c in checks),
            "fetched_after_each": fetched, "stats": sess.engine_stats(),
            "task_counts": {str(k): v for k, v in sess.task_counts().items()}}


def _mesh_engine(**kw):
    from repro_torch.launch.mesh_exec import MeshEngine
    return MeshEngine(device="cpu", **kw)


def _plain(stats):
    """A stats dict as JSON (numpy scalars to Python)."""
    return json.loads(json.dumps(stats, default=lambda x: x.item()))


def mesh_engine_equivalence(rank, p):
    """Session(engine=MeshEngine) == float64 on p gloo ranks; counters
    monotone; the checksum is printed for the cross-p comparison."""
    from repro_torch import Session
    out = equivalence_program(Session, _mesh_engine())
    prev = np.zeros(p, np.int64)
    for cur in out["fetched_after_each"]:
        assert (np.asarray(cur) >= prev).all(), "fetch counters monotone"
        prev = np.asarray(cur)
    st = out["stats"]
    assert st["n_dev"] == p
    assert sum(st["pushed_bytes"]) > 0
    if p > 1:
        assert sum(st["fetched_blocks"]) > 0
    out["stats"] = _plain(st)
    return out


def mesh_engine_counters(rank, p):
    """Re-using resident operands is free (locality); rebinding a plan's
    inputs makes them stale (re-pushed); free then reuse keeps working."""
    from repro_torch import Session
    rng = np.random.default_rng(0)
    a = rng.standard_normal((128, 128)) * 0.1
    sess = Session(engine=_mesh_engine(), leaf_n=32, bs=8, lazy=True)
    X = sess.from_dense(a, name="X")
    plan = sess.compile(X @ X)
    Y = plan.run()
    np.testing.assert_allclose(Y.to_dense(), a @ a, atol=1e-3)
    push1 = sum(sess.engine_stats()["pushed_bytes"])
    plan.run()
    Y.to_dense()
    st2 = sess.engine_stats()
    delta_replay = sum(st2["pushed_bytes"]) - push1
    assert delta_replay < push1, (delta_replay, push1)
    a2 = rng.standard_normal((128, 128)) * 0.1
    Z = plan.run(X=a2)
    np.testing.assert_allclose(Z.to_dense(), a2 @ a2, atol=1e-3)
    st3 = sess.engine_stats()
    delta_rebind = sum(st3["pushed_bytes"]) - sum(st2["pushed_bytes"])
    assert delta_rebind > delta_replay, (delta_rebind, delta_replay)
    assert st3["n_dev"] == p
    # free then reuse, on an eager session
    sess = Session(engine=_mesh_engine(), leaf_n=32, bs=8)
    M = sess.from_dense(a)
    P = M @ M
    P.to_dense()
    st1 = sess.engine_stats()
    sess.free(P)
    st2 = sess.engine_stats()
    assert st2["device_leaves"] <= st1["device_leaves"]
    assert st2["device_blocks"] <= st1["device_blocks"]
    assert st2["fetched_bytes"] == st1["fetched_bytes"]
    Q = M @ M.T
    np.testing.assert_allclose(Q.to_dense(), a @ a.T, atol=1e-3)
    return {"push_first": push1, "push_replay": delta_replay,
            "push_rebind": delta_rebind,
            "device_leaves_by_rank": [st1["device_leaves"],
                                      st2["device_leaves"]]}


def bench_program(Session, engine, p):
    """benchmarks/bench_mesh_comm.py::child's mesh program (n = 128 p,
    banded_mask(n, 12) @ banded_mask(n, 7), leaf_n 32, bs 8); returns its
    record and the engine's stats."""
    from repro_torch.core.patterns import banded_mask, values_for_mask
    n = 128 * p
    a = values_for_mask(banded_mask(n, 12), seed=1)
    b = values_for_mask(banded_mask(n, 7), seed=2)
    sess = Session(engine=engine, leaf_n=32, bs=8)
    A, B = sess.from_dense(a), sess.from_dense(b)
    C = A @ B
    np.testing.assert_allclose(C.to_dense(), a @ b, atol=1e-3)
    st = sess.engine_stats()
    rec = {"scheme": "mesh", "p": p, "n": n,
           "max_fetched_bytes_per_dev": max(st["fetched_bytes"]),
           "sum_fetched_blocks": sum(st["fetched_blocks"]),
           "max_pushed_bytes_per_dev": max(st["pushed_bytes"]),
           "max_collective_bytes_per_dev": max(st["collective_bytes"]),
           "waves": st["waves"]}
    return {"record": rec, "stats": _plain(st),
            "task_counts": {str(k): v for k, v in sess.task_counts().items()}}


def bench_mesh(rank, p):
    from repro_torch import Session
    return bench_program(Session, _mesh_engine(), p)


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------

#: (arch, microbatch) of the data-parallel cases, on smoke configs
DP_CASES = (("llama3_2_3b", 0), ("mixtral_8x7b", 0), ("hubert_xlarge", 0),
            ("llama3_2_3b", 2))
DP_STEP_KW = dict(peak_lr=1e-2, warmup=1, total_steps=10)


def _rel(got, want) -> float:
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _dp_case(mesh, arch, micro, seq=64, global_batch=8):
    """One ZeRO-1 step of a smoke config over ``mesh``'s batch group
    against the one-device step on the whole batch, run by this rank
    itself; returns the largest relative errors (the moments against this
    rank's slice of the one-device moments), the share of the moments a
    rank holds and the parameters' largest distance from rank 0's."""
    import torch
    import torch.distributed as tdist

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.sharding import TrainStep, batch_axes, \
        tree_blocks
    from repro_torch.launch.train import batch_to, train_batch
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_smoke_config(arch)
    shape = ShapeSpec("dp", "train", seq, global_batch)
    whole = batch_to(cfg, train_batch(
        cfg, SyntheticLM(cfg.vocab, seq, global_batch, seed=3), 0,
        global_batch, seq), "cpu")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    n = 1
    shard = 0
    for a in batch_axes(mesh):
        shard = shard * sizes[a] + coord[a]
        n *= sizes[a]
    per = global_batch // n
    mine = {k: v[shard * per:(shard + 1) * per] for k, v in whole.items()}

    def fresh():
        return M.init_params(cfg, torch.Generator().manual_seed(5),
                             device="cpu")

    dp = TrainStep(cfg, mesh, microbatch=micro, **DP_STEP_KW)
    one = TrainStep(cfg, microbatch=micro, **DP_STEP_KW)
    assert dp.auto_microbatch(shape) == (micro or 1)
    params = fresh()
    loss, metrics, grads = dp.grads_fn(shape)(params, mine)
    loss1, metrics1, grads1 = one.grads_fn(shape)(params, whole)
    assert metrics.keys() == metrics1.keys()
    out = {
        "loss": _rel(loss, loss1),
        "metrics": max([_rel(metrics[k], metrics1[k]) for k in metrics],
                       default=0.0),
        "grads": max(_rel(g, w) for g, w in zip(tree_leaves(grads),
                                                tree_leaves(grads1))),
        "comm_bytes": dp.comm_bytes,
    }
    # control: a rank that skips the all-reduce has its own shard's grads
    _, _, own = one.grads_fn(shape)(params, mine)
    out["no_allreduce"] = max(_rel(g, w) for g, w in zip(
        tree_leaves(own), tree_leaves(grads1)))
    p_dp, o_dp, m_dp = dp.step_fn(shape)(fresh(), dp.adamw_init(params),
                                         mine)
    p_one, o_one, m_one = one.step_fn(shape)(fresh(), adamw_init(params),
                                             whole)
    out["step_loss"] = _rel(m_dp["loss"], m_one["loss"])
    out["grad_norm"] = _rel(m_dp["grad_norm"], m_one["grad_norm"])
    out["params"] = max(_rel(g, w) for g, w in zip(tree_leaves(p_dp),
                                                   tree_leaves(p_one)))
    # ZeRO-1: this rank's moments are its slice of the one-device moments
    zspecs = dp.opt_shardings().m
    out["moments"] = max(
        _max_rel(o_dp.m, tree_blocks(o_one.m, zspecs, mesh)),
        _max_rel(o_dp.v, tree_blocks(o_one.v, zspecs, mesh)))
    out["moment_share"] = sum(t.numel() for t in tree_leaves(o_dp.m)) / \
        sum(t.numel() for t in tree_leaves(o_one.m))
    across = torch.zeros(())
    for t in tree_leaves(p_dp):
        ref = t.clone()
        tdist.broadcast(ref, 0)
        across = torch.maximum(across, (t - ref).abs().max())
    tdist.all_reduce(across, op=tdist.ReduceOp.MAX)
    out["across_ranks"] = float(across)
    return out


def train_step_dp(rank, p):
    """The cases of DP_CASES over (data p, model 1) and, when p is even,
    (pod 2, data p/2, model 1)."""
    from torch.distributed.device_mesh import init_device_mesh
    meshes = {"data": init_device_mesh("cpu", (p, 1),
                                       mesh_dim_names=("data", "model"))}
    if p % 2 == 0:
        meshes["pod_data"] = init_device_mesh(
            "cpu", (2, p // 2, 1), mesh_dim_names=("pod", "data", "model"))
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.sharding import TrainStep
    from repro_torch.models.config import TRAIN_4K
    out = {f"{name}/{arch}/micro{micro}_by_rank": _dp_case(mesh, arch,
                                                           micro)
           for name, mesh in meshes.items() for arch, micro in DP_CASES}
    for name, mesh in meshes.items():
        out[f"{name}/auto_microbatch"] = {
            arch: TrainStep(get_config(arch), mesh).auto_microbatch(TRAIN_4K)
            for arch in ARCH_IDS}
    return out


# ---------------------------------------------------------------------------
# tensor parallelism and ZeRO-1 (launch/sharding.py on a model axis)
# ---------------------------------------------------------------------------

#: the layouts of the tensor-parallel cases on 4 ranks: (data, model)
TP_LAYOUTS = {"d2m2": (2, 2), "d1m4": (1, 4)}
#: the train cases: every smoke config, and phi3.5-moe scaled to 16
#: experts (expert-parallel; its smoke config's 4 experts shard the ff)
TP_TRAIN = ("llama3_2_3b", "stablelm_12b", "h2o_danube3_4b", "olmo_1b",
            "phi3_5_moe", "phi3_5_moe_e16", "mixtral_8x7b", "hubert_xlarge",
            "falcon_mamba_7b", "zamba2_2_7b", "internvl2_2b")
#: one architecture of each family for decode and prefill (hubert has no
#: decode step)
TP_SERVE = ("h2o_danube3_4b", "h2o_danube3_4b_hd6", "mixtral_8x7b",
            "phi3_5_moe_e16",
            "falcon_mamba_7b", "zamba2_2_7b", "internvl2_2b")
#: one architecture of each family, whose ranks' loss, gradient blocks,
#: prefill and decode logits the tests also hold against the reference's
#: one-device functions (saved under TP_DUMP)
TP_REF = ("h2o_danube3_4b", "mixtral_8x7b", "falcon_mamba_7b",
          "zamba2_2_7b", "internvl2_2b")
TP_SEQ, TP_BATCH, TP_DECODE = 64, 4, 8
#: a first step at the peak learning rate (no warmup), so that the
#: parameters move
TP_STEP_KW = dict(peak_lr=1e-2, warmup=0, total_steps=10)


def drop_one_sum(tp, i):
    """Make the i-th later call of ``tp.sum`` (from 0) return the rank's
    partial untouched: the must-fail control.  Every rank drops the same
    call, since the layers make the same collectives in the same
    order."""
    real, calls = tp.sum, iter(range(1 << 30))
    tp.sum = lambda x: x if next(calls) == i else real(x)


def _dump(name, tensors):
    """Save this rank's tensors for the comparison with the reference in
    the test process (``TP_DUMP``: a directory; unset, nothing is
    saved)."""
    import torch
    import torch.distributed as tdist
    root = os.environ.get("TP_DUMP")
    if root:
        torch.save(tensors, pathlib.Path(root) /
                   f"{name}.r{tdist.get_rank()}.pt")


def tp_config(arch):
    from repro_torch.configs import get_smoke_config
    if arch == "phi3_5_moe_e16":
        return get_smoke_config("phi3_5_moe").scaled(n_experts=16)
    if arch == "h2o_danube3_4b_hd6":
        # 2 kv heads of 6 dims: on model 4 the cache's model axis divides
        # neither, and the spec fix-up puts it on the sequence
        return get_smoke_config("h2o_danube3_4b").scaled(head_dim=6)
    return get_smoke_config(arch)


def _tp_mesh(layout):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", TP_LAYOUTS[layout],
                            mesh_dim_names=("data", "model"))


def _layout_name(mesh):
    """``d<data>m<model>``, the key of TP_LAYOUTS."""
    return "d{}m{}".format(*mesh.mesh.shape)


def _coords_of(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _rows(mesh, n):
    """This rank's rows of a batch of n over the mesh's data axis."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    per = n // mesh.mesh.shape[0]
    return slice(coord["data"] * per, (coord["data"] + 1) * per)


def _blocks(tree, specs, mesh):
    """This rank's blocks of a tree of whole leaves, as fresh tensors."""
    from repro_torch.launch.sharding import tree_blocks
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda t: t.clone(), tree_blocks(tree, specs, mesh))


def _max_rel(got, want) -> float:
    from repro_torch.optim.adamw import tree_leaves
    return max(_rel(g.float(), w.float()) for g, w in
               zip(tree_leaves(got), tree_leaves(want)))


def _tp_train_case(mesh, arch):
    """One ZeRO-1 step on ``mesh`` against the one-device step on the
    whole batch: loss, metrics, gradient blocks, the gradient norm, the
    parameter blocks and the moment slices after the step; the
    parameters' largest difference across the data ranks; the step's
    counted bytes and those of the same step without ZeRO-1; a run that
    skips one all-reduce of the layers (the control)."""
    import torch

    from repro_torch.core import distributed as cdist
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.sharding import (TrainStep, axes_group,
                                             tree_blocks)
    from repro_torch.launch.train import batch_to, train_batch
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = tp_config(arch)
    b, seq = TP_BATCH, TP_SEQ
    shape = ShapeSpec("tp", "train", seq, b)
    whole = batch_to(cfg, train_batch(
        cfg, SyntheticLM(cfg.vocab, seq, b, seed=3), 0, b, seq), "cpu")
    mine = {k: v[_rows(mesh, b)] for k, v in whole.items()}
    full = M.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    tp = TrainStep(cfg, mesh, zero1=True, **TP_STEP_KW)
    one = TrainStep(cfg, **TP_STEP_KW)
    specs = tp.param_shardings()
    loss, metrics, grads = tp.grads_fn(shape)(_blocks(full, specs, mesh),
                                              mine)
    loss1, metrics1, grads1 = one.grads_fn(shape)(full, whole)
    out = {"loss": _rel(loss, loss1),
           "metrics": max(_rel(metrics[k], metrics1[k]) for k in metrics1),
           "grads": _max_rel(grads, tree_blocks(grads1, specs, mesh)),
           "gathered": sorted(tp.tp.stats.gathered)}
    if arch in TP_REF:
        _dump(f"train_{_layout_name(mesh)}_{arch}", {
            "coords": _coords_of(mesh), "batch": whole, "loss": loss,
            "grads": grads})
    # the control: the layers' second all-reduce skipped
    ctl = TrainStep(cfg, mesh, zero1=True, **TP_STEP_KW)
    ctl._build()
    drop_one_sum(ctl.tp, 1)
    c_loss, _, c_grads = ctl.grads_fn(shape)(_blocks(full, specs, mesh), mine)
    out["control"] = max(_rel(c_loss, loss1), _max_rel(
        c_grads, tree_blocks(grads1, specs, mesh)))
    # one step
    params = _blocks(full, specs, mesh)
    p1, o1, m1 = one.step_fn(shape)(
        M.init_params(cfg, torch.Generator().manual_seed(5), device="cpu"),
        adamw_init(full), whole)
    opt = tp.adamw_init(params)
    tp.comm_bytes = 0
    params, opt, m = tp.step_fn(shape)(params, opt, mine)
    step_bytes = tp.comm_bytes
    # the same step without ZeRO-1: an all-reduce of the gradients
    plain = TrainStep(cfg, mesh, zero1=False, **TP_STEP_KW)
    blocks = _blocks(full, specs, mesh)
    plain.step_fn(shape)(blocks, plain.adamw_init(blocks), mine)
    zspecs = tp.opt_shardings().m
    # the one-device AdamW on this rank's blocks, given its gradients
    mine_p = _blocks(full, specs, mesh)
    scale = torch.clamp(tp.clip_norm / (m["grad_norm"] + 1e-9), max=1.0)
    upd, _ = adamw_update(mine_p, tree_map(lambda g: g.float() * scale,
                                           grads), adamw_init(mine_p),
                          lr=m["lr"])
    flat = [torch.cat([t.reshape(-1) for t in tree_leaves(x)])
            for x in (params, tree_blocks(p1, specs, mesh))]
    out.update(step_loss=_rel(m["loss"], m1["loss"]),
               grad_norm=_rel(m["grad_norm"], m1["grad_norm"]),
               params=_rel(*flat), params_update=_max_rel(params, upd),
               moments=max(_max_rel(opt.m, tree_blocks(o1.m, zspecs, mesh)),
                           _max_rel(opt.v, tree_blocks(o1.v, zspecs, mesh))),
               moment_elems=sum(t.numel() for t in tree_leaves(opt.m)),
               param_elems=sum(t.numel() for t in tree_leaves(params)),
               comm_bytes=step_bytes, plain_comm_bytes=plain.comm_bytes)
    across = torch.zeros(())
    if mesh.mesh.shape[0] > 1:
        group = axes_group(mesh, ("data",))
        for t in tree_leaves(params):
            ref = cdist.broadcast(group, t)
            across = torch.maximum(across, (t - ref).abs().max())
    out["across_data_ranks"] = float(across)
    return out


def _tp_serve_case(mesh, arch, batch):
    """``ServeStep`` teacher-forced over TP_DECODE tokens and
    ``make_prefill_fn`` against the one-device decode and forward; each
    step's logits and the cache blocks, and a prefill that skips one
    all-reduce (the control)."""
    import torch

    from repro_torch.launch.sharding import (ServeStep, make_prefill_fn,
                                             param_shardings, tree_blocks)
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec

    cfg = tp_config(arch)
    full = M.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    params = _blocks(full, param_shardings(cfg, mesh), mesh)
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, TP_DECODE)))
    rows = _rows(mesh, batch) if batch > 1 else slice(0, 1)
    ss = ServeStep(cfg, mesh, ShapeSpec("d", "decode", TP_DECODE, batch))
    cache, step = ss.init_cache("cpu"), ss.step_fn()
    cache1 = M.init_cache(cfg, batch, TP_DECODE, "cpu")
    worst, steps = 0.0, []
    for pos in range(TP_DECODE):
        got, cache = step(params, toks[rows, pos], cache, pos)
        want, cache1 = M.decode_step(cfg, full, toks[:, pos], cache1, pos)
        worst = max(worst, _rel(got, want[rows]))
        steps.append(got)
    out = {"decode": worst,
           "cache": _max_rel(cache, tree_blocks(cache1, ss.cache_shardings(),
                                                mesh)),
           "decode_gathered": sorted(ss.tp.stats.gathered)}
    if batch == 1:
        return out
    b = TP_BATCH
    ids = torch.from_numpy(rng.integers(0, cfg.vocab, (b, TP_SEQ)))
    whole = {"tokens": ids}
    if cfg.frontend == "patches":
        whole = {"tokens": ids[:, cfg.n_patches:], "patches": torch.from_numpy(
            rng.standard_normal((b, cfg.n_patches, cfg.d_model))).float()}
    mine = {k: v[_rows(mesh, b)] for k, v in whole.items()}
    want = M.forward(cfg, full, whole, remat=False)[0][_rows(mesh, b)]
    prefill = make_prefill_fn(cfg, mesh)
    logits = prefill(params, mine)
    prefill_bytes = prefill.tp.stats.bytes
    out["prefill"] = _rel(logits, want)
    out["prefill_gathered"] = sorted(prefill.tp.stats.gathered)
    if arch in TP_REF:
        _dump(f"serve_{_layout_name(mesh)}_{arch}", {
            "rows": (_rows(mesh, b).start, _rows(mesh, b).stop),
            "tokens": toks, "decode": torch.stack(steps), "batch": whole,
            "prefill": logits})
    drop_one_sum(prefill.tp, 1)
    out["prefill_control"] = _rel(prefill(params, mine), want)
    if cfg.n_experts:
        from repro_torch.models import layers as L
        L.set_moe_reshard_axis("model")
        try:
            hinted = make_prefill_fn(cfg, mesh)
            out["prefill_reshard"] = _rel(hinted(params, mine), want)
            out["reshard_bytes"] = [hinted.tp.stats.bytes, prefill_bytes]
        finally:
            L.set_moe_reshard_axis(None)
    return out


def tensor_parallel(rank, p):
    """Every train case on both layouts; the serve cases on both, the
    sequence-sharded decode (batch 1) on (data 2, model 2); reshard_tree
    from (data 2, model 2) blocks onto (data 1, model 4);
    make_production_mesh on a world of 4."""
    import torch

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import param_shardings, tree_blocks
    from repro_torch.models import model as M
    from repro_torch.runtime import reshard_tree
    meshes = {name: _tp_mesh(name) for name in TP_LAYOUTS}
    out = {}
    for name, mesh in meshes.items():
        for arch in TP_TRAIN:
            out[f"train/{name}/{arch}_by_rank"] = _tp_train_case(mesh, arch)
        for arch in TP_SERVE:
            out[f"serve/{name}/{arch}_by_rank"] = _tp_serve_case(
                mesh, arch, TP_BATCH)
    for arch in TP_SERVE:
        out[f"serve_b1/d2m2/{arch}_by_rank"] = _tp_serve_case(
            meshes["d2m2"], arch, 1)
    cfg = tp_config("zamba2_2_7b")
    full = M.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    old = _blocks(full, param_shardings(cfg, meshes["d2m2"]), meshes["d2m2"])
    new = reshard_tree(old, cfg, meshes["d1m4"], mesh=meshes["d2m2"])
    want = tree_blocks(full, param_shardings(cfg, meshes["d1m4"]),
                       meshes["d1m4"])
    out["reshard_by_rank"] = _max_rel(new, want)
    try:
        make_production_mesh()
        out["production_mesh"] = "built"
    except ValueError as e:
        out["production_mesh"] = str(e)
    return out


#: one smoke config of each family, whose train step, prefill and decode
#: on (data 2, model 2) tests/test_torch_dryrun.py counts on meta; the
#: cells' (seq, global batch)
DRYRUN_ARCHS = ("h2o_danube3_4b", "mixtral_8x7b", "falcon_mamba_7b",
                "zamba2_2_7b", "hubert_xlarge", "internvl2_2b")
DRYRUN_SEQ, DRYRUN_BATCH = 64, 8


def dryrun_shapes(cfg):
    from repro_torch.models.config import ShapeSpec
    kinds = ("train", "prefill") + (() if cfg.is_encoder_only
                                    else ("decode",))
    return [ShapeSpec(k, k, DRYRUN_SEQ, DRYRUN_BATCH) for k in kinds]


def _batch_rows(cfg, shape, mesh, rng):
    """This rank's rows of a random batch of ``input_specs``' fields."""
    import torch

    from repro_torch.models.config import input_specs
    out = {}
    for k, spec in input_specs(cfg, shape).items():
        if spec.dtype == torch.int32:
            whole = torch.from_numpy(rng.integers(0, cfg.vocab, spec.shape)
                                     .astype(np.int32))
        else:
            whole = torch.from_numpy(rng.standard_normal(spec.shape)).to(
                spec.dtype)
        out[k] = whole[_rows(mesh, shape.global_batch)].clone()
    return out


def dryrun_comm(rank, p):
    """Each DRYRUN_ARCHS smoke config's train step (ZeRO-1), prefill and
    decode (at the last position) on this rank's real blocks on (data 2,
    model 2): what its CommStats counted, in all and by kind, and the bytes
    of its inputs, for the dry run's count of the same rank to equal."""
    import torch

    from repro_torch.launch.sharding import (ServeStep, TrainStep,
                                             make_prefill_fn,
                                             param_shardings)
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves

    mesh = _tp_mesh("d2m2")
    rng = np.random.default_rng(3)
    out = {}
    for arch in DRYRUN_ARCHS:
        cfg = tp_config(arch)
        full = M.init_params(cfg, torch.Generator().manual_seed(5),
                             device="cpu")
        for shape in dryrun_shapes(cfg):
            params = _blocks(full, param_shardings(cfg, mesh), mesh)
            if shape.kind == "train":
                ts = TrainStep(cfg, mesh)
                args = (params, ts.adamw_init(params),
                        _batch_rows(cfg, shape, mesh, rng))
                ts.step_fn(shape)(*args)
                stats = ts.stats
            elif shape.kind == "prefill":
                args = (params, _batch_rows(cfg, shape, mesh, rng))
                fn = make_prefill_fn(cfg, mesh)
                fn(*args)
                stats = fn.tp.stats
            else:
                ss = ServeStep(cfg, mesh, shape)
                token = torch.from_numpy(rng.integers(
                    0, cfg.vocab, shape.global_batch))[
                    _rows(mesh, shape.global_batch)].int()
                pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
                args = (params, token, ss.init_cache("cpu"), pos)
                ss.step_fn()(*args)
                stats = ss.tp.stats
            leaves = [t for a in args for t in
                      (tree_leaves(a) if isinstance(a, dict) else
                       tree_leaves(a.m) + tree_leaves(a.v) + [a.step]
                       if hasattr(a, "m") else [a])]
            out[f"{arch}/{shape.kind}_by_rank"] = {
                "coords": _coords_of(mesh), "bytes": stats.bytes,
                "per_op": stats.per_op, "counts": stats.counts,
                "arg_bytes": sum(t.numel() * t.element_size()
                                 for t in leaves)}
    return out


def train_step_tp8(rank, p):
    """The reference's TestTrainStepOn8Devices on 8 ranks: llama3.2-3b's
    smoke config on (data 4, model 2), ``TrainStep(cfg, mesh,
    zero1=True)`` with its defaults, 4 steps of the same seeded batch;
    the losses, and the one-device port's (rank 0 runs it)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.sharding import TrainStep, param_shardings
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw_init

    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    cfg = tp_config("llama3_2_3b")
    shape = ShapeSpec("t", "train", 64, 8)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 64)))
             for k in ("tokens", "targets")}

    def losses(step, params, opt, batch):
        out = []
        for _ in range(4):
            params, opt, m = step(params, opt, batch)
            out.append(float(m["loss"]))
        return out

    def fresh():
        return M.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")

    ts = TrainStep(cfg, mesh, zero1=True)
    params = _blocks(fresh(), param_shardings(cfg, mesh), mesh)
    out = {"losses_by_rank": losses(
        ts.step_fn(shape), params, ts.adamw_init(params),
        {k: v[_rows(mesh, 8)] for k, v in batch.items()})}
    if rank == 0:
        one = TrainStep(cfg)
        out["one_device"] = losses(one.step_fn(shape), fresh(),
                                   adamw_init(fresh()), batch)
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _rank_run(rank, p, names):
    """Every named scenario on this rank, in order."""
    return {name: globals()[name](rank, p) for name in names}


def run_ranks(p, names, timeout=240.0):
    from repro_torch.launch.mesh import launch_ranks
    res = launch_ranks(_rank_run, p, args=(names,), timeout=timeout)
    out = res[0]
    for name in names:
        for key in list(out[name]):
            if key.endswith("_by_rank"):
                out[name][key] = [r[name][key] for r in res]
    return out


def run_reference(name):
    """A program's reference run: the reference's MeshEngine over the
    forced host devices of this process."""
    import jax

    import repro
    from repro.launch.mesh_exec import MeshEngine
    p = len(jax.devices())
    if name == "mesh_engine_equivalence":
        out = equivalence_program(repro.Session, MeshEngine())
    else:
        out = bench_program(repro.Session, MeshEngine(n_dev=p), p)
    out["stats"] = _plain(out["stats"])
    return out


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1] == "ref":
        result = run_reference(sys.argv[2])
    else:
        result = run_ranks(int(sys.argv[1]), sys.argv[2:])
    print("RESULT " + json.dumps(result))
    print("OK")
