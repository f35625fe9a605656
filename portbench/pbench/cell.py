"""One run of one cell: set-up, the measured window, the check.

Every rank runs :func:`rank_main`: a one-chip cell in the process itself,
a cell of several ranks in processes of its own, one per chip, on a
``torch.distributed`` group.  Every rank runs the same host program, as
the program's mesh engine requires: the mix's driver builds the inputs
and warms one product, and the harness has it issue products back to
back (a closed loop of one caller), flushing each, until rank 0 has seen
``seconds`` pass.  A product ends when ``Session.flush()`` has returned
on every rank, with C's leaves filled on the host.

Set-up builds the configuration's inputs from the seed through
``Session.from_pattern`` (:meth:`Context.build`, each build timed:
``build_s``), and warms one product, which loads (the first run in a
checkout: compiles) the kernel.
After the window the harness reads the peak of device memory, and then
rank 0 judges a sample of the window's products, drawn from the seed,
against the plain reference (:mod:`pbench.reference`).
"""
from __future__ import annotations

import contextlib
import importlib
import os
import resource
import time
import traceback

import numpy as np

from pbench import bench, guard, reference, spans as sp
from pbench.devtrace import Window
from pbench.work import product_work

#: the program's kernel library behind each ``kernel`` of its engines
KERNEL_LIB = {"pairs": "bsmm_pairs", "gemm": "batched_gemm"}
#: seconds the ranks of a cell may take, set-up and check included
RANK_TIMEOUT = 340.0


class Context:
    """What a mix's driver works with: ``sess`` (the Session), ``op`` (the
    operator module), ``mix`` (the mix's parameters), ``seed``, ``rec``
    (the host span recorder) and :meth:`build`."""

    def __init__(self, sess, op, mix, seed, rec, pattern, builds):
        self.sess, self.op, self.mix, self.seed, self.rec = \
            sess, op, mix, seed, rec
        self.pattern, self.builds = pattern, builds

    def build(self, k: int, name: str | None = None):
        """Value set ``k`` of the configuration's pattern, built through
        ``Session.from_pattern`` (timed: ``build_s``); ``name`` is the
        operand name a plan binds."""
        pat = self.pattern
        t0 = time.perf_counter()
        m = self.sess.from_pattern(pat.rows, pat.cols, pat.n,
                                   value_fn=pat.values(self.seed, k),
                                   upper=pat.upper, name=name)
        self.builds.append(time.perf_counter() - t0)
        return m


def stored_blocks(m) -> dict:
    """Every stored block of a result C, keyed by its global (I, J)."""
    g, bs = m.session.graph, m.params.bs
    if m._t:
        raise ValueError("readback of a transposed handle")
    out = {}
    stack = [(m.node, 0, 0)]
    while stack:
        nid, r0, c0 = stack.pop()
        ch = None if nid is None else g.value_of(nid)
        if ch is None:
            continue
        if ch.is_leaf:
            for (i, j), blk in ch.leaf.blocks.items():
                out[(r0 // bs + i, c0 // bs + j)] = blk
            continue
        h = ch.n // 2
        for q, (dr, dc) in enumerate(((0, 0), (0, h), (h, 0), (h, h))):
            stack.append((ch.children[q], r0 + dr, c0 + dc))
    return out


def _rss() -> int:
    """Resident bytes of this process (Linux)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def rank_main(rank: int, world: int, spec: dict) -> dict:
    """One rank of a run; returns what the result line is made from."""
    import torch
    if spec.get("plant"):
        mod, fn = spec["plant"].split(":")
        getattr(importlib.import_module(mod), fn)()
    cuda = spec["device"] == "cuda"
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    group = None
    if world > 1:
        import torch.distributed as dist
        dist.init_process_group(spec["backend"], init_method=spec["init"],
                                rank=rank, world_size=world)
        group = dist.group.WORLD
    try:
        return _rank_body(rank, world, spec, torch, device, group)
    finally:
        if world > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


def _rank_body(rank, world, spec, torch, device, group) -> dict:
    from repro_torch import Session
    from repro_torch.core.engine import TorchEngine
    from repro_torch.obs.tracer import Tracer

    cfg, mix, seed = spec["cfg"], spec["mix"], spec["seed"]
    cuda = device.type == "cuda"
    pattern = bench.load_pattern(bench.HERE, cfg).make(cfg)
    op = bench.load_operator(bench.HERE, cfg)
    driver = bench.load_driver(bench.HERE, mix)
    if cfg["engine"] == "mesh":
        from repro_torch.launch.mesh_exec import MeshEngine
        engine = MeshEngine(kernel=cfg["kernel"], device=device, group=group)
    else:
        engine = TorchEngine(kernel=cfg["kernel"], device=device)
    tracer = Tracer() if spec["trace"] else False
    sess = Session(engine=engine, leaf_n=int(cfg["leaf_n"]),
                   bs=int(cfg["bs"]), lazy=driver.LAZY, trace=tracer)
    rec = sp.Recorder(time.perf_counter)
    builds: list = []
    traffic = driver.start(Context(sess, op, mix, seed, rec, pattern,
                                   builds))
    # warm one product (loads the kernel; the first run in a checkout
    # compiles it)
    traffic.warm()
    setup_builds = list(builds)
    rec.spans.clear()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    stop_flag = torch.zeros(1, device=device if group is not None
                            and spec["backend"] == "nccl" else "cpu")
    mid = 1 + seed % 3                      # the sampled product, with 0
    kept: dict = {}
    times: list = []
    stats0 = engine.stats() if cfg["engine"] == "mesh" else None
    window = Window(torch) if spec["trace"] and cuda else \
        contextlib.nullcontext()
    counters0 = dict(getattr(tracer, "counters", None) or {})
    rss0 = _rss()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    gc_log = _GcLog()
    setup_end = time.time()
    with window:
        t_first = time.perf_counter()
        n, stop = 0, False
        while not stop:
            t0 = time.perf_counter()
            out, sets = traffic.issue(n)
            with rec.span("flush"):
                sess.flush()
            stop = rank == 0 and time.perf_counter() - t_first >= \
                spec["seconds"]
            if group is not None:
                stop_flag.fill_(float(stop))
                torch.distributed.all_reduce(
                    stop_flag, op=torch.distributed.ReduceOp.MAX,
                    group=group)
                stop = bool(stop_flag.item())
            t1 = time.perf_counter()
            times.append(t1 - t0)
            if driver.REUSES_OUTPUT:
                kept = {n: (out, sets)}
            elif stop or n in (0, mid):
                kept[n] = (out, sets)
            else:
                with rec.span("free"):
                    traffic.release(out)
            n += 1
        t_last = t1
    gc_log.close()
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    rss1 = _rss()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    res = {
        "rank": rank, "products": n, "window_s": t_last - t_first,
        "setup_end": setup_end,
        "build_s": sum(setup_builds) / len(setup_builds),
        "builds": setup_builds, "memory_peak": peak, "times": times,
        "rss_growth": rss1 - rss0, "gc": gc_log.summary(),
        "cpu_s": {k: getattr(ru1, k) - getattr(ru0, k)
                  for k in ("ru_utime", "ru_stime")},
        "device_name": torch.cuda.get_device_name(device) if cuda else "cpu",
        "forbidden": guard.forbidden_loaded(),
    }
    if stats0 is not None:
        st = engine.stats()
        res["counters"] = {k: (np.asarray(st[k]) - np.asarray(stats0[k]))
                           .tolist() for k in ("fetched_bytes",
                                               "collective_bytes",
                                               "pushed_bytes")}
    if spec["trace"]:
        own = list(rec.spans)
        own += [(s.name, s.t0 + tracer.epoch, s.t1 + tracer.epoch)
                for s in tracer.spans if s.name == sp.DISPATCH]
        res["spans"] = own
        res["trace"] = getattr(window, "trace", None)
        res["program"] = program_records(tracer, sess, counters0,
                                         (t_first, t_last))
    if group is not None:
        torch.distributed.barrier()
    if rank == 0:
        t0 = time.perf_counter()
        res.update(check(cfg, op, pattern, seed, kept, device))
        res["check_s"] = time.perf_counter() - t0
    if group is not None:
        torch.distributed.barrier()
    return res


def program_records(tracer, sess, counters0, window) -> dict:
    """What the program recorded, for the per-layer metrics
    (:func:`pbench.spans.program_self`, :func:`~pbench.spans.
    program_counter`): every span of its tracer that carries an ``id``
    (set-up's too) as ``(name, t0, t1, id, parent, attrs)`` on the
    harness's clock, its counters' change over the window, the bytes its
    graph holds when the window has closed, and the window.  Read by
    ``getattr``: what the program does not keep is None."""
    epoch = getattr(tracer, "epoch", None)
    spans = None
    if epoch is not None:
        spans = [(s.name, s.t0 + epoch, s.t1 + epoch, s.id,
                  getattr(s, "parent", None), dict(getattr(s, "attrs", {})))
                 for s in getattr(tracer, "spans", ())
                 if getattr(s, "id", None) is not None]
    counters = getattr(tracer, "counters", None)
    if counters is not None:
        counters = {k: v - counters0.get(k, 0) for k, v in counters.items()}
    return {"spans": spans, "counters": counters,
            "held_bytes": getattr(getattr(sess, "graph", None),
                                  "held_bytes", None),
            "window": window}


class _GcLog:
    """Seconds the interpreter's cyclic collector ran while open, by
    generation (a diagnostic: the graph the program keeps grows)."""

    def __init__(self):
        import gc
        self.gc, self.t0, self.by_gen = gc, 0.0, {0: [0, 0.0], 1: [0, 0.0],
                                                  2: [0, 0.0]}
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        else:
            g = self.by_gen[info["generation"]]
            g[0] += 1
            g[1] += time.perf_counter() - self.t0

    def close(self):
        self.gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        return {f"gen{g}": v for g, v in self.by_gen.items()}


def check(cfg, op, pattern, seed, kept, device) -> dict:
    """Judge the kept products, each ``(result, value sets)``, by the
    reference; the numbers compared and the work of one product, counted
    from the inputs."""
    bs, n = int(cfg["bs"]), pattern.n
    blocks: dict = {}

    def blocks_of(k):
        if k not in blocks:
            vals = pattern.values(seed, k)(pattern.rows, pattern.cols)
            blocks[k] = reference.block_matrix(pattern.rows, pattern.cols,
                                               vals, n, bs)
        return blocks[k]

    refs: dict = {}
    worst = {"c_blocks_wrong": 0, "max_rel_err": 0.0}
    failed = 0
    limits = cfg["limits"]
    for i, (m, sets) in sorted(kept.items(), key=lambda kv: kv[0]):
        key = tuple(sorted(sets.items()))
        if key not in refs:
            refs[key] = reference_of(cfg, op, pattern.upper, device,
                                     {s: blocks_of(k)
                                      for s, k in sets.items()})
        got = reference.compare(stored_blocks(m), refs[key][0])
        failed += any(got[k] > limits[k] for k in got)
        for k in worst:
            worst[k] = max(worst[k], got[k])
    ref, a, b = next(iter(refs.values()))
    work = product_work(a.keys, b.keys, ref.ia, ref.ib, len(ref.keys), bs,
                        symmetric=pattern.upper)
    return {"checks": {k: {"value": v, "limit": limits[k]}
                       for k, v in worst.items()},
            "checked": sorted(kept), "failed": failed, "work": work}


def reference_of(cfg, op, upper, device, blocks, precision="float64"):
    """The operator's reference product of the operands' ``blocks``, and
    its two factors: every structural pair, or those that the operator's
    ``reference_pairs`` keeps, where it has one."""
    a, b = op.reference_operands(blocks)
    keep = None
    if hasattr(op, "reference_pairs"):
        def keep(ia, ib):
            return op.reference_pairs(blocks, cfg, ia, ib)
    return (reference.reference_product(a, b, upper, device=device,
                                        precision=precision, keep=keep),
            a, b)


def spawn_ranks(world: int, spec: dict) -> list:
    """Run :func:`rank_main` on ``world`` ranks, one process each, on a
    group whose store is a file in ``TMPDIR``; every process is stopped
    and waited for before this returns."""
    import multiprocessing as mp
    import queue
    import shutil
    import tempfile

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
    spec = dict(spec, init=f"file://{tmp}/store")
    procs = [ctx.Process(target=_rank_entry, args=(r, world, spec, results),
                         name=f"rank{r}") for r in range(world)]
    out: dict = {}
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, res = results.get(timeout=0.5)
            except queue.Empty:
                bad = [p for p in procs if p.exitcode not in (None, 0)]
                if bad:
                    raise RuntimeError(f"{bad[0].name} exited with code "
                                       f"{bad[0].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish within "
                                       f"{RANK_TIMEOUT} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            out[rank] = res
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        results.close()
        results.join_thread()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]


def _rank_entry(rank: int, world: int, spec: dict, results) -> None:
    try:
        results.put((rank, True, rank_main(rank, world, spec)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
