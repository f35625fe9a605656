#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path, the paper's locality-aware quadtree multiply,
through the entry points a user calls, on the card:

1. build   — compile every CUDA kernel of the path from ``repro_torch/csrc``
             with nvcc for sm_90a (one nvcc per source, in parallel) into
             ``build/kernels/``; print the build time and ptxas report.
2. kernels — hold each kernel's wrapper against its plain PyTorch version
             on the card: bs 4..64, float32 and bfloat16, odd P, P = 0,
             dropped pairs, unvisited slots, one case with >= 1e5 pairs.
             Tolerance: float32 atol 1e-4; bfloat16 atol 2e-2 of the
             largest |value| compared (a few bf16 ulps), at most 5e-2*bs.
3. main    — ``repro_torch.Session(engine="torch")`` at the paper's scale:
             banded ``A @ B`` (n = 65536), S2 overlap ``S.sym_square()``
             (32768 particles), random ``A.T @ B``, and banded again under
             ``TorchEngine(kernel="gemm")``.  Launch counters are zeroed
             just before each run and read just after; the stored C block
             keys must equal the boolean product of the block masks, and
             256 sampled C blocks must match float64 sums built from the
             same input data (rtol 1e-5 in the Frobenius norm).
4. report  — per phase the engine's wave stats and launch counts; per
             kernel its time on the card at the main path's largest wave
             (CUDA events), its bound, the plain version's time and the
             ``torch.bmm`` yardstick's; the card's name and power limit.
             Each kernel is also held against its plain version on that
             same wave, at the tolerance of phase 2.

Any failed check raises and the script exits non-zero.  Without a CUDA
device, or without the package beside it, it prints no result and exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FMA outside
#: the tensor cores in FLOP/s
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12

#: the TPU kernel each CUDA kernel replaces (pl.pallas_call sites)
REPLACES = {"bsmm_pairs": "src/repro/kernels/bsmm_pairs.py:78",
            "batched_gemm": "src/repro/kernels/batched_gemm.py:52"}

LEAF_N, BS = 2048, 32
N_SAMPLE = 256
#: main-path sizes: banded (n, half-bandwidth), S2 particles per axis (3-D),
#: random n (density 1e-4)
SIZES = {"banded": (65536, 128), "s2": 32, "random": 4096}


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    tb, tf = n_bytes / HBM_BPS, flops / FP32_FLOPS
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def max_err(torch, got, want) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/type {tuple(got.shape)} {got.dtype} "
                             f"!= {tuple(want.shape)} {want.dtype}")
    if got.numel() == 0:
        return 0.0
    return float((got.float() - want.float()).abs().max())


def tolerance(torch, want, bs: int) -> float:
    """float32: atol 1e-4.  bfloat16: 2e-2 of the largest |value| of the
    plain version (a bf16 ulp is at most 2**-7 of a value, so two
    roundings apart stay well inside), never looser than 5e-2*bs."""
    if want.dtype == torch.float32:
        return 1e-4
    top = float(want.float().abs().max()) if want.numel() else 0.0
    return min(2e-2 * top, 5e-2 * bs)


def check_close(torch, what, got, want, bs: int) -> float:
    """Max abs error of ``got`` against ``want``; raises past tolerance."""
    err, tol = max_err(torch, got, want), tolerance(torch, want, bs)
    if not err <= tol:
        raise AssertionError(f"{what}: max abs err {err} > {tol}")
    return err


def pairs_case(torch, rng, cap_a, cap_b, cap_c, n_pairs, bs, dtype,
               unvisited=0, invalid=0):
    """Random packed operands with ascending seg; the last ``unvisited``
    C slots get no pair and the last ``invalid`` pairs carry seg = cap_c
    and out-of-range slot ids (the wrapper clamps them)."""
    dev = "cuda"
    # entries of std bs**-0.25: each product entry has unit variance
    scale = bs ** -0.25
    a = torch.tensor(rng.standard_normal((cap_a, bs, bs)) * scale,
                     dtype=dtype, device=dev)
    b = torch.tensor(rng.standard_normal((cap_b, bs, bs)) * scale,
                     dtype=dtype, device=dev)
    sa = rng.integers(0, cap_a, n_pairs).astype(np.int32)
    sb = rng.integers(0, cap_b, n_pairs).astype(np.int32)
    seg = np.sort(rng.integers(0, max(cap_c - unvisited, 1), n_pairs)
                  ).astype(np.int32)
    if invalid:
        seg[-invalid:] = cap_c
        sa[-invalid:] = cap_a + 7
        sb[-invalid:] = -3
    t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    return a, b, t(sa), t(sb), t(seg)


def check_kernels(torch, ops, ref) -> dict:
    """Every kernel against its plain version; returns worst error each."""
    rng = np.random.default_rng(0)
    worst = {"bsmm_pairs": 0.0, "batched_gemm": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for bs in (4, 8, 16, 32, 64):
            cases = [(37, 41, 197, 1001, 7, 50), (5, 3, 6, 0, 0, 0),
                     (4, 4, 4, 4, 3, 0)]
            if bs == 32 and dtype == torch.float32:
                cases.append((20000, 20000, 30011, 150001, 11, 1000))
            for cap_a, cap_b, cap_c, n_pairs, unv, inv in cases:
                a, b, sa, sb, seg = pairs_case(
                    torch, rng, cap_a, cap_b, cap_c, n_pairs, bs, dtype,
                    unvisited=unv, invalid=inv)
                got = ops.bsmm_pairs(a, b, sa, sb, seg, cap_c=cap_c)
                torch.cuda.synchronize()
                want = ref.bsmm_pairs_ref(
                    a, b, sa.clamp(0, cap_a - 1), sb.clamp(0, cap_b - 1),
                    seg, cap_c)
                err = check_close(torch, f"bsmm_pairs bs={bs} {dtype} "
                                  f"P={n_pairs}", got, want, bs)
                if unv and bool((got[cap_c - unv:] != 0).any()):
                    raise AssertionError(
                        f"bsmm_pairs bs={bs} {dtype}: unvisited slots not 0")
                worst["bsmm_pairs"] = max(worst["bsmm_pairs"],
                                          err if dtype == torch.float32
                                          else 0.0)
                log(f"  bsmm_pairs   bs={bs:2d} {str(dtype):14s} "
                    f"P={n_pairs:6d} cap_c={cap_c:5d} max_abs_err={err:.3g}")
            for p in (1003, 0, 5):
                a = torch.tensor(rng.standard_normal((p, bs, bs)),
                                 dtype=dtype, device="cuda")
                b = torch.tensor(rng.standard_normal((p, bs, bs)),
                                 dtype=dtype, device="cuda")
                got = ops.batched_gemm(a, b)
                torch.cuda.synchronize()
                err = check_close(torch, f"batched_gemm bs={bs} {dtype} "
                                  f"P={p}", got, ref.batched_gemm_ref(a, b),
                                  bs)
                worst["batched_gemm"] = max(worst["batched_gemm"],
                                            err if dtype == torch.float32
                                            else 0.0)
                log(f"  batched_gemm bs={bs:2d} {str(dtype):14s} P={p:6d} "
                    f"max_abs_err={err:.3g}")
    return worst


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def hashed_values(seed: int):
    """Deterministic values in [-0.5, 0.5) per (row, col) (splitmix64)."""
    def value_fn(r, c):
        x = (np.asarray(r, np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             + np.asarray(c, np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
             + np.uint64(seed * 0x94D049BB133111EB % 2 ** 64))
        x ^= x >> np.uint64(31)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(29)
        return (x >> np.uint64(11)).astype(np.float64) / 2.0 ** 53 - 0.5
    return value_fn


def gaussian_overlap(coords, order):
    """S2 overlap values exp(-|x_r - x_c|^2 / 4) (symmetric)."""
    pts = coords[order]

    def value_fn(r, c):
        return np.exp(-((pts[r] - pts[c]) ** 2).sum(-1) / 4.0)
    return value_fn


def stored_blocks(m) -> dict:
    """Every stored leaf block of a result, keyed by global block (I, J)."""
    assert not m._t, "readback of a transposed handle"
    g, bs = m.session.graph, m.params.bs
    m.session.flush()
    out = {}

    def walk(nid, r0, c0):
        if nid is None:
            return
        ch = g.value_of(nid)
        if ch is None:
            return
        if ch.is_leaf:
            for (i, j), blk in ch.leaf.blocks.items():
                out[(r0 // bs + i, c0 // bs + j)] = blk
            return
        h = ch.n // 2
        for q, (dr, dc) in enumerate(((0, 0), (0, h), (h, 0), (h, h))):
            walk(ch.children[q], r0 + dr, c0 + dc)

    walk(m.node, 0, 0)
    return out


def check_result(sp, name, blocks, a64, b64, n, bs, upper, seed) -> dict:
    """Stored keys == boolean product of block masks; sampled blocks ==
    float64 sums of the same input data (rtol 1e-5, Frobenius)."""
    g = n // bs

    def block_mask(m):
        m = m.tocoo()
        return sp.csr_matrix((np.ones(len(m.row)), (m.row // bs, m.col // bs)),
                             shape=(g, g))

    prod = (block_mask(a64) @ block_mask(b64)).tocoo()
    want_keys = {(int(i), int(j)) for i, j, v in zip(prod.row, prod.col,
                                                     prod.data)
                 if v > 0 and (not upper or i <= j)}
    got_keys = set(blocks)
    if got_keys != want_keys:
        raise AssertionError(
            f"{name}: stored C blocks {len(got_keys)} != boolean product "
            f"{len(want_keys)} (missing {len(want_keys - got_keys)}, extra "
            f"{len(got_keys - want_keys)})")
    rng = np.random.default_rng(seed)
    keys = sorted(got_keys)
    pick = rng.choice(len(keys), size=min(N_SAMPLE, len(keys)),
                      replace=False)
    a_csr, b_csc = a64.tocsr(), b64.tocsc()
    num = den = 0.0
    for t in pick:
        i, j = keys[t]
        want = (a_csr[i * bs:(i + 1) * bs] @ b_csc[:, j * bs:(j + 1) * bs]
                ).toarray()
        got = np.asarray(blocks[(i, j)], np.float64)
        num += float(((got - want) ** 2).sum())
        den += float((want ** 2).sum())
    rel = (num / den) ** 0.5 if den else num ** 0.5
    if not rel <= 1e-5:
        raise AssertionError(f"{name}: sampled C blocks rel Frobenius err "
                             f"{rel} > 1e-5")
    return {"stored_c_blocks": len(got_keys), "sampled": len(pick),
            "rel_frob_err": rel}


class Capture:
    """Keep the inputs of the largest call of each kernel wrapper of
    :mod:`repro_torch.kernels.ops` while a main-path run goes through it,
    so that the report times each kernel at the shapes the path gave it."""

    def __init__(self, ops):
        self.ops = ops
        self.calls: dict[str, tuple] = {}
        self._orig = {k: getattr(ops, k) for k in ("bsmm_pairs",
                                                   "batched_gemm")}

    def __enter__(self):
        def wrap(name):
            orig = self._orig[name]

            def fn(*args, **kw):
                size = args[2].shape[0] if name == "bsmm_pairs" \
                    else args[0].shape[0]
                if size >= self.calls.get(name, (-1,))[0]:
                    self.calls[name] = (size, args, kw)
                return orig(*args, **kw)
            return fn
        for name in self._orig:
            setattr(self.ops, name, wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.ops, name, fn)


def time_kernel(torch, ref, name, args, kw) -> dict:
    """Kernel, plain version and ``torch.bmm`` yardstick on one wave's
    inputs (CUDA events), the kernel's error against its plain version
    (raises past the tolerance of :func:`tolerance`), and its bound: the larger of the bytes it must move (each input read
    once, each output written once) over the HBM rate and the FLOPs these
    inputs need over the float32 peak."""
    from repro_torch.kernels import batched_gemm as kbg
    from repro_torch.kernels import bsmm_pairs as kbp

    if name == "bsmm_pairs":
        a, b, sa, sb, seg = args
        cap_c = kw["cap_c"]
        sa, sb = sa.clamp(0, a.shape[0] - 1), sb.clamp(0, b.shape[0] - 1)
        bs, elt = a.shape[1], a.element_size()
        valid = int((seg < cap_c).sum())
        n_bytes = ((a.numel() + b.numel() + cap_c * bs * bs) * elt
                   + 3 * 4 * sa.shape[0])
        flops = 2.0 * bs ** 3 * valid
        kern = lambda: kbp.bsmm_pairs(a, b, sa, sb, seg,  # noqa: E731
                                      cap_c=cap_c)
        plain = lambda: ref.bsmm_pairs_ref(a, b, sa, sb, seg,  # noqa: E731
                                           cap_c)
        # the yardstick multiplies the pre-gathered pairs (no gather, no
        # segment sum): a floor for the batched products alone
        ga, gb = a[sa.long()], b[sb.long()]
        shape = {"pairs": int(sa.shape[0]), "valid_pairs": valid,
                 "a_blocks": int(a.shape[0]), "b_blocks": int(b.shape[0]),
                 "c_blocks": cap_c, "bs": bs, "dtype": str(a.dtype)}
    else:
        ga, gb = args
        p, bs = ga.shape[0], ga.shape[1]
        n_bytes = 3 * ga.numel() * ga.element_size()
        flops = 2.0 * bs ** 3 * p
        kern = lambda: kbg.batched_gemm(ga, gb)  # noqa: E731
        plain = lambda: ref.batched_gemm_ref(ga, gb)  # noqa: E731
        shape = {"products": int(p), "bs": bs, "dtype": str(ga.dtype)}
    err = check_close(torch, f"{name} on the main path's wave {shape}",
                      kern(), plain(), bs)
    bms, by = bound_ms(n_bytes, flops)
    out = {"ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain,
                                                           reps=5),
           "library_ms": cuda_ms(torch, lambda: torch.bmm(ga, gb)),
           "bound_ms": bms, "bound_by": by, "max_abs_err": err,
           "bytes": n_bytes, "flops": flops, "shape": shape}
    del ga, gb
    return out


def run_case(torch, ops, ref, launches, name, build, op, engine_kw,
             oracle):
    """One main-path run: build inputs, zero the counters, multiply, read
    the counters, read back and check, then time each kernel on the wave
    this run gave it."""
    from repro_torch import Session
    from repro_torch.core.engine import TorchEngine
    import scipy.sparse as sp

    t0 = time.perf_counter()
    sess = Session(engine=TorchEngine(**engine_kw),
                   leaf_n=LEAF_N, bs=BS)
    mats = build(sess)
    t_build = time.perf_counter() - t0
    for k in launches:
        launches[k] = 0
    t1 = time.perf_counter()
    with Capture(ops) as cap:
        c = op(*mats)
        stats = sess.engine_stats()     # flushes every wave; ends in a sync
    t_mult = time.perf_counter() - t1
    counts = dict(launches)
    blocks = stored_blocks(c)
    res = check_result(sp, name, blocks, *oracle(), n=c.n, bs=BS,
                       upper=c.upper, seed=7)
    t_total = time.perf_counter() - t0
    summary = {k: stats[k] for k in ("kernel", "waves", "batched_pairs",
                                     "padded_pairs", "c_blocks",
                                     "bytes_packed", "kernel_wall_s")}
    summary["unique_blocks"] = sum(w["unique_blocks"]
                                   for w in stats["wave_log"])
    summary.update(tasks=len(sess.graph.nodes),
                   multiply_tasks=sess.n_multiply_tasks,
                   flops=sess.flops, launches=counts, build_s=t_build,
                   multiply_s=t_mult, total_s=t_total, **res)
    log(f"  {name}: " + json.dumps(summary))
    summary["timing"] = {}
    for kname, (_, args, kw) in sorted(cap.calls.items()):
        tm = summary["timing"][kname] = time_kernel(torch, ref, kname, args,
                                                    kw)
        log(f"    {kname}: ms={tm['ms']:.4f} plain_ms={tm['plain_ms']:.4f} "
            f"library_ms={tm['library_ms']:.4f} "
            f"bound_ms={tm['bound_ms']:.4f} ({tm['bound_by']}) "
            f"max_abs_err={tm['max_abs_err']:.3g} {tm['shape']}")
    log(f"    card: {gpu_name_and_limit()}")
    return summary


def main_path(torch, ops, ref, launches) -> dict:
    import scipy.sparse as sp
    from repro_torch.core.patterns import (banded_pairs, divide_space_order,
                                           overlap_pairs, particle_cloud,
                                           random_mask, values_for_mask)

    def coo(rows, cols, vals, n):
        return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))

    out = {}
    # banded: bandwidth 257 at n = 65536, ~1.7e5 block pairs in one wave
    n_band, d = SIZES["banded"]
    rows, cols = banded_pairs(n_band, d)
    va, vb = hashed_values(1), hashed_values(2)

    def build_banded(sess):
        return (sess.from_pattern(rows, cols, n_band, value_fn=va),
                sess.from_pattern(rows, cols, n_band, value_fn=vb))

    def banded_oracle():
        return (coo(rows, cols, va(rows, cols), n_band),
                coo(rows, cols, vb(rows, cols), n_band))

    out["banded"] = run_case(torch, ops, ref, launches, "banded A@B",
                             build_banded, lambda a, b: a @ b,
                             {"kernel": "pairs"}, banded_oracle)

    # S2: 3-D overlap matrix of 32768 particles, symmetric upper storage
    coords = particle_cloud(SIZES["s2"], 3)
    order = divide_space_order(coords)
    s_rows, s_cols = overlap_pairs(coords, 4.5, order=order)
    n_s2 = len(coords)
    vs = gaussian_overlap(coords, order)

    def build_s2(sess):
        return (sess.from_pattern(s_rows, s_cols, n_s2, value_fn=vs,
                                  upper=True),)

    def s2_oracle():
        s = coo(s_rows, s_cols, vs(s_rows, s_cols), n_s2)
        return s, s

    out["s2"] = run_case(torch, ops, ref, launches, "S2 sym_square", build_s2,
                         lambda s: s.sym_square(), {"kernel": "pairs"},
                         s2_oracle)

    # random: ~10% of 32x32 blocks occupied, no locality
    n_rnd = SIZES["random"]
    a_d = values_for_mask(random_mask(n_rnd, 1e-4, seed=3), seed=4)
    b_d = values_for_mask(random_mask(n_rnd, 1e-4, seed=5), seed=6)

    def build_random(sess):
        return sess.from_dense(a_d), sess.from_dense(b_d)

    out["random"] = run_case(torch, ops, ref, launches, "random A.T@B",
                             build_random, lambda a, b: a.T @ b,
                             {"kernel": "pairs"},
                             lambda: (sp.csr_matrix(a_d.T), sp.csr_matrix(b_d)))

    out["banded_gemm"] = run_case(torch, ops, ref, launches, "banded A@B gemm",
                                  build_banded, lambda a, b: a @ b,
                                  {"kernel": "gemm"}, banded_oracle)
    return out


# ---------------------------------------------------------------------------
# phase 4: report
# ---------------------------------------------------------------------------

#: the phase whose wave gives each kernel's headline row
HEADLINE = {"bsmm_pairs": "banded", "batched_gemm": "banded_gemm"}


def kernel_rows(phases, launches_total, worst) -> list:
    rows = []
    for name, phase in HEADLINE.items():
        tm = phases[phase]["timing"][name]
        err = max([worst[name]] + [ph["timing"][name]["max_abs_err"]
                                   for ph in phases.values()
                                   if name in ph["timing"]])
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{name}.cu",
                     "replaces": REPLACES[name],
                     "launches": launches_total[name], "max_abs_err": err,
                     "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                     "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                     "library_ms": tm["library_ms"]})
    return rows


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on a GPU",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _build, ops, ref
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e}); run "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = gpu_name_and_limit()
    log(f"card: {card}")

    log("phase 1: build")
    t0 = time.perf_counter()
    logs = _build.build()
    for name, text in logs.items():
        log(f"  nvcc {name}:\n" + "\n".join("    " + ln for ln in
                                           text.strip().splitlines()))
    for name in _build.KERNELS:
        _build.load(name)
    log(f"  build_s={time.perf_counter() - t0:.3f}")

    log("phase 2: kernels against their plain versions")
    t0 = time.perf_counter()
    worst = check_kernels(torch, ops, ref)
    log(f"  kernels_s={time.perf_counter() - t0:.3f}")

    log("phase 3: main path")
    t0 = time.perf_counter()
    phases = main_path(torch, ops, ref, _build.LAUNCHES)
    total = {k: sum(ph["launches"][k] for ph in phases.values())
             for k in _build.KERNELS}
    for name, ph in phases.items():
        kern = "batched_gemm" if ph["kernel"] == "gemm" else "bsmm_pairs"
        if ph["launches"][kern] <= 0:
            raise AssertionError(f"{name}: {kern} was never launched")
    build_share = sum(ph["build_s"] for ph in phases.values())
    log(f"  main_s={time.perf_counter() - t0:.3f} "
        f"host_construction_s={build_share:.3f} launches={total}")

    log("phase 4: report")
    rows = kernel_rows(phases, total, worst)
    elapsed = time.perf_counter() - t_start
    log(f"  smoke_s={elapsed:.3f} host_construction_share="
        f"{build_share / elapsed:.3f}")
    log("record: " + json.dumps({"card": card, "phases": phases,
                                 "smoke_s": elapsed}))
    log(card)
    log(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "shape"}
                                for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
