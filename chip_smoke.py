#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path, the paper's locality-aware quadtree multiply,
through the entry points a user calls, on the card:

1. build   — compile every CUDA kernel of the path from ``repro_torch/csrc``
             with nvcc for sm_90a (one nvcc per source, in parallel) into
             ``build/kernels/``; print the build time and, per compiled
             kernel, ptxas's registers, shared memory, stack and spills and
             its performance notes (wgmma serialization).
2. kernels — hold each kernel's wrapper against its plain PyTorch version
             on the card: bs 4..64, float32 and bfloat16, P = 0, 1, 4 and
             1003, dropped pairs, unvisited slots, one case with >= 1e5
             pairs.  Each element against the plain version's float32
             result: float32 atol 1e-4; bfloat16 2**-8 |want| + 1e-3
             rms(want) (the plain version run on the inputs cast to
             float32); the plain version with the last k-step of every
             product dropped must miss that check, and in the >= 1e5-pair
             case (bs 32, float32) so must the plain version on inputs
             rounded to TF32 (a tensor-core kernel without 3xTF32's
             correction terms).  Each bsmm_pairs call must reach the design
             its blocks select (bs >= 16: mma, else fma).
3. main    — ``repro_torch.Session(engine="torch")`` at the paper's scale:
             banded ``A @ B`` (n = 65536), S2 overlap ``S.sym_square()``
             (32768 particles), random ``A.T @ B``, and banded again under
             ``TorchEngine(kernel="gemm")``.  Launch counters are zeroed
             just before each run and read just after; the stored C block
             keys must equal the boolean product of the block masks, and
             256 sampled C blocks must match float64 sums built from the
             same input data (rtol 1e-5 in the Frobenius norm).  Every
             bsmm_pairs launch (bs 32, float32) must be on the tensor-core
             design; on the banded wave one-pass TF32 must miss the check.
3b. bs 8   — bsmm_pairs on the banded product's wave at bs 8 (the default
             ``Session(bs=8)``; 8.9e6 pairs, built with numpy), held against
             its plain version and timed beside ``torch.bmm``.
sim     — the paper's communication result (Table 1) on phase 3's banded
             and S2 graphs: the runtime simulator (``repro_torch.runtime``)
             runs the build phase, zeroes its counters and runs the
             multiply on p = 16 and 64 simulated workers under
             parent-worker and random chunk placement; per run the
             average and maximum MB received per worker, steals, makespan,
             parallel efficiency and the simulator's host seconds.
             Parent-worker placement must receive less than random, on
             average and at the maximum, at each p, and
             ``analysis.comm_summary`` must agree with each report.  Then
             ``Session.simulate(fresh_stats=True)`` on each session.
solvers — the electronic-structure path through ``Session(engine=
             "torch")`` (leaf_n 2048, bs 32, every multiply a bsmm_pairs
             wave on the mma design): ``inverse_factor(method=
             "localized", tau=1e-7)`` of a banded SPD overlap S at n =
             16384, ``ZᵀSZ - I`` in float64 on the card within 2 tol and
             within 1e-4 sqrt(n/64) of the reported residual (tol = 1e-4
             sqrt(n/64)); ``multiply_chain([Z.T, F, Z], TauPolicy(target=
             1e-5))``, its error against float64 on the card within the
             accumulated bound plus a float32 slack of 1e-3 sqrt(n/64),
             the bound within the target; ``scf_density`` at n = 1024
             (leaf_n 256, SP2 tol 1e-6 sqrt(n/64)): converged, occupation
             within 1e-3, zero replay tasks, D within 5e-3 of a float64
             ``eigh`` reference on the card.  Per step the wall seconds,
             launches per design, the kernel's summed CUDA-event ms and
             share, and the host seconds of the dense round trips.
lm      — the LM substrate at full width and depth: ``h2o-danube3-4b``
             (24 layers, d_model 3840, 32 heads, 8 kv heads, hd 120,
             window 4096, bf16), weights from ``init_params`` with a
             seeded generator on the card.  The attention kernel against
             its plain version at small shapes (float32 and bfloat16,
             causal and bidirectional, k and v with as many heads as q or
             fewer; each call must reach the design its inputs select:
             bfloat16 with D % 8 == 0 the tensor-core ``wgmma`` design,
             else the FMA design); the smoke config's prefill on the card
             against the same prefill on the CPU; a prefill of 1 x 32768
             seeded tokens (the ``prefill_32k`` shape with the batch cut
             from 32 to 1), which must launch ``banded_attention`` once per
             layer, every launch on the ``wgmma`` design with k and v of
             the 8 kv heads, and give finite logits; the kernel against its
             plain version on layer 0's real q, k, v, head by head, and its
             time beside its bound, the plain version's and
             ``scaled_dot_product_attention`` with a band mask on k and v
             copied over each group beforehand (a yardstick the port never
             calls); ``lm_serve.generate`` at batch 4, prompt 32, gen 16,
             every token in [0, vocab), then the same decode again under
             ``torch.profiler`` for the device's idle share (as in phase
             serve below; tracing slows the host, so the device's busy
             time over the untraced decode is printed beside it).  The
             attention kernel is held element by element against the
             plain version's float32 result (the rule of phase 2); on
             layer 0 the plain version with the band one 64-key tile short
             must fail that check.
serve   — after lm, since a profiler session makes every later kernel
             launch of the process cost the host more:
             ``repro_torch.serve.PlanServer()`` on the card (its default
             device; 4 sessions, each with its own ``TorchEngine``,
             leaf_n 1024, bs 32) at n = 4096: three registered banded
             matrices (element half-bandwidth 128, seeded values as in
             phase 3) and a stream of 32 multiplies cycling over their
             pairs; one warmup pass at max_inflight 8, then a measured pass
             at each max_inflight of 1, 2, 4 and 8.  Then, on a
             ``prewarm=True`` server, ``Zᵀ F Z`` and ``Zᵀ S Z`` (S and F the
             solvers phase's tables at n = 4096, Z S's inverse Cholesky
             factor with blocks of norm below 1e-7 dropped) and 8 SP2
             iterations from F scaled by its Gershgorin bounds (ne = n/4).
             Every result equals the same request served alone on the card
             bitwise, and each request alone is within tol sqrt(n/64) of a
             float64 product on the card (relative Frobenius; tol 1e-4 for
             products, 1e-3 for SP2).  Each measured pass: hit rate 1.0,
             no new task, no cold compile, merged waves at max_inflight
             >= 2, every serving wave one bsmm_pairs launch on the mma
             design; the SP2 request meets its prewarmed replicas (no
             cache miss, no compile time).  Per pass: requests/s,
             p50/p95/p99 ms, merged, solo and engine-own waves, the
             kernel's CUDA-event share of the wall time, and the device's
             idle share from a ``torch.profiler`` trace of the pass (one
             minus the union of CUDA kernel, memcpy and memset intervals
             over the pass, CUDA activity only, the window opened and
             closed by a one-element add on the card).
4. report  — per phase the engine's wave stats and launch counts; per
             kernel its time on the card at the main path's largest wave
             (CUDA events), its bound (both terms: bytes over the HBM rate,
             operations over the tensor-core rate of their type, float32 at
             the 3xTF32 rate), its achieved bytes/s and FLOP/s and
             share of the bound, the plain version's time and the library
             yardstick's (``torch.bmm``, ``scaled_dot_product_
             attention``); the card's name and power limit.  Each kernel
             is also held against its plain version on that same wave, at
             the tolerance of phase 2.

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

#: the TPU kernel each CUDA kernel replaces (pl.pallas_call sites)
REPLACES = {"bsmm_pairs": "src/repro/kernels/bsmm_pairs.py:78",
            "batched_gemm": "src/repro/kernels/batched_gemm.py:52",
            "banded_attention": "src/repro/kernels/block_attention.py:102"}
#: row name -> the launch counter (and csrc/ source) of its kernel
COUNTER = {"bsmm_pairs": "bsmm_pairs", "batched_gemm": "batched_gemm",
           "banded_attention": "block_attention"}

LEAF_N, BS = 2048, 32
N_SAMPLE = 256
#: main-path sizes: banded (n, half-bandwidth), S2 particles per axis (3-D),
#: random n (density 1e-4)
SIZES = {"banded": (65536, 128), "s2": 32, "random": 4096}


def log(*a) -> None:
    print(*a, flush=True)


def reset_counts() -> None:
    """Every launch count to 0, per kernel and per design."""
    from repro_torch.kernels import _build
    _build.reset_launches()


def variant_counts() -> dict:
    from repro_torch.kernels import _build
    return {k: dict(v) for k, v in _build.VARIANT_LAUNCHES.items()}


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


def bound_ms(n_bytes: float, flops: float, peak: float) -> dict:
    """The least time of the work, in ms: the larger of its bytes over the
    HBM rate and its operations over ``peak``; both terms are kept.  The
    H100's peaks are those of :mod:`repro_torch.launch.roofline`."""
    from repro_torch.launch.roofline import HBM_BPS
    tb, tf = n_bytes / HBM_BPS * 1e3, flops / peak * 1e3
    return {"bound_ms": max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations",
            "bound_bytes_ms": tb, "bound_ops_ms": tf}


def multiply_peak(torch, dtype) -> float:
    """The operations rate that bounds float32 or bf16 multiply work."""
    from repro_torch.launch.roofline import BF16_FLOPS, FP32_3XTF32_FLOPS
    return BF16_FLOPS if dtype == torch.bfloat16 else FP32_3XTF32_FLOPS


def tf32_round(torch, x):
    """x as float32 rounded to TF32 the way ``cvt.rna.tf32.f32`` rounds (to
    nearest, ties away from zero): the inputs of a one-pass TF32 product."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_elementwise(torch, what, got, want32, dtype) -> float:
    """Each element of a kernel's output, which must be of ``dtype`` (its
    inputs' type), against the plain version's float32 result ``want32``
    on the same inputs (for bfloat16, the plain version run on the inputs
    cast to float32); returns the max abs error and raises on a miss.

    float32: atol 1e-4 (both sum in float32, in other orders).
    bfloat16: |got - want32| <= 2**-8 |want32| + 1e-3 rms(want32).  The
    kernels keep float32 inside and round once, at the output, which moves
    a value by at most half a bf16 ulp, 2**-8 of it; 1e-3 of the output's
    rms covers the float32 sums taken in another order.  A missing k-step
    or kv tile, or a wrong window edge, moves outputs by far more."""
    if got.shape != want32.shape or got.dtype != dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want32.shape)} {dtype}")
    if got.numel() == 0:
        return 0.0
    diff = (got.float() - want32).abs()
    if got.dtype == torch.float32:
        tol, rule = torch.full_like(want32, 1e-4), "atol 1e-4"
    else:
        rms = float(want32.pow(2).mean().sqrt())
        tol = 2 ** -8 * want32.abs() + 1e-3 * rms
        rule = f"2**-8 |want| + 1e-3 rms(want), rms {rms:.4g}"
    excess = (diff - tol).flatten()
    i = int(excess.argmax())
    if float(excess[i]) > 0:
        raise AssertionError(
            f"{what}: |got - want| {float(diff.flatten()[i]):.4g} > "
            f"tolerance {float(tol.flatten()[i]):.4g} ({rule}) at flat index "
            f"{i}; max abs err {float(diff.max()):.4g}")
    return float(diff.max())


def must_fail(torch, what, short, want32) -> str:
    """The check's power: ``short`` (a plain version with part of the work
    dropped) must miss :func:`check_elementwise`; returns the miss."""
    try:
        check_elementwise(torch, what, short, want32, short.dtype)
    except AssertionError as e:
        return str(e)
    raise AssertionError(f"{what} passes the check: the tolerance is too "
                         f"loose")


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


def banded_wave(g: int, hb: int):
    """The block pairs of ``C = A @ B`` for two block-banded matrices of g x g
    blocks with block half-bandwidth hb, as the engine hands them to
    ``bsmm_pairs``: A and B blocks packed row by row over the band (block
    (i, k) at ``i * (2 hb + 1) + k - i + hb``), C slots row by row over the
    band of C (half-bandwidth 2 hb), each slot's pairs in k order, so seg is
    ascending.  Returns (sa, sb, seg, n_blocks, cap_c) as int32 numpy arrays
    and ints; A and B have n_blocks blocks each (some at the edges unused)."""
    w = 2 * hb + 1
    i = np.repeat(np.arange(g), 4 * hb + 1)
    j = i + np.tile(np.arange(-2 * hb, 2 * hb + 1), g)
    keep = (j >= 0) & (j < g)
    i, j = i[keep], j[keep]
    lo = np.maximum(np.maximum(i, j) - hb, 0)
    hi = np.minimum(np.minimum(i, j) + hb, g - 1)
    cnt = hi - lo + 1
    seg = np.repeat(np.arange(len(i)), cnt)
    start = np.cumsum(cnt) - cnt
    k = lo[seg] + np.arange(len(seg)) - start[seg]
    sa = i[seg] * w + k - i[seg] + hb
    sb = k * w + j[seg] - k + hb
    return (sa.astype(np.int32), sb.astype(np.int32), seg.astype(np.int32),
            g * w, len(i))


def check_kernels(torch, ops, ref) -> dict:
    """Every kernel against its plain version; returns worst error each."""
    from repro_torch.kernels import bsmm_pairs as kbp
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
                design = kbp.design_for(a)
                before = variant_counts()["bsmm_pairs"][design]
                got = ops.bsmm_pairs(a, b, sa, sb, seg, cap_c=cap_c)
                torch.cuda.synchronize()
                if variant_counts()["bsmm_pairs"][design] != before + 1:
                    raise AssertionError(f"bsmm_pairs bs={bs} did not launch "
                                         f"the {design} design")
                sa_c, sb_c = sa.clamp(0, cap_a - 1), sb.clamp(0, cap_b - 1)
                want32 = ref.bsmm_pairs_ref(a.float(), b.float(), sa_c, sb_c,
                                            seg, cap_c)
                what = f"bsmm_pairs bs={bs} {dtype} P={n_pairs}"
                err = check_elementwise(torch, what, got, want32, dtype)
                if n_pairs > inv:
                    must_fail(torch, what + " with the last k-step dropped",
                              ref.bsmm_pairs_ref(a[:, :, :-1], b[:, :-1],
                                                 sa_c, sb_c, seg, cap_c),
                              want32)
                if n_pairs >= 100000:
                    log("    one-pass TF32 fails the check, as it must: "
                        + must_fail(torch, what + " in one-pass TF32",
                                    ref.bsmm_pairs_ref(
                                        tf32_round(torch, a),
                                        tf32_round(torch, b), sa_c, sb_c,
                                        seg, cap_c), want32))
                if unv and bool((got[cap_c - unv:] != 0).any()):
                    raise AssertionError(
                        f"bsmm_pairs bs={bs} {dtype}: unvisited slots not 0")
                worst["bsmm_pairs"] = max(worst["bsmm_pairs"],
                                          err if dtype == torch.float32
                                          else 0.0)
                log(f"  bsmm_pairs   bs={bs:2d} {str(dtype):14s} "
                    f"P={n_pairs:6d} cap_c={cap_c:5d} {design} "
                    f"max_abs_err={err:.3g}")
            for p in (1003, 0, 1, 4):
                a = torch.tensor(rng.standard_normal((p, bs, bs)),
                                 dtype=dtype, device="cuda")
                b = torch.tensor(rng.standard_normal((p, bs, bs)),
                                 dtype=dtype, device="cuda")
                got = ops.batched_gemm(a, b)
                torch.cuda.synchronize()
                want32 = ref.batched_gemm_ref(a.float(), b.float())
                what = f"batched_gemm bs={bs} {dtype} P={p}"
                err = check_elementwise(torch, what, got, want32, dtype)
                if p:
                    must_fail(torch, what + " with the last k-step dropped",
                              ref.batched_gemm_ref(a[:, :, :-1], b[:, :-1]),
                              want32)
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
    """Keep the inputs of one call of each named kernel wrapper of
    :mod:`repro_torch.kernels.ops` while a main-path run goes through it,
    so that the report times each kernel at the shapes the path gave it:
    the largest wave of a multiply kernel, the first call (layer 0) of
    ``banded_attention``, whose calls all have one shape."""

    #: wrapper -> size of a call (the largest is kept), or None: keep the first
    SIZE = {"bsmm_pairs": lambda args: args[2].shape[0],
            "batched_gemm": lambda args: args[0].shape[0],
            "banded_attention": None}

    def __init__(self, ops, names=("bsmm_pairs", "batched_gemm")):
        self.ops = ops
        self.calls: dict[str, tuple] = {}
        self._orig = {k: getattr(ops, k) for k in names}

    def __enter__(self):
        def wrap(name):
            orig, size_of = self._orig[name], self.SIZE[name]

            def fn(*args, **kw):
                size = size_of(args) if size_of else 0
                if name not in self.calls or (
                        size_of and size >= self.calls[name][0]):
                    self.calls[name] = (size, args, kw)
                return orig(*args, **kw)
            return fn
        for name in self._orig:
            setattr(self.ops, name, wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.ops, name, fn)


def time_kernel(torch, ref, name, args, kw, tf32_must_fail=False) -> dict:
    """Kernel, plain version and ``torch.bmm`` yardstick on one wave's
    inputs (CUDA events), the kernel's error against its plain version
    (raises past the tolerance of :func:`check_elementwise`), and its
    bound: the larger of the bytes it must move (each input read once, each
    output written once) over the HBM rate and the FLOPs these inputs need
    over the rate of :func:`multiply_peak` (float32 at the 3xTF32 rate).
    With ``tf32_must_fail`` the plain version on TF32-rounded inputs (a
    kernel without 3xTF32's correction terms) must miss the check."""
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
    want32 = plain()
    err = check_elementwise(torch, f"{name} on the main path's wave "
                            f"{shape}", kern(), want32, ga.dtype)
    if tf32_must_fail:
        log("    one-pass TF32 fails the check, as it must: " + must_fail(
            torch, f"{name} on the main path's wave in one-pass TF32",
            ref.bsmm_pairs_ref(tf32_round(torch, a), tf32_round(torch, b),
                               sa, sb, seg, cap_c), want32))
    del want32
    out = {"ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain,
                                                           reps=5),
           "library_ms": cuda_ms(torch, lambda: torch.bmm(ga, gb)),
           "max_abs_err": err, "bytes": n_bytes, "flops": flops,
           "shape": shape,
           **bound_ms(n_bytes, flops, multiply_peak(torch, ga.dtype))}
    out.update(rates(out))
    del ga, gb
    return out


def rates(tm) -> dict:
    """Achieved bytes/s and FLOP/s of a timing, and its share of the bound
    (bound_ms / ms)."""
    return {"achieved_tb_per_s": tm["bytes"] / tm["ms"] / 1e9,
            "achieved_tflop_per_s": tm["flops"] / tm["ms"] / 1e9,
            "share_of_bound": tm["bound_ms"] / tm["ms"]}


def run_case(torch, ops, ref, launches, name, build, op, engine_kw,
             oracle, tf32_must_fail=False, keep=None):
    """One main-path run: build inputs, zero the counters, multiply, read
    the counters (every bsmm_pairs launch, bs 32 float32, must have gone to
    the tensor-core design), read back and check, then time each kernel on
    the wave this run gave it.  With ``keep`` (a dict) the session, the
    result and the number of tasks that built the inputs stay in
    ``keep[name]`` for phase sim."""
    from repro_torch import Session
    from repro_torch.core.engine import TorchEngine
    import scipy.sparse as sp

    t0 = time.perf_counter()
    sess = Session(engine=TorchEngine(**engine_kw),
                   leaf_n=LEAF_N, bs=BS)
    mats = build(sess)
    t_build = time.perf_counter() - t0
    n_build = len(sess.graph.nodes)
    reset_counts()
    t1 = time.perf_counter()
    with Capture(ops) as cap:
        c = op(*mats)
        stats = sess.engine_stats()     # flushes every wave; ends in a sync
    t_mult = time.perf_counter() - t1
    counts = dict(launches)
    designs = variant_counts()["bsmm_pairs"]
    if designs["mma"] != counts["bsmm_pairs"]:
        raise AssertionError(f"{name}: bsmm_pairs launches {designs} not all "
                             f"on the tensor-core (mma) design")
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
                   flops=sess.flops, launches=counts,
                   bsmm_pairs_designs=designs, build_s=t_build,
                   multiply_s=t_mult, total_s=t_total, **res)
    log(f"  {name}: " + json.dumps(summary))
    summary["timing"] = {}
    for kname, (_, args, kw) in sorted(cap.calls.items()):
        tm = summary["timing"][kname] = time_kernel(
            torch, ref, kname, args, kw,
            tf32_must_fail=tf32_must_fail and kname == "bsmm_pairs")
        log(f"    {kname}: ms={tm['ms']:.4f} plain_ms={tm['plain_ms']:.4f} "
            f"library_ms={tm['library_ms']:.4f} "
            f"bound_ms={tm['bound_ms']:.4f} ({tm['bound_by']}; bytes "
            f"{tm['bound_bytes_ms']:.4f}, operations "
            f"{tm['bound_ops_ms']:.4f}) "
            f"{tm['achieved_tb_per_s']:.3f} TB/s "
            f"{tm['achieved_tflop_per_s']:.2f} TFLOP/s "
            f"share_of_bound={tm['share_of_bound']:.3f} "
            f"max_abs_err={tm['max_abs_err']:.3g} {tm['shape']}")
    log(f"    card: {gpu_name_and_limit()}")
    if keep is not None:
        keep[name] = (sess, c, n_build)
    return summary


def main_path(torch, ops, ref, launches, keep) -> dict:
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
                             {"kernel": "pairs"}, banded_oracle,
                             tf32_must_fail=True, keep=keep)

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
                         s2_oracle, keep=keep)

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


#: blocks a side and block half-bandwidth of the bs-8 wave: the banded
#: phase's matrices (n = 65536, element half-bandwidth 128) cut into the
#: 8 x 8 blocks of the default ``Session(bs=8)``
BS8_WAVE = (8192, 16)


def time_bs8_wave(torch, ref) -> dict:
    """``bsmm_pairs`` at the default Session width, bs 8 float32, on the
    wave of the banded product built with numpy (:func:`banded_wave`, no
    Session; random blocks from a seeded generator on the card): held
    against its plain version (:func:`check_elementwise`, and the last
    k-step dropped must miss), then timed beside its bound, the plain
    version and ``torch.bmm`` on the pre-gathered pairs."""
    from repro_torch.kernels import bsmm_pairs as kbp
    g, hb = BS8_WAVE
    bs = 8
    sa, sb, seg, n_blocks, cap_c = banded_wave(g, hb)
    gen = torch.Generator("cuda").manual_seed(8)
    a, b = (torch.randn((n_blocks, bs, bs), generator=gen, device="cuda")
            * bs ** -0.25 for _ in range(2))
    sa_d, sb_d, seg_d = (torch.from_numpy(x).cuda() for x in (sa, sb, seg))
    kern = lambda: kbp.bsmm_pairs(a, b, sa_d, sb_d, seg_d,  # noqa: E731
                                  cap_c=cap_c)
    plain = lambda: ref.bsmm_pairs_ref(a, b, sa_d, sb_d, seg_d,  # noqa: E731
                                       cap_c)
    want32 = plain()
    err = check_elementwise(torch, "bsmm_pairs on the bs-8 wave", kern(),
                            want32, torch.float32)
    must_fail(torch, "bsmm_pairs on the bs-8 wave, last k-step dropped",
              ref.bsmm_pairs_ref(a[:, :, :-1], b[:, :-1], sa_d, sb_d, seg_d,
                                 cap_c), want32)
    del want32
    # the blocks the pairs read, once each; C once; sa, sb, seg once
    n_bytes = ((len(np.unique(sa)) + len(np.unique(sb)) + cap_c) * bs * bs * 4
               + 12 * len(seg))
    flops = 2.0 * bs ** 3 * len(seg)
    ga, gb = a[sa_d.long()], b[sb_d.long()]
    res = {"ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain,
                                                           reps=3),
           "library_ms": cuda_ms(torch, lambda: torch.bmm(ga, gb)),
           "max_abs_err": err, "bytes": n_bytes, "flops": flops,
           "design": kbp.design_for(a),
           "shape": {"pairs": len(seg), "c_blocks": cap_c,
                     "a_blocks": n_blocks, "b_blocks": n_blocks, "bs": bs,
                     "dtype": "torch.float32"},
           **bound_ms(n_bytes, flops, multiply_peak(torch, torch.float32))}
    res.update(rates(res))
    del ga, gb
    torch.cuda.empty_cache()
    log(f"  bsmm_pairs bs-8 wave: ms={res['ms']:.4f} "
        f"plain_ms={res['plain_ms']:.4f} library_ms={res['library_ms']:.4f} "
        f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}; bytes "
        f"{res['bound_bytes_ms']:.4f}, operations {res['bound_ops_ms']:.4f}) "
        f"share_of_bound={res['share_of_bound']:.3f} design={res['design']} "
        f"max_abs_err={err:.3g} {res['shape']}")
    log(f"    card: {gpu_name_and_limit()}")
    return res


# ---------------------------------------------------------------------------
# phase sim: the paper's communication result on phase 3's graphs
# ---------------------------------------------------------------------------

#: simulated worker counts and chunk placements of phase sim
SIM_PS = (16, 64)
SIM_PLACEMENTS = ("parent-worker", "random")


def sim_run(sess, n_build, p, placement) -> tuple:
    """The session's task graph on ``p`` simulated workers: a scheduler
    built as ``Session.scheduler`` builds it runs the input-building tasks
    (the build phase places the input chunks, paper §7), zeroes its
    counters (``fresh_stats``) and runs the multiply.  Returns the
    multiply phase's report and the host seconds of both runs."""
    from repro_torch.runtime.scheduler import Scheduler
    t0 = time.perf_counter()
    sched = Scheduler(cost=sess.cost, cache_bytes=sess.cache_bytes,
                      seed=sess.seed, dedup=sess.dedup)
    sched.run(sess.graph, n_workers=p, placement=placement,
              only=set(range(n_build)))
    sched.reset_stats()
    rep = sched.run(sess.graph)
    return rep, time.perf_counter() - t0


def sim_record(an, rep, host_s) -> dict:
    """One run's numbers; ``comm_summary`` must agree with the report."""
    s = an.comm_summary(rep.bytes_received)
    if not (s["n_workers"] == rep.n_workers
            and s["max_bytes"] == rep.max_bytes_received
            and abs(s["avg_bytes"] - rep.avg_bytes_received)
            <= 1e-9 * max(rep.avg_bytes_received, 1.0)
            and s["imbalance"] >= 1.0):
        raise AssertionError(f"comm_summary {s} disagrees with the report")
    return {"avg_MB": rep.avg_bytes_received / 1e6,
            "max_MB": rep.max_bytes_received / 1e6,
            "imbalance": s["imbalance"], "steals": rep.steals,
            "tasks": rep.n_tasks, "makespan_s": rep.makespan,
            "parallel_efficiency": rep.parallel_efficiency,
            "host_s": host_s}


def sim_phase(kept) -> dict:
    """``Scheduler`` runs over phase 3's banded ``A @ B`` and S2
    ``sym_square`` graphs for each placement and p of :data:`SIM_PS`; the
    paper's locality claim (Table 1): parent-worker placement receives
    fewer bytes per worker than random placement, on average and at the
    maximum, at every p.  Then ``Session.simulate(fresh_stats=True)``
    itself on each session: the whole graph as one phase."""
    from repro_torch.core import analysis as an
    out = {}
    for name, (sess, c, n_build) in kept.items():
        runs = {}
        for p in SIM_PS:
            for placement in SIM_PLACEMENTS:
                rep, host_s = sim_run(sess, n_build, p, placement)
                r = runs[f"{placement}/p{p}"] = sim_record(an, rep, host_s)
                log(f"  {name} {placement} p={p}: avg_MB={r['avg_MB']:.6f} "
                    f"max_MB={r['max_MB']:.6f} steals={r['steals']} "
                    f"makespan_s={r['makespan_s']:.6g} parallel_efficiency="
                    f"{r['parallel_efficiency']:.4f} host_s={host_s:.3f}")
            aware = runs[f"parent-worker/p{p}"]
            oblivious = runs[f"random/p{p}"]
            ratio = {k: oblivious[k] / aware[k] for k in ("avg_MB", "max_MB")}
            runs[f"random_over_parent/p{p}"] = ratio
            log(f"  {name} p={p}: random / parent-worker bytes received "
                f"per worker: avg {ratio['avg_MB']:.3f}x, max "
                f"{ratio['max_MB']:.3f}x")
            if not (aware["avg_MB"] < oblivious["avg_MB"]
                    and aware["max_MB"] < oblivious["max_MB"]):
                raise AssertionError(
                    f"{name} p={p}: parent-worker placement received no less "
                    f"than random ({aware} vs {oblivious})")
        t0 = time.perf_counter()
        rep = sess.simulate(p=SIM_PS[0], placement="parent-worker",
                            fresh_stats=True)
        r = runs["session.simulate"] = sim_record(
            an, rep, time.perf_counter() - t0)
        log(f"  {name} Session.simulate(p={SIM_PS[0]}, parent-worker, "
            f"fresh_stats=True), build and multiply as one phase: "
            f"avg_MB={r['avg_MB']:.6f} max_MB={r['max_MB']:.6f} "
            f"steals={r['steals']} tasks={r['tasks']} "
            f"host_s={r['host_s']:.3f}")
        out[name] = runs
    log(f"    card: {gpu_name_and_limit()}")
    return out


# ---------------------------------------------------------------------------
# phase solvers: the electronic-structure path on the card
# ---------------------------------------------------------------------------

#: solver sizes: the factor and chain at n (leaf_n 2048, bs 32); the SCF
#: density at SCF_N (leaf_n 256, bs 32); band half-width of S and F
SOLVER_N, SCF_N, SCF_LEAF_N, BAND_W = 16384, 1024, 256, 64


def overlap_table(n: int, w: int, seed: int) -> np.ndarray:
    """Overlap S by diagonals, row k = |i - j| (entry i is S[i, i + k]):
    standard normal draws times 0.5**k, scaled so every row's off-diagonal
    mass is at most 0.45 against the unit diagonal (diagonally dominant,
    hence SPD), as ``tests/test_solvers.py::_spd("banded")`` builds it."""
    rng = np.random.default_rng(seed)
    tab = np.zeros((w + 1, n))
    for k in range(1, w + 1):
        tab[k, :n - k] = rng.standard_normal(n - k) * 0.5 ** k
    mass = np.abs(tab[1:]).sum(0)
    for k in range(1, w + 1):
        mass[k:] += np.abs(tab[k, :n - k])
    tab[1:] *= 0.45 / mass.max()
    tab[0] = 1.0
    return tab


def fock_table(n: int, w: int, seed: int) -> np.ndarray:
    """Fock F by diagonals: -exp(-0.4 k) plus N(0, 0.05**2) noise, the
    same draw on both sides of the diagonal."""
    rng = np.random.default_rng(seed)
    tab = np.zeros((w + 1, n))
    for k in range(w + 1):
        tab[k, :n - k] = (-np.exp(-0.4 * k)
                          + 0.05 * rng.standard_normal(n - k))
    return tab


def table_values(tab):
    """``value_fn`` of ``Session.from_pattern`` for a symmetric band."""
    def value_fn(r, c):
        r, c = np.asarray(r), np.asarray(c)
        return tab[np.abs(r - c), np.minimum(r, c)]
    return value_fn


def table_dense(torch, tab, n, device):
    """The symmetric banded matrix of a table, dense float64."""
    a = torch.zeros((n, n), dtype=torch.float64, device=device)
    t = torch.from_numpy(tab).to(device)
    for k in range(tab.shape[0]):
        i = torch.arange(n - k, device=device)
        a[i, i + k] = t[k, :n - k]
        a[i + k, i] = t[k, :n - k]
    return a


class StepClock:
    """Counts what one solver step spends: every ``bsmm_pairs`` launch's
    CUDA-event time (the wrapper of :mod:`repro_torch.kernels.ops`,
    bracketed by events), and the host seconds of the dense round trips,
    dense -> quadtree (``qt_from_dense``, ``qt_rebind_dense``) and quadtree
    -> dense (``qt_to_dense`` after its flush)."""

    def __init__(self, torch, ops):
        import repro_torch.api.matrix as mmat
        import repro_torch.api.plan as mplan
        import repro_torch.api.session as msess
        self.torch, self.ops = torch, ops
        self.sites = [(ops, "bsmm_pairs"), (msess, "qt_from_dense"),
                      (mplan, "qt_rebind_dense"), (mmat, "qt_to_dense")]
        self.events: list = []
        self.dense_s = {"from_dense": 0.0, "rebind_dense": 0.0,
                        "to_dense": 0.0}
        self.dense_calls = dict.fromkeys(self.dense_s, 0)

    def __enter__(self):
        torch = self.torch
        self._orig = [getattr(m, a) for m, a in self.sites]
        kern, from_dense, rebind, to_dense = self._orig

        def timed_kernel(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = kern(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out

        def host(key, fn, flush=False):
            def timed(g, *args, **kw):
                if flush:
                    g.flush()           # kernel waves are not the round trip
                t0 = time.perf_counter()
                out = fn(g, *args, **kw)
                self.dense_s[key] += time.perf_counter() - t0
                self.dense_calls[key] += 1
                return out
            return timed

        wrapped = [timed_kernel, host("from_dense", from_dense),
                   host("rebind_dense", rebind),
                   host("to_dense", to_dense, flush=True)]
        for (m, a), fn in zip(self.sites, wrapped):
            setattr(m, a, fn)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        for (m, a), fn in zip(self.sites, self._orig):
            setattr(m, a, fn)

    def summary(self, launches) -> dict:
        kernel_ms = sum(s.elapsed_time(e) for s, e in self.events)
        designs = variant_counts()["bsmm_pairs"]
        out = {"wall_s": self.wall_s, "launches": dict(launches),
               "bsmm_pairs_designs": designs, "kernel_ms": kernel_ms,
               "kernel_share": kernel_ms / 1e3 / self.wall_s,
               "dense_round_trip_s": dict(self.dense_s),
               "dense_round_trip_calls": dict(self.dense_calls)}
        if launches["bsmm_pairs"] <= 0:
            raise AssertionError("solver step: bsmm_pairs was never launched")
        if designs["mma"] != launches["bsmm_pairs"] or \
                len(self.events) != launches["bsmm_pairs"]:
            raise AssertionError(f"solver step: bsmm_pairs launches "
                                 f"{designs} not all on the mma design")
        return out


def solver_step(torch, ops, launches, name, fn):
    """Run one solver step with the counts zeroed just before it and read
    just after, under a :class:`StepClock`."""
    reset_counts()
    with StepClock(torch, ops) as clock:
        result = fn()
    rec = clock.summary(launches)
    log(f"  {name}: wall_s={rec['wall_s']:.3f} bsmm_pairs launches="
        f"{rec['launches']['bsmm_pairs']} designs={rec['bsmm_pairs_designs']}"
        f" kernel_ms={rec['kernel_ms']:.3f} kernel_share="
        f"{rec['kernel_share']:.5f} dense round trips (host s): "
        f"{json.dumps(rec['dense_round_trip_s'])} calls "
        f"{json.dumps(rec['dense_round_trip_calls'])}")
    return result, rec


def solver_phase(torch, ops, launches, n=SOLVER_N, scf_n=SCF_N,
                 dev="cuda") -> dict:
    """Inverse factorization (localized) and the chain ``Zᵀ F Z`` at
    ``n``, then the SCF density at ``scf_n``, all through
    ``repro_torch.Session(engine="torch")`` and ``repro_torch.solvers``,
    each checked against float64 products on the card."""
    import math
    from repro_torch import Session
    from repro_torch.core.patterns import banded_pairs
    from repro_torch.solvers import TauPolicy, inverse_factor, \
        multiply_chain, scf_density
    out = {}
    # float32 packing puts a floor under every Frobenius check, and the
    # floor grows like sqrt(n): the reference's float32 tolerances hold at
    # n = 64, so each is scaled by sqrt(n / 64) here
    grow = math.sqrt(n / 64)
    factor_tol = 1e-4 * grow
    chain_slack = 1e-3 * grow
    s_tab, f_tab = overlap_table(n, BAND_W, 0), fock_table(n, BAND_W, 0)
    rows, cols = banded_pairs(n, BAND_W)
    t0 = time.perf_counter()
    sess = Session(engine="torch", leaf_n=LEAF_N, bs=BS)
    S = sess.from_pattern(rows, cols, n, value_fn=table_values(s_tab),
                          upper=True)
    F = sess.from_pattern(rows, cols, n, value_fn=table_values(f_tab))
    out["build_s"] = time.perf_counter() - t0
    log(f"  inputs n={n} band {BAND_W}: build_s={out['build_s']:.3f}")

    (Z, rep), rec = solver_step(
        torch, ops, launches, "inverse_factor(localized, tau=1e-7)",
        lambda: inverse_factor(S, method="localized", tau=1e-7,
                               tol=factor_tol))
    zd = torch.from_numpy(Z.to_dense()).to(dev, torch.float64)
    sd = table_dense(torch, s_tab, n, dev)
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    measured = float(torch.linalg.norm(zd.T @ sd @ zd - eye))
    del sd
    rec.update(n=n, iterations=rep.iterations, splits=rep.splits,
               multiply_tasks=rep.multiply_tasks, flops=rep.flops,
               residual=rep.residual, measured_residual=measured,
               tol=factor_tol, converged=rep.converged)
    log(f"    residual {rep.residual:.6g} (report) {measured:.6g} (float64 "
        f"on the card), tol {factor_tol:.6g}; iterations {rep.iterations} "
        f"splits {rep.splits} multiply_tasks {rep.multiply_tasks}")
    if not (rep.converged and measured <= 2 * factor_tol
            and abs(measured - rep.residual) <= 1e-4 * grow):
        raise AssertionError(f"inverse factor: {rec}")
    out["factor"] = rec

    def chain():        # the product read back: its last wave runs there
        P, crep = multiply_chain([Z.T, F, Z], policy=TauPolicy(target=1e-5))
        return P.to_dense(), crep

    (pd, crep), rec = solver_step(
        torch, ops, launches, "multiply_chain([Z.T, F, Z], target=1e-5)",
        chain)
    fd = table_dense(torch, f_tab, n, dev)
    exact = zd.T @ fd @ zd
    del fd
    err = float(torch.linalg.norm(
        torch.from_numpy(pd).to(dev, torch.float64) - exact))
    del exact, zd, eye, pd
    rec.update(n=n, taus=crep.taus, accumulated_bound=crep.accumulated_bound,
               measured_error=err, float32_slack=chain_slack,
               flops=crep.flops, pruned_flops=crep.pruned_flops)
    log(f"    error {err:.6g} (float64 on the card), accumulated bound "
        f"{crep.accumulated_bound:.6g} + float32 slack {chain_slack:.6g}, "
        f"target 1e-5; taus {crep.taus}; flops {crep.flops:.6g} pruned "
        f"{crep.pruned_flops:.6g}")
    if not (err <= crep.accumulated_bound + chain_slack
            and crep.accumulated_bound <= 1e-5):
        raise AssertionError(f"multiply chain: {rec}")
    out["chain"] = rec
    del sess, S, F, Z
    torch.cuda.empty_cache()

    n = scf_n
    sp2_tol = 1e-6 * math.sqrt(n / 64)
    s = table_dense(torch, overlap_table(n, BAND_W, 0), n, dev)
    f = table_dense(torch, fock_table(n, BAND_W, 0), n, dev)
    n_occ = n // 4
    scf_sess = Session(lazy=True, engine="torch", leaf_n=SCF_LEAF_N, bs=BS)

    def scf():          # D read back: the back transformation runs there
        D, srep = scf_density(scf_sess, f.cpu().numpy(), s.cpu().numpy(),
                              n_occ, tol=sp2_tol)
        return D.to_dense(), srep

    (dd, srep), rec = solver_step(
        torch, ops, launches, f"scf_density(n={n}, n_occ={n_occ})", scf)
    z = torch.linalg.solve_triangular(
        torch.linalg.cholesky(s).T, torch.eye(n, dtype=torch.float64,
                                              device=dev), upper=True)
    _, v = torch.linalg.eigh(z.T @ f @ z)
    c = v[:, :n_occ]
    want = z @ (c @ c.T) @ z.T
    got = torch.from_numpy(dd).to(dev, torch.float64)
    d_err = float((got - want).abs().max())
    close = bool(torch.allclose(got, want, atol=5e-3, rtol=5e-3))
    rec.update(n=n, sp2_iterations=srep.sp2_iterations,
               idempotency=srep.idempotency, tol=sp2_tol,
               occupation=srep.occupation, converged=srep.converged,
               replay_tasks=srep.replay_tasks,
               recompile_hits=srep.recompile_hits,
               recompile_misses=srep.recompile_misses,
               factor_residual=srep.factor.residual, max_abs_err=d_err)
    log(f"    SP2 iterations {srep.sp2_iterations} idempotency "
        f"{srep.idempotency:.6g} (tol {sp2_tol:.6g}) occupation "
        f"{srep.occupation:.9g} replay_tasks {srep.replay_tasks} "
        f"recompiles {srep.recompile_hits} hits / {srep.recompile_misses} "
        f"misses; D max |err| {d_err:.6g} against float64 eigh on the card")
    if not (srep.converged and abs(srep.occupation - n_occ) <= 1e-3
            and srep.replay_tasks == 0 and close):
        raise AssertionError(f"scf density: {rec}")
    out["scf"] = rec
    log(f"    card: {gpu_name_and_limit()}")
    return out


# ---------------------------------------------------------------------------
# phase serve: plan serving on the card
# ---------------------------------------------------------------------------

#: serve sizes: n, element half-bandwidth of the multiply operands, leaf_n
#: (bs is BS); pooled sessions; requests a pass; max_inflight of the
#: measured passes; SP2 iterations
SERVE_N, SERVE_HB, SERVE_LEAF_N = 4096, 128, 1024
SERVE_SESSIONS, SERVE_REQUESTS = 4, 32
SERVE_INFLIGHT = (1, 2, 4, 8)
SERVE_SP2_ITERS = 8
#: the reference's float32 tolerances at n = 64 (relative Frobenius):
#: its serving tests' 1e-4 for products, 1e-3 for SP2 iterates; each is
#: scaled by sqrt(n / 64) at SERVE_N (PERF.md §4)
SERVE_TOL = {"multiply": 1e-4, "congruence": 1e-4, "sp2": 1e-3}
TRACE_DIR = ROOT / "build" / "traces"


def device_idle(torch, fn, name: str) -> tuple:
    """Run ``fn()`` under ``torch.profiler`` with CUDA activity only (no
    CPU op is recorded, so the host, which sets the pace here, is slowed
    less) and return ``(fn(), idle)``.  After a session every kernel
    launch of the process costs the host more (CUPTI stays attached), so
    a timed run of many launches must come before the first session.  A
    one-element add on the card opens and closes the window: the device
    is idle at both, so they run as the host reaches them.  ``idle`` is
    one minus the union of the CUDA kernel, memcpy and memset intervals
    over the window: the device's idle share of that run."""
    from torch.profiler import ProfilerActivity, profile
    device = ("kernel", "gpu_memcpy", "gpu_memset")
    mark = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mark.add_(1)
        out = fn()
        torch.cuda.synchronize()
        mark.add_(1)
        torch.cuda.synchronize()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{name}.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in device]
    path.unlink()
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events)
    kinds = {c: sum(e["cat"] == c for e in events) for c in device}
    if kinds["kernel"] < 3:
        raise AssertionError(f"{name}: the profiler trace holds {kinds}; "
                             f"no idle share")
    t0, t1 = spans[0][0], max(b for _, b in spans)
    busy, end = 0.0, t0
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return out, {"idle_share": 1.0 - busy / (t1 - t0),
                 "window_s": (t1 - t0) / 1e6, "device_busy_s": busy / 1e6,
                 "device_events": kinds}


def serve_operands(torch, n=SERVE_N) -> dict:
    """The registered matrices, dense float64: M0..M2 banded (element
    half-bandwidth SERVE_HB, seeded hashed values as in phase 3); S and F
    from the solvers phase's tables at n; Z, S's inverse Cholesky factor
    (float64 on the card, upper, ZᵀSZ = I) with every BS x BS block of
    Frobenius norm below 1e-7 dropped; X, the SP2 start from F scaled by
    its Gershgorin bounds, (hi I - F) / (hi - lo)."""
    from repro_torch.core.patterns import banded_pairs
    rows, cols = banded_pairs(n, SERVE_HB)
    mats = {}
    for i in range(3):
        a = np.zeros((n, n))
        a[rows, cols] = hashed_values(i + 1)(rows, cols)
        mats[f"M{i}"] = a
    s = table_dense(torch, overlap_table(n, BAND_W, 0), n, "cuda")
    f = table_dense(torch, fock_table(n, BAND_W, 0), n, "cuda")
    z = torch.linalg.solve_triangular(
        torch.linalg.cholesky(s), torch.eye(n, dtype=torch.float64,
                                            device="cuda"), upper=False).T
    g = n // BS
    norms = z.reshape(g, BS, g, BS).pow(2).sum((1, 3)).sqrt()
    z = z * (norms >= 1e-7).repeat_interleave(BS, 0).repeat_interleave(BS, 1)
    mats["S"], mats["F"], mats["Z"] = (t.cpu().numpy() for t in (s, f, z))
    fa = mats["F"]
    r = np.abs(fa).sum(1) - np.abs(np.diag(fa))
    lo, hi = (np.diag(fa) - r).min(), (np.diag(fa) + r).max()
    mats["X"] = (hi * np.eye(n) - fa) / (hi - lo)
    return mats


def serve_float64(torch, mats, req, ne):
    """The float64 result of a request on the card, and for SP2 the least
    distance of a trace from ``ne`` over the iterations (the branch
    margin)."""
    dev = {k: torch.from_numpy(mats[k]).cuda()
           for k in {req.a, req.b, req.x0} - {""}}
    if req.kind == "multiply":
        return dev[req.a] @ dev[req.b], None
    if req.kind == "congruence":
        z = dev[req.a]
        return z.T @ dev[req.b] @ z, None
    x, margin = dev[req.x0], float("inf")
    for _ in range(req.iters):
        tr = float(torch.trace(x))
        margin = min(margin, abs(tr - ne))
        x2 = x @ x
        x = x2 if tr > ne else 2 * x - x2
    return x, margin


def serve_check(torch, name, got, want, tol, n) -> float:
    """||got - want||_F / ||want||_F within tol sqrt(n / 64)."""
    import math
    g = torch.from_numpy(got).cuda()
    err = float(torch.linalg.norm(g - want) / torch.linalg.norm(want))
    if not err <= tol * math.sqrt(n / 64):
        raise AssertionError(f"serve {name}: relative Frobenius error {err} "
                             f"> {tol} sqrt(n/64)")
    return err


def wave_marks(srv) -> dict:
    """The waves a server has run: the coalescer's dispatches, and the
    waves an engine flushed on its own (a rebind flushes the pending work
    that reads the rebound input), which its log keeps without
    ``coalesced``."""
    own = sum(1 for s in srv.sessions for w in s.graph.engine._waves
              if "coalesced" not in w)
    return {"coalescer": len(srv.coalescer.waves), "own": own}


def serve_pass(torch, ops, launches, srv, reqs, name) -> tuple:
    """One measured pass: counts zeroed just before, read just after; the
    pass under a :class:`StepClock` (the kernel's CUDA-event time) inside
    a profiler window (the device's idle share)."""
    tasks0, cold0 = srv.task_count(), srv.counters["cold_compiles"]
    c0, co0 = srv.cache.counters(), srv.coalescer.counters()
    marks = wave_marks(srv)
    reset_counts()

    def run():
        with StepClock(torch, ops) as clock:
            t0 = time.perf_counter()
            tickets = [srv.submit(r) for r in reqs]
            srv.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return clock, tickets, wall

    (clock, tickets, wall), idle = device_idle(torch, run, name)
    rec = clock.summary(launches)
    bad = [t.error for t in tickets if not t.done]
    if bad:
        raise AssertionError(f"serve {name}: failed requests {bad}")
    c, co = srv.cache.counters(), srv.coalescer.counters()
    hits, misses = c["hits"] - c0["hits"], c["misses"] - c0["misses"]
    lat = np.array([t.latency_s for t in tickets]) * 1e3
    after = wave_marks(srv)
    own = after["own"] - marks["own"]
    waves = own + after["coalescer"] - marks["coalescer"]
    rec.update(
        requests=len(reqs), pass_s=wall, requests_per_s=len(reqs) / wall,
        p50_ms=float(np.percentile(lat, 50)),
        p95_ms=float(np.percentile(lat, 95)),
        p99_ms=float(np.percentile(lat, 99)),
        hit_rate=hits / max(hits + misses, 1),
        new_tasks=srv.task_count() - tasks0,
        cold_compiles=srv.counters["cold_compiles"] - cold0,
        merged_waves=co["merged_waves"] - co0["merged_waves"],
        solo_waves=co["solo_waves"] - co0["solo_waves"],
        own_waves=own, waves=waves,
        **idle)
    if rec["launches"]["bsmm_pairs"] != waves or any(
            rec["launches"][k] for k in rec["launches"] if k != "bsmm_pairs"):
        raise AssertionError(f"serve {name}: launches {rec['launches']} "
                             f"against {waves} serving waves")
    return tickets, rec


def serve_phase(torch, ops, launches) -> dict:
    """``repro_torch.serve.PlanServer()`` on the card: a stream of
    SERVE_REQUESTS multiplies over three registered banded matrices, one
    warmup pass, then a measured pass at each max_inflight of
    SERVE_INFLIGHT; then two congruences and one SP2 request on a
    ``prewarm=True`` server; every result held bitwise against the same
    request served alone on the card and within the scaled float32 rule
    of a float64 product on the card."""
    from repro_torch.serve import PlanServer, Request
    n = SERVE_N
    out = {"n": n, "leaf_n": SERVE_LEAF_N, "bs": BS,
           "sessions": SERVE_SESSIONS, "requests": SERVE_REQUESTS}
    t0 = time.perf_counter()
    mats = serve_operands(torch, n)
    out["operands_s"] = time.perf_counter() - t0
    names = ["M0", "M1", "M2"]
    stream = [Request.multiply(names[i % 3], names[(i + 1) % 3])
              for i in range(SERVE_REQUESTS)]
    ne = n / 4
    mixed = [Request.congruence("Z", "F"), Request.congruence("Z", "S"),
             Request.sp2("X", ne=ne, iters=SERVE_SP2_ITERS)]

    # the serial reference: each distinct request served alone on the card
    t0 = time.perf_counter()
    alone = PlanServer(n_sessions=1, max_inflight=1, leaf_n=SERVE_LEAF_N,
                       bs=BS)
    for k, a in mats.items():
        alone.register(k, a)
    serial, errs = {}, {}
    for r in stream[:3] + mixed:
        t = alone.submit(r)
        alone.drain()
        if not t.done:
            raise AssertionError(f"serve alone {r}: {t.error}")
        want, margin = serve_float64(torch, mats, r, ne)
        if margin is not None and not margin > 0.05:
            raise AssertionError(f"serve sp2: a trace within {margin} of "
                                 f"ne; the float32 branches are undecided")
        key = f"{r.kind}({r.a or r.x0},{r.b})"
        errs[key] = serve_check(torch, key, t.result, want,
                                SERVE_TOL[r.kind], n)
        serial[r] = t.result
        del want
    del alone
    out["alone_s"] = time.perf_counter() - t0
    out["float64_rel_err"] = errs
    log(f"  alone: {out['alone_s']:.3f} s; relative Frobenius errors "
        f"against float64 on the card {json.dumps(errs)}")

    def same_as_alone(tickets, what):
        for t in tickets:
            if not np.array_equal(t.result, serial[t.request]):
                raise AssertionError(f"serve {what}: {t.request} differs "
                                     f"from the same request served alone")

    t0 = time.perf_counter()
    srv = PlanServer(n_sessions=SERVE_SESSIONS,
                     max_inflight=max(SERVE_INFLIGHT),
                     max_queue=SERVE_REQUESTS, leaf_n=SERVE_LEAF_N, bs=BS)
    if any(s.graph.engine.device.type != "cuda" for s in srv.sessions):
        raise AssertionError("PlanServer() did not serve on the card")
    for k in names:
        srv.register(k, mats[k])
    out["register_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for r in stream:
        srv.submit(r)
    srv.drain()
    out["warmup_s"] = time.perf_counter() - t0
    out["warm_tasks"] = srv.task_count()
    log(f"  server: register {out['register_s']:.3f} s, warmup pass "
        f"(max_inflight {max(SERVE_INFLIGHT)}) {out['warmup_s']:.3f} s, "
        f"{out['warm_tasks']} tasks")
    passes = {}
    for mi in SERVE_INFLIGHT:
        srv.config.max_inflight = mi
        tickets, rec = serve_pass(torch, ops, launches, srv, stream,
                                  f"serve_mi{mi}")
        same_as_alone(tickets, f"max_inflight={mi}")
        del tickets
        if not (rec["hit_rate"] == 1.0 and rec["new_tasks"] == 0
                and rec["cold_compiles"] == 0):
            raise AssertionError(f"serve max_inflight={mi}: not warm {rec}")
        if mi >= 2 and rec["merged_waves"] <= 0:
            raise AssertionError(f"serve max_inflight={mi}: no merged wave")
        passes[mi] = rec
        log(f"  max_inflight={mi}: {rec['requests_per_s']:.3f} req/s "
            f"p50={rec['p50_ms']:.1f} p95={rec['p95_ms']:.1f} "
            f"p99={rec['p99_ms']:.1f} ms; waves merged "
            f"{rec['merged_waves']} solo {rec['solo_waves']} own "
            f"{rec['own_waves']}; bsmm_pairs launches "
            f"{rec['launches']['bsmm_pairs']} {rec['bsmm_pairs_designs']}; "
            f"kernel_ms={rec['kernel_ms']:.3f} kernel_share="
            f"{rec['kernel_share']:.5f} idle_share={rec['idle_share']:.4f} "
            f"(window {rec['window_s']:.3f} s, device busy "
            f"{rec['device_busy_s']:.4f} s, {rec['device_events']}); "
            f"dense round trips (host s) "
            f"{json.dumps(rec['dense_round_trip_s'])}")
    out["passes"] = passes
    del srv

    # the mixed requests on a prewarmed server: SP2 meets warm replicas
    t0 = time.perf_counter()
    pw = PlanServer(n_sessions=SERVE_SESSIONS, max_inflight=4,
                    leaf_n=SERVE_LEAF_N, bs=BS, prewarm=True)
    for k in ("Z", "S", "F", "X"):
        pw.register(k, mats[k])
    out["prewarm_s"] = time.perf_counter() - t0
    tickets, rec = serve_pass(torch, ops, launches, pw, mixed, "serve_mixed")
    same_as_alone(tickets, "mixed")
    sp2 = tickets[-1]
    rec.update(sp2_units=len(sp2.replay_s), sp2_cache_misses=sp2.cache_misses,
               sp2_compile_s=sp2.compile_s,
               recompiled=sum(len(p._recompiled) for s in pw.sessions
                              for p in s._plans.values()))
    if not (sp2.cache_misses == 0 and sp2.compile_s == 0.0
            and rec["cold_compiles"] <= 2):
        raise AssertionError(f"serve mixed: SP2 missed its prewarmed "
                             f"replicas {rec}")
    out["mixed"] = rec
    log(f"  mixed (prewarm {out['prewarm_s']:.3f} s): "
        f"{rec['pass_s']:.3f} s, latencies "
        f"{[round(t.latency_s, 3) for t in tickets]} s; SP2 {rec['sp2_units']}"
        f" units, cache misses {rec['sp2_cache_misses']}, cold compiles "
        f"{rec['cold_compiles']} (the congruence shape), recompiled "
        f"successors {rec['recompiled']}, new tasks {rec['new_tasks']}; "
        f"waves merged {rec['merged_waves']} solo {rec['solo_waves']} own "
        f"{rec['own_waves']}; launches {rec['launches']['bsmm_pairs']} "
        f"{rec['bsmm_pairs_designs']}; kernel_share "
        f"{rec['kernel_share']:.5f} idle_share {rec['idle_share']:.4f}")
    out["launches"] = {k: sum(p["launches"][k] for p in
                              list(passes.values()) + [rec])
                       for k in launches}
    log(f"    card: {gpu_name_and_limit()}")
    return out


# ---------------------------------------------------------------------------
# phase lm: the LM substrate at full width
# ---------------------------------------------------------------------------

LM_ARCH = "h2o_danube3_4b"
#: prefill (batch, tokens): prefill_32k with the batch cut from 32 to 1
LM_PREFILL = (1, 32768)
#: serve (batch, prompt, gen): the reference lm_serve CLI's defaults
LM_SERVE = (4, 32, 16)


#: a kernel whose band is one 64-key tile short must fail the check
SHORT_BY = 64


def plain32(ref, q, k, v, window, causal):
    """The plain version's float32 result, before its cast to q's type."""
    return ref.banded_attention_ref(q.float(), k.float(), v.float(), window,
                                    causal=causal)


def check_attention_small(torch, ops, ref) -> float:
    """The attention kernel against its plain version at small shapes, k
    and v with as many heads as q or fewer, each call on the design its
    inputs select (bfloat16 with D % 8 == 0: wgmma; else fma); returns the
    worst error."""
    from repro_torch.kernels import block_attention as kba
    rng = np.random.default_rng(1)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for h, h_kv, s, d, window, block in (
                    (4, 4, 512, 120, 128, 64), (3, 3, 96, 16, 32, 32),
                    (2, 2, 160, 160, 64, 32), (8, 2, 384, 120, 128, 64),
                    (4, 1, 256, 128, 64, 64)):
                q = torch.tensor(rng.standard_normal((h, s, d)), dtype=dtype,
                                 device="cuda")
                k, v = (torch.tensor(rng.standard_normal((h_kv, s, d)),
                                     dtype=dtype, device="cuda")
                        for _ in range(2))
                design = kba.design_for(q, k, v)
                before = variant_counts()["block_attention"][design]
                got = ops.banded_attention(q, k, v, window=window,
                                           block_q=block, block_kv=block,
                                           causal=causal)
                torch.cuda.synchronize()
                if variant_counts()["block_attention"][design] != before + 1:
                    raise AssertionError(f"banded_attention {dtype} D={d} did "
                                         f"not launch the {design} design")
                err = check_elementwise(
                    torch, f"banded_attention {(h, h_kv, s, d)} "
                    f"window={window} causal={causal} {dtype}", got,
                    plain32(ref, q, k, v, window, causal), dtype)
                worst = max(worst, err)
                log(f"  banded_attention H={h} H_kv={h_kv} S={s:4d} D={d:3d} "
                    f"window={window:3d} causal={causal!s:5s} "
                    f"{str(dtype):14s} {design:5s} max_abs_err={err:.3g}")
    return worst


def band_pairs(s: int, window: int, causal: bool) -> int:
    """(query, key) pairs inside the band of an S x S score matrix."""
    i = np.arange(s, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0)
    hi = i if causal else np.minimum(i + window - 1, s - 1)
    return int((hi - lo + 1).sum())


def time_attention(torch, ref, q, k, v, window, causal) -> dict:
    """The kernel on layer 0's real q, k, v: held against its plain
    version head by head (so that one head's S x S scores fit), then
    timed beside its bound, the plain version (all heads, head by head)
    and ``scaled_dot_product_attention`` with a band mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import block_attention as kba

    h, s, d = q.shape
    kern = lambda: kba.banded_attention(q, k, v, window=window,  # noqa: E731
                                        causal=causal)
    out = kern()
    g = h // k.shape[0]                 # query heads a kv head
    err = 0.0
    for i in range(h):
        j = i // g
        want32 = plain32(ref, q[i:i + 1], k[j:j + 1], v[j:j + 1], window,
                         causal)
        err = max(err, check_elementwise(
            torch, f"banded_attention on layer 0, head {i}", out[i:i + 1],
            want32, q.dtype))
        if i == 0:
            # the check's power: the plain version with the band one kv
            # tile short, rounded like the kernel, must miss it
            short = ref.banded_attention_ref(
                q[:1], k[:1], v[:1], window - SHORT_BY, causal=causal)
            log(f"    the band {SHORT_BY} keys short fails the check, as it "
                f"must: " + must_fail(torch, "band one tile short", short,
                                      want32))
            del short
        del want32
    del out

    def plain():
        for i in range(h):
            ref.banded_attention_ref(q[i:i + 1], k[i // g:i // g + 1],
                                     v[i // g:i // g + 1], window,
                                     causal=causal)

    pairs = band_pairs(s, window, causal)
    flops = 4.0 * d * pairs * h                 # q k^T and p v
    # q and k, v read once, o written once
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    from repro_torch.launch.roofline import BF16_FLOPS, FP32_FLOPS
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    res = {"ms": cuda_ms(torch, kern, reps=5, warmup=1),
           "plain_ms": cuda_ms(torch, plain, reps=1, warmup=0),
           **bound_ms(n_bytes, flops, peak), "max_abs_err": err,
           "bytes": n_bytes, "flops": flops, "band_pairs_per_head": pairs,
           "design": kba.design_for(q, k, v),
           "shape": {"heads": h, "kv_heads": int(k.shape[0]), "seq": s,
                     "head_dim": d, "window": window, "causal": causal,
                     "dtype": str(q.dtype)}}
    res.update(rates(res))
    # the yardstick at the largest S that fits, down to S / 8, on k and v
    # copied over each group beforehand (outside the timing, as for the
    # pre-gathered pairs of torch.bmm); the kernels row carries it only
    # when it ran at the kernel's S
    res["library_ms"] = res["library_seq"] = res["library_ms_at_seq"] = None
    ke, ve = (t.repeat_interleave(g, dim=0) for t in (k, v))
    n = s
    while n >= s // 8:
        try:
            mask = ref.band_mask(n, window, causal, device=q.device)
            qs, ks, vs = (t[None, :, :n] for t in (q, ke, ve))
            res["library_ms_at_seq"] = cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask), reps=3, warmup=1)
            res["library_seq"] = n
            if n == s:
                res["library_ms"] = res["library_ms_at_seq"]
            break
        except RuntimeError as e:          # out of memory: halve S
            log(f"    sdpa at S={n}: {type(e).__name__}: "
                f"{str(e).splitlines()[0][:200]}")
            n //= 2
        finally:
            mask = qs = ks = vs = None
            torch.cuda.empty_cache()
    del ke, ve
    torch.cuda.empty_cache()
    return res


def lm_phase(torch, ops, ref, launches) -> dict:
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import lm_serve
    from repro_torch.models import model as M

    out = {"kernel_small_max_abs_err": check_attention_small(torch, ops,
                                                             ref)}

    # the smoke config's window-path prefill: card against CPU
    small = get_smoke_config(LM_ARCH)
    p_cpu = M.init_params(small, torch.Generator().manual_seed(0),
                          device="cpu")
    p_gpu = {k: ({n: w.cuda() for n, w in v.items()}
                 if isinstance(v, dict) else v.cuda())
             for k, v in p_cpu.items()}
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, small.vocab, (2, 64)))
    with torch.inference_mode():
        want, _ = M.forward(small, p_cpu, {"tokens": toks})
        got, _ = M.forward(small, p_gpu, {"tokens": toks.cuda()})
    err = float((got.cpu() - want).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"smoke prefill: card vs CPU max abs err {err}")
    out["smoke_prefill_card_vs_cpu_err"] = err
    log(f"  smoke prefill (S=64 > window 32): card vs CPU max abs err "
        f"{err:.3g}")

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(w.numel() for v in params.values()
                        for w in (v.values() if isinstance(v, dict) else [v]))
    b, s = LM_PREFILL
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        # warm-up (cuBLAS handles, the allocator, the kernel) at a quarter
        # of S, still on the window path, off the counted run
        M.forward(cfg, params, {"tokens": tokens[:, :s // 4]})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with Capture(ops, ("banded_attention",)) as cap:
            t0 = time.perf_counter()
            logits, _ = M.forward(cfg, params, {"tokens": tokens})
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        counts = dict(launches)
        designs = variant_counts()["block_attention"]
        if counts["block_attention"] != cfg.n_layers or \
                designs["wgmma"] != cfg.n_layers:
            raise AssertionError(
                f"prefill launched banded_attention "
                f"{counts['block_attention']} times ({designs}), not once per "
                f"layer ({cfg.n_layers}) on the wgmma design")
        if logits.shape != (b, s, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 f"not finite or of the wrong shape")
        del logits
        out["prefill"] = {"batch": b, "tokens": s, "seconds": prefill_s,
                          "tokens_per_s": b * s / prefill_s,
                          "peak_mem_gb": torch.cuda.max_memory_allocated()
                          / 1e9, "launches": counts,
                          "attention_designs": designs}
        log(f"  prefill {b} x {s}: {prefill_s:.3f} s, "
            f"{b * s / prefill_s:.1f} tokens/s, launches {counts}, "
            f"banded_attention designs {designs}")
        torch.cuda.empty_cache()

        _, (q, k, v), kw = cap.calls.pop("banded_attention")
        # k and v reach the kernel with the kv heads only, not copied over
        # each group of query heads
        if q.shape[0] != b * cfg.n_heads or k.shape[0] != b * cfg.n_kv_heads \
                or v.shape != k.shape:
            raise AssertionError(f"banded_attention got q {tuple(q.shape)}, "
                                 f"k {tuple(k.shape)}, v {tuple(v.shape)}")
        tm = time_attention(torch, ref, q, k, v, kw["window"],
                            kw["causal"])
        tm["prefill_share"] = tm["ms"] * cfg.n_layers / 1e3 / prefill_s
        out["timing"] = {"banded_attention": tm}
        del q, k, v
        log(f"    banded_attention: ms={tm['ms']:.4f} "
            f"plain_ms={tm['plain_ms']:.4f} library_ms={tm['library_ms']} "
            f"(sdpa {tm['library_ms_at_seq']} ms at S={tm['library_seq']}) "
            f"bound_ms={tm['bound_ms']:.4f} "
            f"({tm['bound_by']}; bytes {tm['bound_bytes_ms']:.4f}, "
            f"operations {tm['bound_ops_ms']:.4f}) "
            f"{tm['achieved_tflop_per_s']:.1f} TFLOP/s "
            f"share_of_bound={tm['share_of_bound']:.3f} "
            f"design={tm['design']} max_abs_err={tm['max_abs_err']:.3g} "
            f"prefill_share={tm['prefill_share']:.3f} {tm['shape']}")

    bs, plen, n_gen = LM_SERVE
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, (bs, plen)).astype(np.int32)
    lm_serve.generate(cfg, params, prompts[:, :2], 2, 4)      # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks_out = lm_serve.generate(cfg, params, prompts, n_gen, plen + n_gen)
    serve_s = time.perf_counter() - t0
    serve_counts = dict(launches)
    if toks_out.shape != (bs, n_gen) or not ((toks_out >= 0).all()
                                             and (toks_out < cfg.vocab).all()):
        raise AssertionError(f"generate gave {toks_out.shape} tokens outside "
                             f"[0, {cfg.vocab})")
    # the same decode again under the profiler: the device's idle share
    # (a run of its own, so that the profiler leaves the times above alone)
    t0 = time.perf_counter()
    again, idle = device_idle(
        torch, lambda: lm_serve.generate(cfg, params, prompts, n_gen,
                                         plen + n_gen), "decode")
    idle["traced_s"] = time.perf_counter() - t0
    # tracing a launch costs the host, which sets the decode's pace, so
    # the window is longer than the untraced decode: the device's busy
    # time over the untraced decode's seconds is the share without it
    idle["idle_share_untraced"] = 1.0 - idle["device_busy_s"] / serve_s
    if again.shape != toks_out.shape:
        raise AssertionError(f"the traced decode gave {again.shape} tokens")
    out["serve"] = {"batch": bs, "prompt": plen, "gen": n_gen,
                    "seconds": serve_s, "tokens_per_s": bs * n_gen / serve_s,
                    "steps_per_s": (plen + n_gen - 1) / serve_s,
                    "launches": serve_counts, "sample": toks_out[0].tolist(),
                    "decode_idle": idle}
    log(f"  serve batch {bs} prompt {plen} gen {n_gen}: {serve_s:.3f} s, "
        f"{bs * n_gen / serve_s:.1f} tokens/s, "
        f"{(plen + n_gen - 1) / serve_s:.1f} steps/s; traced again "
        f"({idle['traced_s']:.3f} s): device idle_share="
        f"{idle['idle_share']:.4f} (window {idle['window_s']:.3f} s, "
        f"device busy {idle['device_busy_s']:.4f} s, "
        f"{idle['device_events']}); busy over the untraced decode: "
        f"idle_share={idle['idle_share_untraced']:.4f}")
    out["launches"] = {k: counts[k] + serve_counts[k] for k in counts}
    log(f"    card: {gpu_name_and_limit()}")
    return out


# ---------------------------------------------------------------------------
# phase 4: report
# ---------------------------------------------------------------------------

#: the design of each kernel that the report's row measures (for
#: banded_attention, the one its bf16 calls take; see each csrc/ header)
DESIGN = {"bsmm_pairs": "persistent-warp-streams-cp.async-3xtf32-mma",
          "batched_gemm": "persistent-cp.async-ring-fma",
          "banded_attention": "wgmma-tma-split-p"}

#: the phase whose run gives each kernel's headline row
HEADLINE = {"bsmm_pairs": "banded", "batched_gemm": "banded_gemm",
            "banded_attention": "lm"}


def kernel_rows(phases, launches_total, worst) -> list:
    rows = []
    for name, phase in HEADLINE.items():
        tm = phases[phase]["timing"][name]
        err = max([worst[name]] + [ph["timing"][name]["max_abs_err"]
                                   for ph in phases.values()
                                   if name in ph["timing"]])
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{COUNTER[name]}.cu",
                     "replaces": REPLACES[name],
                     "launches": launches_total[COUNTER[name]],
                     "max_abs_err": err,
                     "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                     "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                     "library_ms": tm["library_ms"],
                     "share_of_bound": tm["share_of_bound"],
                     "design": DESIGN[name]})
    return rows


def ptxas_summary(text: str) -> list:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` output:
    registers, shared memory, stack and spills, and ptxas's performance
    notes (wgmma serialization and the like)."""
    import re
    lines, name, spill = [], None, ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '\w*?(bsmm_pairs_kernel|"
                      r"batched_gemm_kernel|banded_attention_kernel|"
                      r"banded_attention_wgmma)I(\w*?)EE", ln)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2) + "E")
            if "bfloat16" in m.group(2):
                args.append("bf16")
            elif m.group(2).endswith("f"):
                args.append("f32")
            name = f"{m.group(1)}<{', '.join(args)}>"
        elif "spill stores" in ln and name:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            lines.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
        elif re.search(r"\(C7\d+\)|error|warning", ln):
            sym = re.search(r"(banded_attention_wgmma)ILi(\d+)E", ln)
            lines.append(re.sub(r" (in|for) (the )?function '\w+'",
                                f" in {sym.group(1)}<{sym.group(2)}>"
                                if sym else "", ln.strip()))
    return lines


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
        log(f"  nvcc {name}:\n" + "\n".join(
            "    " + ln for ln in ptxas_summary(text)))
    for name in _build.KERNELS:
        _build.load(name)
    log(f"  build_s={time.perf_counter() - t0:.3f}")

    log("phase 2: kernels against their plain versions")
    t0 = time.perf_counter()
    worst = check_kernels(torch, ops, ref)
    log(f"  kernels_s={time.perf_counter() - t0:.3f}")

    log("phase 3: main path")
    t0 = time.perf_counter()
    kept: dict = {}
    phases = main_path(torch, ops, ref, _build.LAUNCHES, kept)
    total = {k: sum(ph["launches"][k] for ph in phases.values())
             for k in _build.KERNELS}
    for name, ph in phases.items():
        kern = "batched_gemm" if ph["kernel"] == "gemm" else "bsmm_pairs"
        if ph["launches"][kern] <= 0:
            raise AssertionError(f"{name}: {kern} was never launched")
    build_share = sum(ph["build_s"] for ph in phases.values())
    log(f"  main_s={time.perf_counter() - t0:.3f} "
        f"host_construction_s={build_share:.3f} launches={total}")

    log("phase 3b: bsmm_pairs on a bs-8 banded wave")
    bs8 = time_bs8_wave(torch, ref)
    worst["bsmm_pairs"] = max(worst["bsmm_pairs"], bs8["max_abs_err"])

    log("phase sim: simulated communication on phase 3's graphs")
    t0 = time.perf_counter()
    reset_counts()
    sim = sim_phase(kept)
    sim["launches"] = dict(_build.LAUNCHES)
    del kept
    sim["sim_s"] = time.perf_counter() - t0
    log(f"  sim_s={sim['sim_s']:.3f} launches={sim['launches']} (the "
        f"graphs were flushed in phase 3)")

    log("phase solvers: inverse factorization, chain and SCF density")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    solvers = solver_phase(torch, ops, _build.LAUNCHES)
    solvers["solvers_s"] = time.perf_counter() - t0
    total["bsmm_pairs"] += sum(st["launches"]["bsmm_pairs"]
                               for st in solvers.values()
                               if isinstance(st, dict) and "launches" in st)
    log(f"  solvers_s={solvers['solvers_s']:.3f} launches={total}")

    log("phase lm: h2o-danube3-4b at full width and depth")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    phases["lm"] = lm_phase(torch, ops, ref, _build.LAUNCHES)
    worst["banded_attention"] = phases["lm"]["kernel_small_max_abs_err"]
    total = {k: total[k] + phases["lm"]["launches"][k]
             for k in _build.KERNELS}
    log(f"  lm_s={time.perf_counter() - t0:.3f} launches={total}")

    # serve runs last but the report: a profiler session leaves a cost on
    # every later kernel launch of the process (CUPTI), which would slow
    # the host-bound decode above; lm's own traced decode comes after its
    # timed runs for the same reason
    log("phase serve: repro_torch.serve.PlanServer() on the card")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    serve = serve_phase(torch, ops, _build.LAUNCHES)
    serve["serve_s"] = time.perf_counter() - t0
    total["bsmm_pairs"] += serve["launches"]["bsmm_pairs"]
    log(f"  serve_s={serve['serve_s']:.3f} launches={total}")

    log("phase 4: report")
    rows = kernel_rows(phases, total, worst)
    elapsed = time.perf_counter() - t_start
    log(f"  smoke_s={elapsed:.3f} host_construction_share="
        f"{build_share / elapsed:.3f}")
    log("record: " + json.dumps({"card": card, "phases": phases,
                                 "bs8_wave": bs8, "sim": sim,
                                 "solvers": solvers, "serve": serve,
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
