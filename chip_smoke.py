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
             its blocks select (bs >= 16: mma, else fma).  Then the shapes
             the mesh executor gives them (bs 8 and 32, float32): one pool
             that is both A and B, a tail of 4003 padding pairs (0, 0,
             seg = cap_c), 97 unvisited slots that must come out 0, and
             ``batched_gemm`` on the 7004 gathered pairs (no multiple of 8).
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
mesh    — ``repro_torch.launch.mesh_exec.MeshEngine`` on a
             ``torch.distributed`` group (after solvers, before lm and
             serve).  (a) One rank on an NCCL group: phase 3's banded
             ``A @ B`` at half its n (32768, cut to make room for phase
             tp) under ``kernel="gemm"`` and ``"pairs"``, checked by
             phase 3's rule; no fetched or collective byte, every unique
             operand block pushed once, one launch a wave (``pairs`` on
             mma); build_s, multiply_s and the kernel's time on the wave.
             (b) 2, 4 and 8 ranks in spawned processes on a gloo group,
             each rank's kernel on ``cuda:0`` (the card is shared; gloo
             stages the shipments through the host), running
             ``benchmarks/bench_mesh_comm.py``'s mesh program (n = 128 p,
             banded_mask(n, 12) @ banded_mask(n, 7), leaf_n 32, bs 8):
             every rank's record must equal the committed
             ``BENCH_mesh_comm.json`` record exactly and C be within 1e-3
             of a @ b; at p = 4 also ``halo_spmm`` and ``demand_spmm``
             through ``bsmm_pairs`` (v2's counted bytes below v1's) and
             SpSUMMA's counted bytes (219,648 a rank).  (c) Weak scaling
             on 1, 2 and 4 such ranks: banded ``A @ B`` at n = 8192 p
             (half-bandwidth 128, leaf_n 2048, bs 32), phase 3's rule on
             rank 0; per rank the fetched, pushed and collective bytes,
             multiply_s and the kernel's time on its own wave (ranks time
             in turn).  Ranks only load the libraries phase 1 built; a
             failed rank, a timeout or a count that differs fails the
             smoke.  No multi-GPU speed is claimed: the ranks share one
             card.
train   — the training path (after mesh, before lm and its profiler).
             The backward kernel (``csrc/block_attention_bwd.cu``) against
             the plain backward (``ref.banded_attention_bwd_ref``) at hd
             16, 64, 120, 128 and 160, k and v with H or H/4 heads, causal
             and bidirectional, float32 and bfloat16, each call on the
             design its inputs select (bfloat16 with hd % 8 == 0 and hd <=
             128: the tensor-core ``wgmma`` design, else ``fma``): dq, dk
             and dv element by element by phase 2's rule, and the plain
             backward without the softmax's row term rowsum(P dP) must
             miss it.  Then the
             layer shape (32 x 8192 x 120 bf16, 8 kv heads, window 4096,
             seeded inputs): the same check one kv group at a time, the
             control on group 0, the kernel's time beside its bound (five
             products of the band at the bf16 tensor-core rate, which
             must come to about 0.98 ms), the plain backward's and
             ``scaled_dot_product_attention``'s backward with the band as
             a boolean mask (``enable_gqa=True``; a yardstick the port
             never calls), with the design and the registers and spills
             ptxas gave the backward's kernels.  (a)
             ``launch.sharding.TrainStep`` on
             ``h2o-danube3-4b`` at full width and depth, B = 1, S = 8192
             (the window path with block 1024), one repeated
             ``SyntheticLM`` batch: a warm-up step (learning rate 0 by the
             schedule's warmup), then 4 measured steps, counters zeroed
             before them: per step the seconds, tokens/s, loss, gradient
             norm, and the backward kernel's CUDA-event share; the loss
             must fall from step 1 to step 3, every gradient norm be
             finite, and each step launch ``banded_attention`` 48 times on
             ``wgmma`` (the forward and the remat recompute of 24 layers)
             and the backward 24 times on ``wgmma``;
             ``max_memory_allocated``.  (b)
             ``launch.train.main`` on the card: the smoke config at S =
             128 (window 32, so the kernels run), 30 steps, a drill failure
             at step 12: one restart and a falling loss.
families — the MoE, SSM and hybrid architectures (after train, before lm
             and every profiler session).  (a) The smoke configs of
             phi3.5-moe, mixtral-8x7b, falcon-mamba-7b and zamba2-2.7b: a
             2 x 64 prefill on the card against the CPU, logits within
             1e-4, aux within 1e-5; mixtral's (window 32) launches
             ``banded_attention`` once a layer.  (b) mixtral-8x7b and
             phi3.5-moe at full width and 16 of their 32 layers (whole,
             their bf16 weights do not fit the card), seeded: a prefill of
             1 x 8192 tokens (finite logits; mixtral, window 4096, launches
             ``banded_attention`` once a layer on ``wgmma``) with the MoE
             FFN's CUDA-event share, then ``lm_serve.generate`` at batch 4,
             prompt 32, gen 16; ``max_memory_allocated``.  (c) mixtral's
             layer 0 on 512 seeded bf16 tokens: ``moe_ffn`` on the card
             against the CPU's in float32 on the same values; the chosen
             experts agree but at near-ties (counted), the agreeing tokens'
             outputs pass ``check_moe_rows`` (2**-7 |want| + 2**-4
             rms(want): the FFN rounds to bf16 between its products), which
             the card's layer with its capacity cut (pairs dropped on the
             card only) must miss.  (d) falcon-mamba-7b and zamba2-2.7b at
             full width and depth: the same prefill and generate, with the
             chunked scans' share of the prefill; layer 0's mixer in
             float32 at S = 512 on the card against the CPU, and
             ``mamba1_step`` over 64 tokens against ``mamba1_forward`` on
             the card.  (e) ``TrainStep`` on mixtral-8x7b at full width, 2
             layers, B = 1, S = 8192: a warm-up step, then one step with a
             finite loss and gradient norm, launching ``banded_attention``
             4 times and its backward twice, all on ``wgmma``.
frontends — the audio and VLM frontends (after families, before lm and
             every profiler session).  (a) The smoke configs of
             hubert-xlarge (frames) and internvl2-2b (patches and text) on
             the driver's batch (``launch.train.train_batch``), 2 x 64
             positions: logits within 1e-4, the loss within 1e-5 relative
             and each gradient leaf within 1e-4 relative Frobenius of the
             CPU's.  (b) hubert-xlarge and (c) internvl2-2b at full width
             and depth (48 and 24 layers, bf16, seeded): a forward over 1 x
             8192 positions (internvl2-2b: 256 patches + 7936 tokens) with
             finite logits, internvl2-2b's ``lm_serve.generate`` at batch
             4, prompt 32, gen 16, then two ``TrainStep`` steps on the
             driver's batches of steps 0 and 1 with finite losses and
             gradient norms; seconds, positions/s, tokens/s and
             ``max_memory_allocated``.  Both attend without a window (the
             plain ``chunked_attention``), so no kernel may launch.
dp      — the data-parallel ``TrainStep`` (after frontends): 2 gloo ranks
             sharing ``cuda:0`` (``launch.mesh.launch_ranks``) on the mesh
             (data 2, model 1), h2o-danube3-4b at full width and 2 layers,
             one row of 8192 tokens a rank.  Each rank's gradient pass
             launches ``banded_attention`` 4 times and its backward twice,
             on ``wgmma``; rank 0 then computes the one-device gradient of
             the whole batch itself: the averaged gradient's worst leaf
             within DP_GRAD_BOUND (2e-2 relative Frobenius, PERF.md §4),
             which rank 0's own gradient (a rank that skips the
             all-reduce) must miss.  Then one ZeRO-1 step per rank
             (``zero1=True``, the default), timed: its launches, the
             collectives' seconds and bytes, the largest difference of the
             parameters across the ranks, which must be 0, and each rank's
             moments, half of them, against the same slice of the
             one-device step's (m within DP_GRAD_BOUND, v within twice
             it); its collectives (a reduce-scatter of the gradients, an
             all-gather of the parameters) no more bytes than an
             all-reduce of the float32 gradients.  The ranks share one
             card: correctness and counts, no multi-GPU speed.
tp      — tensor parallelism (after dp): 2 gloo ranks sharing ``cuda:0``
             on the mesh (data 1, model 2), h2o-danube3-4b at full width,
             each rank holding the blocks of the spec tables.  (a)
             ``make_prefill_fn`` at full depth over 1 x 8192 tokens: 24
             ``banded_attention`` launches a rank on ``wgmma``, each on 16
             query and 4 kv heads, no gathered leaf; the logits within
             TP_LOGIT_BOUND (3e-2 relative Frobenius) of the one-device
             forward, which a run without layer 0's attention all-reduce
             must miss.  (b) ``ServeStep`` at batch 4, 16 teacher-forced
             tokens: tokens/s, each step's logits within TP_LOGIT_BOUND of
             one device's and the greedy tokens that agree.  (c) A 4-layer
             ``TrainStep`` at 1 x 8192: 8 forward and 4 backward
             ``wgmma`` launches a rank a pass, each bf16 gradient leaf's
             distance from the float32 gradient at the same weights
             within TP_BF16_GRAD_RATIO times the one-device bf16
             gradient's, one timed step whose update (parameters after
             minus before) is within TP_UPDATE_BOUND of the one-device
             step's, leaf by leaf; then the gradient pass in float32, within
             TP_GRAD_BOUND (1e-5 sqrt(8192 / 64)) of one device's, which a
             run without layer 0's attention all-reduce must miss.  Per
             rank the collectives' bytes and seconds of each part.
             Correctness and counts, no multi-GPU speed.
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
trace   — last before the report, for the same reason: one full-width
             train step of phase train (a) (a fresh state, one untraced
             warm-up step, then one step) under ``torch.profiler`` with
             CUDA activity only: the step's seconds, the device's idle
             share, and the device time of the kernels by name, the top
             ones printed, grouped into the backward's grids, the
             forward kernel, matrix products and the rest.
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
#: (the backward has no Pallas kernel: it is the gradient of the forward's,
#: which the reference takes by XLA's autodiff of layers.windowed_attention)
REPLACES = {"bsmm_pairs": "src/repro/kernels/bsmm_pairs.py:78",
            "batched_gemm": "src/repro/kernels/batched_gemm.py:52",
            "banded_attention": "src/repro/kernels/block_attention.py:102",
            "banded_attention_bwd": "src/repro/kernels/block_attention.py:102"}
#: row name -> the launch counter (and csrc/ source) of its kernel
COUNTER = {"bsmm_pairs": "bsmm_pairs", "batched_gemm": "batched_gemm",
           "banded_attention": "block_attention",
           "banded_attention_bwd": "block_attention_bwd"}

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
    for name, err in check_mesh_shapes(torch, ops, ref, rng).items():
        worst[name] = max(worst[name], err)
    return worst


def check_mesh_shapes(torch, ops, ref, rng) -> dict:
    """The shapes the mesh executor (``launch/mesh_exec.py``) gives the
    kernels: one pool that is both A and B, each rank's pair table padded
    to the busiest rank's count with pairs (0, 0, seg = cap_c) (a long
    tail of dropped pairs), output slots that no pair visits (they must
    come out zero), and ``batched_gemm`` on the gathered pairs, whose
    count is no multiple of the reference's batch tile of 8.  Float32 at
    bs 8 (``fma``) and 32 (``mma``), each against the plain version (the
    rule of :func:`check_elementwise`; with the last k-step dropped it
    must miss)."""
    from repro_torch.kernels import bsmm_pairs as kbp
    worst = {"bsmm_pairs": 0.0, "batched_gemm": 0.0}
    for bs in (8, 32):
        pool_len, cap_c, valid, pad = 700, 613, 3001, 4003
        pool = torch.tensor(rng.standard_normal((pool_len, bs, bs))
                            * bs ** -0.25, dtype=torch.float32, device="cuda")
        visited = np.sort(rng.choice(cap_c, size=cap_c - 97, replace=False))
        seg = np.concatenate([np.sort(rng.choice(visited, valid)),
                              np.full(pad, cap_c)]).astype(np.int32)
        sa = np.concatenate([rng.integers(0, pool_len, valid),
                             np.zeros(pad, np.int64)]).astype(np.int32)
        sb = np.concatenate([rng.integers(0, pool_len, valid),
                             np.zeros(pad, np.int64)]).astype(np.int32)
        sa, sb, seg = (torch.from_numpy(x).cuda() for x in (sa, sb, seg))
        design = kbp.design_for(pool)
        before = variant_counts()["bsmm_pairs"][design]
        got = ops.bsmm_pairs(pool, pool, sa, sb, seg, cap_c=cap_c)
        torch.cuda.synchronize()
        if variant_counts()["bsmm_pairs"][design] != before + 1:
            raise AssertionError(f"bsmm_pairs bs={bs} (mesh shapes) did not "
                                 f"launch the {design} design")
        want32 = ref.bsmm_pairs_ref(pool, pool, sa, sb, seg, cap_c)
        what = (f"bsmm_pairs bs={bs} mesh pool (A is B, {pad} padding "
                f"pairs, 97 unvisited slots)")
        err = check_elementwise(torch, what, got, want32, torch.float32)
        must_fail(torch, what + " with the last k-step dropped",
                  ref.bsmm_pairs_ref(pool[:, :, :-1], pool[:, :-1], sa, sb,
                                     seg, cap_c), want32)
        unvisited = np.setdiff1d(np.arange(cap_c), visited)
        if bool((got[torch.from_numpy(unvisited).cuda()] != 0).any()):
            raise AssertionError(f"{what}: unvisited slots not 0")
        worst["bsmm_pairs"] = max(worst["bsmm_pairs"], err)
        log(f"  bsmm_pairs   bs={bs:2d} mesh pool P={valid + pad} "
            f"(padding {pad}) cap_c={cap_c} unvisited=97 {design} "
            f"max_abs_err={err:.3g}")
        ga, gb = pool[sa.long()], pool[sb.long()]      # 7004 = 8 * 875 + 4
        got = ops.batched_gemm(ga, gb)
        torch.cuda.synchronize()
        want32 = ref.batched_gemm_ref(ga, gb)
        what = f"batched_gemm bs={bs} mesh gather P={ga.shape[0]}"
        err = check_elementwise(torch, what, got, want32, torch.float32)
        must_fail(torch, what + " with the last k-step dropped",
                  ref.batched_gemm_ref(ga[:, :, :-1], gb[:, :-1]), want32)
        worst["batched_gemm"] = max(worst["batched_gemm"], err)
        log(f"  batched_gemm bs={bs:2d} mesh gather P={ga.shape[0]} "
            f"(P % 8 = {ga.shape[0] % 8}) max_abs_err={err:.3g}")
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


def banded_operands(n: int, d: int):
    """Banded A and B of half-bandwidth d at n (seeded hashed values):
    ``build(sess)`` makes them in a session, ``oracle()`` as scipy CSR."""
    import scipy.sparse as sp
    from repro_torch.core.patterns import banded_pairs
    rows, cols = banded_pairs(n, d)
    va, vb = hashed_values(1), hashed_values(2)

    def build(sess):
        return (sess.from_pattern(rows, cols, n, value_fn=va),
                sess.from_pattern(rows, cols, n, value_fn=vb))

    def oracle():
        return tuple(sp.csr_matrix((v(rows, cols), (rows, cols)),
                                   shape=(n, n)) for v in (va, vb))
    return build, oracle


def main_path(torch, ops, ref, launches, keep) -> dict:
    import scipy.sparse as sp
    from repro_torch.core.patterns import (divide_space_order,
                                           overlap_pairs, particle_cloud,
                                           random_mask, values_for_mask)

    def coo(rows, cols, vals, n):
        return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))

    out = {}
    # banded: bandwidth 257 at n = 65536, ~1.7e5 block pairs in one wave
    build_banded, banded_oracle = banded_operands(*SIZES["banded"])
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


def device_idle(torch, fn, name: str, top: bool = False) -> tuple:
    """Run ``fn()`` under ``torch.profiler`` with CUDA activity only (no
    CPU op is recorded, so the host, which sets the pace here, is slowed
    less) and return ``(fn(), idle)``.  After a session every kernel
    launch of the process costs the host more (CUPTI stays attached), so
    a timed run of many launches must come before the first session.  A
    one-element add on the card opens and closes the window: the device
    is idle at both, so they run as the host reaches them.  ``idle`` is
    one minus the union of the CUDA kernel, memcpy and memset intervals
    over the window: the device's idle share of that run.  With ``top``,
    ``idle["kernels_ms"]`` holds each kernel name's summed device ms."""
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
    idle = {"idle_share": 1.0 - busy / (t1 - t0),
            "window_s": (t1 - t0) / 1e6, "device_busy_s": busy / 1e6,
            "device_events": kinds}
    if top:
        idle["kernels_ms"] = {}
        for e in events:
            if e["cat"] == "kernel":
                idle["kernels_ms"][e["name"]] = \
                    idle["kernels_ms"].get(e["name"], 0.0) + e["dur"] / 1e3
    return out, idle


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
# phase mesh: MeshEngine on a torch.distributed group
# ---------------------------------------------------------------------------

#: rank counts of part (b), the program of benchmarks/bench_mesh_comm.py
MESH_PS = (2, 4, 8)
#: (a)'s banded size: half of phase 3's n, whose host construction alone
#: took 96.7 s of the phase twice over (cut to keep the smoke under 900 s)
MESH_ONE_N = SIZES["banded"][0] // 2
#: rank counts of part (c) and its banded n per rank (weak scaling)
WEAK_PS, WEAK_N = (1, 2, 4), 8192
#: seconds a group of ranks may take before the smoke fails
RANK_TIMEOUT = 420.0


def phase_launches() -> dict:
    from repro_torch.kernels import _build
    return {"launches": dict(_build.LAUNCHES), "designs": variant_counts()}


def prebuilt_only() -> None:
    """A rank loads the kernels phase 1 built and never runs nvcc."""
    from repro_torch.kernels import _build
    missing = [k for k in _build.KERNELS if not _build._lib_path(k).exists()]
    if missing:
        raise RuntimeError(f"rank finds no built library for {missing}: "
                           f"phase 1 builds every kernel first")


def mesh_world_of_one(torch, ops, ref) -> dict:
    """(a) ``Session(engine=MeshEngine(...))`` on an NCCL group of one
    rank, at half of phase 3's banded size (MESH_ONE_N), under each
    kernel: the result by phase 3's rule, no fetched or collective byte,
    each unique operand block pushed once, the kernel launched on the
    card."""
    import tempfile
    import scipy.sparse as sp
    import torch.distributed as dist
    from repro_torch import Session
    from repro_torch.launch.mesh_exec import MeshEngine

    build, oracle = banded_operands(MESH_ONE_N, SIZES["banded"][1])
    out = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            for kernel in ("gemm", "pairs"):
                name = "batched_gemm" if kernel == "gemm" else "bsmm_pairs"
                t0 = time.perf_counter()
                sess = Session(engine=MeshEngine(kernel=kernel,
                                                 group=dist.group.WORLD),
                               leaf_n=LEAF_N, bs=BS)
                mats = build(sess)
                t_build = time.perf_counter() - t0
                reset_counts()
                t1 = time.perf_counter()
                with Capture(ops) as cap:
                    c = mats[0] @ mats[1]
                    st = sess.engine_stats()
                t_mult = time.perf_counter() - t1
                counts = phase_launches()
                if counts["launches"][name] != st["waves"] or not st["waves"]:
                    raise AssertionError(f"mesh world of one ({kernel}): "
                                         f"{counts} for {st['waves']} waves")
                if kernel == "pairs" and counts["designs"]["bsmm_pairs"][
                        "mma"] != st["waves"]:
                    raise AssertionError(f"mesh pairs not on mma: {counts}")
                unique = sum(w["unique_blocks"] for w in st["wave_log"])
                got = [st[k] for k in ("n_dev", "fetched_bytes",
                                       "collective_bytes", "pushed_bytes")]
                if got != [1, [0], [0], [unique * 4 * BS * BS]]:
                    raise AssertionError(
                        f"mesh world of one: n_dev, fetched, collective and "
                        f"pushed bytes {got}, {unique} unique blocks")
                res = check_result(sp, f"mesh {kernel}", stored_blocks(c),
                                   *oracle(), n=c.n, bs=BS, upper=c.upper,
                                   seed=7)
                _, args, kw = cap.calls[name]
                tm = time_kernel(torch, ref, name, args, kw)
                out[kernel] = {
                    "build_s": t_build, "multiply_s": t_mult,
                    "waves": st["waves"], "pairs": st["batched_pairs"],
                    "unique_blocks": unique, "c_blocks": st["c_blocks"],
                    "pushed_bytes": st["pushed_bytes"][0],
                    "kernel_wall_s": st["kernel_wall_s"], **counts, **res,
                    "timing": {name: tm}}
                log(f"  (a) world of one, NCCL, kernel={kernel}: "
                    f"build_s={t_build:.3f} multiply_s={t_mult:.3f} "
                    f"launches={counts['launches']} designs="
                    f"{counts['designs']['bsmm_pairs']} {name} "
                    f"ms={tm['ms']:.4f} bound_ms={tm['bound_ms']:.4f} "
                    f"plain_ms={tm['plain_ms']:.4f} pushed_bytes="
                    f"{st['pushed_bytes'][0]} rel_frob_err="
                    f"{res['rel_frob_err']:.3g}")
                del sess, mats, c
        finally:
            dist.destroy_process_group()
    return out


def mesh_bench_rank(rank: int, p: int) -> dict:
    """(b) one rank: benchmarks/bench_mesh_comm.py::child's mesh program
    with each rank's kernel on ``cuda:0`` (gloo stages the shipments
    through the host); at p = 4 also the halo (v1) and demand (v2)
    multiplies through ``bsmm_pairs`` and SpSUMMA's counted bytes."""
    import torch
    from repro_torch import Session
    from repro_torch.core import distributed as cdist
    from repro_torch.core import spsumma
    from repro_torch.core.patterns import (banded_mask,
                                           block_mask_from_element_mask,
                                           values_for_mask)
    from repro_torch.launch.mesh import make_spmm_mesh, make_summa_mesh
    from repro_torch.launch.mesh_exec import MeshEngine

    prebuilt_only()
    n, bs = 128 * p, 8
    a = values_for_mask(banded_mask(n, 12), seed=1)
    b = values_for_mask(banded_mask(n, 7), seed=2)
    sess = Session(engine=MeshEngine(device="cuda:0"), leaf_n=32, bs=bs)
    A, B = sess.from_dense(a), sess.from_dense(b)
    reset_counts()
    t0 = time.perf_counter()
    C = A @ B
    st = sess.engine_stats()
    out = {"multiply_s": time.perf_counter() - t0, **phase_launches()}
    if out["launches"]["batched_gemm"] != st["waves"]:
        raise AssertionError(f"rank {rank}: {out['launches']} for "
                             f"{st['waves']} waves")
    np.testing.assert_allclose(C.to_dense(), a @ b, atol=1e-3)
    out["record"] = {
        "scheme": "mesh", "p": p, "n": n,
        "max_fetched_bytes_per_dev": max(st["fetched_bytes"]),
        "sum_fetched_blocks": sum(st["fetched_blocks"]),
        "max_pushed_bytes_per_dev": max(st["pushed_bytes"]),
        "max_collective_bytes_per_dev": max(st["collective_bytes"]),
        "waves": st["waves"]}
    if p != 4:
        return out

    def shards(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(x[rank])).cuda()
                for x in arrays]

    def dense_c(cb, cr, cc, grid):
        return cdist.gather_dense(*[cdist.all_gather(None, x).cpu().numpy()
                                    for x in (cb, cr, cc)], grid, bs)

    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    ma = block_mask_from_element_mask(a32 != 0, bs)
    mb = block_mask_from_element_mask(b32 != 0, bs)
    base = cdist.plan_distribution(ma, mb, bs, p)
    dplan = cdist.plan_demand(ma, mb, bs, p)
    args = shards(*cdist.distribute_morton(a32, bs, base),
                  *cdist.distribute_morton(b32, bs, base))
    mesh = make_spmm_mesh()
    reset_counts()
    for key, fn, plan in (("halo_v1", cdist.halo_spmm, base),
                          ("demand_v2", cdist.demand_spmm, dplan)):
        comm = {}
        cb, cr, cc, _ = fn(mesh, "dev", plan, *args, use_pair_kernel=True,
                           comm=comm)
        np.testing.assert_allclose(dense_c(cb, cr, cc, plan.grid), a32 @ b32,
                                   atol=1e-3)
        out[key + "_bytes"] = comm["collective_bytes"]
    halo_launches = phase_launches()
    if halo_launches["designs"]["bsmm_pairs"]["fma"] != 2:
        raise AssertionError(f"halo and demand on rank {rank}: "
                             f"{halo_launches}")
    for k in ("bsmm_pairs", "batched_gemm"):
        out["launches"][k] += halo_launches["launches"][k]
    sp = spsumma.plan_summa(ma, ma, bs, spsumma.summa_pgrid(p))
    sh = spsumma.distribute_panels(a32, bs, sp)
    comm = {}
    cb, cr, cc, _ = spsumma.summa_spmm(make_summa_mesh(), ("pr", "pc"), sp,
                                       *shards(*sh, *sh), comm=comm)
    np.testing.assert_allclose(dense_c(cb, cr, cc, sp.grid), a32 @ a32,
                               atol=1e-3)
    out["summa_bytes"] = comm["collective_bytes"]
    return out


def mesh_weak_rank(rank: int, p: int) -> dict:
    """(c) one rank of the weak-scaling run: banded A @ B at n = WEAK_N p
    (half-bandwidth 128, leaf_n 2048, bs 32) through ``MeshEngine()`` with
    the kernel on ``cuda:0``; then each rank in turn times its kernel on
    its own wave (the ranks share the card)."""
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist
    from repro_torch import Session
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh_exec import MeshEngine

    prebuilt_only()
    n = WEAK_N * p
    build, oracle = banded_operands(n, SIZES["banded"][1])
    t0 = time.perf_counter()
    sess = Session(engine=MeshEngine(device="cuda:0"), leaf_n=LEAF_N, bs=BS)
    A, B = build(sess)
    t_build = time.perf_counter() - t0
    reset_counts()
    dist.barrier()
    t1 = time.perf_counter()
    with Capture(ops) as cap:
        C = A @ B
        st = sess.engine_stats()
    out = {"n": n, "build_s": t_build,
           "multiply_s": time.perf_counter() - t1, **phase_launches(),
           **{k: st[k] for k in ("fetched_bytes", "pushed_bytes",
                                 "collective_bytes", "waves",
                                 "batched_pairs", "padded_pairs",
                                 "kernel_wall_s")}}
    if out["launches"]["batched_gemm"] != st["waves"] or not st["waves"]:
        raise AssertionError(f"rank {rank}: {out['launches']}")
    if rank == 0:
        out.update(check_result(sp, f"mesh weak p={p}", stored_blocks(C),
                                *oracle(), n=n, bs=BS, upper=False, seed=7))
    _, args, kw = cap.calls["batched_gemm"]
    for r in range(p):
        dist.barrier()
        if r == rank:
            out["timing"] = time_kernel(torch, ref, "batched_gemm", args, kw)
    dist.barrier()
    return out


def mesh_phase(torch, ops, ref) -> dict:
    """Phase mesh: (a) world of one on NCCL, (b) the bench's program on 2,
    4 and 8 gloo ranks (exact counters), (c) weak scaling on 1, 2 and 4
    gloo ranks; launches summed over every rank."""
    from repro_torch.launch.mesh import launch_ranks
    out = {"world1": mesh_world_of_one(torch, ops, ref)}
    total = {k: sum(r["launches"][k] for r in out["world1"].values())
             for k in ("bsmm_pairs", "batched_gemm")}
    bench = json.loads((ROOT / "BENCH_mesh_comm.json").read_text())
    out["ranks"] = {}
    for p in MESH_PS:
        t0 = time.perf_counter()
        res = launch_ranks(mesh_bench_rank, p, timeout=RANK_TIMEOUT)
        (want,) = [r for r in bench["records"]
                   if r["scheme"] == "mesh" and r["p"] == p]
        for r in res:
            if r["record"] != want:
                raise AssertionError(f"mesh p={p}: {r['record']} != the "
                                     f"committed record {want}")
        for k in total:
            total[k] += sum(r["launches"][k] for r in res)
        row = {"record": res[0]["record"], "wall_s": time.perf_counter() - t0,
               "multiply_s": [r["multiply_s"] for r in res],
               "launches": [r["launches"] for r in res]}
        if p == 4:
            v1 = {r["halo_v1_bytes"] for r in res}
            v2 = {r["demand_v2_bytes"] for r in res}
            summa = [r["summa_bytes"] for r in res]
            if not max(v2) < min(v1):
                raise AssertionError(f"demand v2 bytes {v2} not below halo "
                                     f"v1 {v1}")
            if summa != [219648] * p:
                raise AssertionError(f"SpSUMMA counted bytes {summa} != "
                                     f"219648 per rank")
            row.update(halo_v1_bytes=sorted(v1), demand_v2_bytes=sorted(v2),
                       summa_bytes=summa)
        out["ranks"][p] = row
        log(f"  (b) p={p} gloo ranks on cuda:0: record {row['record']} == "
            f"the committed one; multiply_s {row['multiply_s']}; "
            + (f"halo v1 bytes {row['halo_v1_bytes']}, demand v2 "
               f"{row['demand_v2_bytes']}, SpSUMMA {summa[0]} per rank; "
               if p == 4 else "") + f"wall_s={row['wall_s']:.3f}")
    out["weak"] = {}
    for p in WEAK_PS:
        t0 = time.perf_counter()
        res = launch_ranks(mesh_weak_rank, p, timeout=RANK_TIMEOUT)
        for k in total:
            total[k] += sum(r["launches"][k] for r in res)
        st = res[0]
        row = {"n": st["n"], "wall_s": time.perf_counter() - t0,
               "max_fetched_bytes": max(st["fetched_bytes"]),
               "max_pushed_bytes": max(st["pushed_bytes"]),
               "max_collective_bytes": max(st["collective_bytes"]),
               "fetched_bytes": st["fetched_bytes"],
               "pushed_bytes": st["pushed_bytes"],
               "collective_bytes": st["collective_bytes"],
               "build_s": [r["build_s"] for r in res],
               "multiply_s": [r["multiply_s"] for r in res],
               "kernel_ms": [r["timing"]["ms"] for r in res],
               "bound_ms": [r["timing"]["bound_ms"] for r in res],
               "pairs": st["batched_pairs"], "padded_pairs": st["padded_pairs"],
               "rel_frob_err": st["rel_frob_err"],
               "max_abs_err": max(r["timing"]["max_abs_err"] for r in res)}
        out["weak"][p] = row
        log(f"  (c) weak p={p} n={row['n']}: max fetched/pushed/collective "
            f"bytes per rank {row['max_fetched_bytes']} / "
            f"{row['max_pushed_bytes']} / {row['max_collective_bytes']}; "
            f"multiply_s {[round(x, 3) for x in row['multiply_s']]}; "
            f"batched_gemm ms per rank "
            f"{[round(x, 4) for x in row['kernel_ms']]} (bound "
            f"{[round(x, 4) for x in row['bound_ms']]}); build_s "
            f"{[round(x, 2) for x in row['build_s']]}; rel_frob_err "
            f"{row['rel_frob_err']:.3g}; wall_s={row['wall_s']:.3f}")
    out["launches"] = {k: total.get(k, 0) for k in ("bsmm_pairs",
                                                    "batched_gemm",
                                                    "block_attention")}
    out["max_abs_err"] = {
        "bsmm_pairs": out["world1"]["pairs"]["timing"]["bsmm_pairs"][
            "max_abs_err"],
        "batched_gemm": max([out["world1"]["gemm"]["timing"]["batched_gemm"][
            "max_abs_err"]] + [r["max_abs_err"]
                               for r in out["weak"].values()])}
    log(f"    card: {gpu_name_and_limit()}")
    return out


# ---------------------------------------------------------------------------
# phase train: the training path at full width
# ---------------------------------------------------------------------------

#: full-width train step (batch, tokens): S > window, so every layer takes
#: the window path (block 1024) forward, in its remat recompute and back
TRAIN_SHAPE = (1, 8192)
#: measured steps of the full-width step, after one warm-up step whose
#: learning rate the schedule's warmup sets to 0
TRAIN_STEPS = 4
#: the backward kernel's layer shape: (H, H_kv, S, D, window), bf16, causal
BWD_LAYER = (32, 8, 8192, 120, 4096)
#: the smoke driver's run (launch/train.py): steps, drill step
DRIVER_RUN = (30, 12)


def plain_bwd32(ref, q, k, v, do, window, causal):
    """The plain backward's float32 result on the inputs cast to float32."""
    return ref.banded_attention_bwd_ref(q.float(), k.float(), v.float(),
                                        do.float(), window, causal=causal)


def dq_without_row_term(torch, ref, q, k, v, do, window, causal):
    """The control: dq of the plain backward with dS = P dP, the softmax's
    row term ``rowsum(P dP)`` dropped (float32)."""
    d, g = q.shape[-1], q.shape[0] // k.shape[0]
    q32, do32 = q.float(), do.float()
    ke, ve = (t.float().repeat_interleave(g, dim=0) for t in (k, v))
    scores = torch.einsum("hqd,hkd->hqk", q32, ke) / d ** 0.5
    mask = ref.band_mask(q.shape[1], window, causal, device=q.device)
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    ds = p * torch.einsum("hqd,hkd->hqk", do32, ve)
    return torch.einsum("hqk,hkd->hqd", ds, ke) / d ** 0.5


def bwd_case(torch, rng, h, h_kv, s, d, dtype):
    q, do = (torch.tensor(rng.standard_normal((h, s, d)), dtype=dtype,
                          device="cuda") for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((h_kv, s, d)), dtype=dtype,
                         device="cuda") for _ in range(2))
    return q, k, v, do


def check_attention_bwd_small(torch, ref) -> float:
    """The backward kernel against the plain backward at small shapes: hd
    16, 64, 120, 128, 160; k and v with H or H/4 heads; causal and
    bidirectional; float32 and bfloat16, each call on the design its
    inputs select.  Each of dq, dk, dv element by element
    (:func:`check_elementwise`); the control must miss on the first shape
    of each type."""
    from repro_torch.kernels import block_attention_bwd as kbb
    rng = np.random.default_rng(5)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for i, (h, h_kv, s, d, window) in enumerate((
                    (8, 2, 300, 64, 128), (4, 4, 256, 16, 64),
                    (8, 2, 200, 120, 64), (4, 4, 192, 120, 64),
                    (4, 1, 256, 128, 64), (8, 8, 130, 128, 32),
                    (6, 3, 257, 160, 192))):
                q, k, v, do = bwd_case(torch, rng, h, h_kv, s, d, dtype)
                design = kbb.design_for(q, k, v, do)
                before = variant_counts()["block_attention_bwd"][design]
                got = kbb.banded_attention_bwd(q, k, v, do, window=window,
                                               causal=causal)
                torch.cuda.synchronize()
                if variant_counts()["block_attention_bwd"][design] != \
                        before + 1:
                    raise AssertionError(f"banded_attention_bwd {dtype} "
                                         f"D={d} did not launch the {design} "
                                         f"design")
                want = plain_bwd32(ref, q, k, v, do, window, causal)
                what = (f"banded_attention_bwd {(h, h_kv, s, d)} "
                        f"window={window} causal={causal} {dtype}")
                errs = [check_elementwise(torch, f"{what} {name}", a, w,
                                          dtype)
                        for name, a, w in zip(("dq", "dk", "dv"), got, want)]
                worst = max(worst, *errs)
                log(f"  banded_attention_bwd H={h} H_kv={h_kv} S={s:4d} "
                    f"D={d:3d} window={window:3d} causal={causal!s:5s} "
                    f"{str(dtype):14s} {design:5s} max_abs_err dq/dk/dv "
                    f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}")
                if i == 0:
                    short = dq_without_row_term(torch, ref, q, k, v, do,
                                                window, causal)
                    log("    without rowsum(P dP) the check fails, as it "
                        "must: " + must_fail(
                            torch, f"{what} dq without the row term",
                            short.to(dtype), want[0]))
    return worst


def time_attention_bwd(torch, ref) -> dict:
    """The backward kernel at the layer shape (bf16, seeded inputs): held
    against the plain backward one kv group at a time, the control on
    group 0, then timed beside its bound, the plain backward (every group)
    and ``scaled_dot_product_attention``'s backward with the band as a
    boolean mask (``enable_gqa=True``, a yardstick the port never calls)."""
    import torch.nn.functional as F
    from repro_torch.kernels import block_attention_bwd as kbb
    from repro_torch.launch.roofline import BF16_FLOPS

    h, h_kv, s, d, window = BWD_LAYER
    gen = torch.Generator("cuda").manual_seed(7)
    q, do = (torch.randn((h, s, d), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((h_kv, s, d), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    kern = lambda: kbb.banded_attention_bwd(  # noqa: E731
        q, k, v, do, window=window, causal=True)
    got = kern()
    g = h // h_kv
    err = 0.0
    for j in range(h_kv):
        qs, dos = q[j * g:(j + 1) * g], do[j * g:(j + 1) * g]
        want = plain_bwd32(ref, qs, k[j:j + 1], v[j:j + 1], dos, window,
                           True)
        for name, a, w in zip(("dq", "dk", "dv"),
                              (got[0][j * g:(j + 1) * g], got[1][j:j + 1],
                               got[2][j:j + 1]), want):
            err = max(err, check_elementwise(
                torch, f"banded_attention_bwd layer shape, kv head {j} "
                f"{name}", a, w, torch.bfloat16))
        if j == 0:
            short = dq_without_row_term(torch, ref, qs, k[:1], v[:1], dos,
                                        window, True)
            log("    layer shape: without rowsum(P dP) the check fails, as "
                "it must: " + must_fail(torch, "dq without the row term",
                                        short.to(torch.bfloat16), want[0]))
            del short
        del want
    del got

    def plain():
        for j in range(h_kv):
            plain_bwd32(ref, q[j * g:(j + 1) * g], k[j:j + 1], v[j:j + 1],
                        do[j * g:(j + 1) * g], window, True)

    pairs = band_pairs(s, window, True)
    flops = 5 * 2.0 * d * pairs * h      # q k^T, do v^T, dS k, P^T do, dS^T q
    # q, do, dq and k, v, dk, dv: each read or written once
    n_bytes = (3 * q.numel() + 4 * k.numel()) * q.element_size()
    res = {"ms": cuda_ms(torch, kern, reps=3, warmup=1),
           "plain_ms": cuda_ms(torch, plain, reps=1, warmup=0),
           **bound_ms(n_bytes, flops, BF16_FLOPS), "max_abs_err": err,
           "bytes": n_bytes, "flops": flops, "band_pairs_per_head": pairs,
           "launches_per_backward": 1, "design": kbb.design_for(q, k, v, do),
           "shape": {"heads": h, "kv_heads": h_kv, "seq": s, "head_dim": d,
                     "window": window, "causal": True, "dtype": "bf16"}}
    res.update(rates(res))
    if not 0.95 <= res["bound_ms"] <= 1.0:
        raise AssertionError(f"the backward's bound at the layer shape is "
                             f"{res['bound_ms']} ms, not about 0.98")
    mask = ref.band_mask(s, window, True, device="cuda")
    qs, ks, vs = (t[None].detach().clone().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                         enable_gqa=True)
    res["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qs, ks, vs), do[None], retain_graph=True), reps=3, warmup=1)
    del out, qs, ks, vs, mask, q, k, v, do
    torch.cuda.empty_cache()
    return res


class EventSpans:
    """CUDA events around every call of the named functions of a module
    while the block runs (the counting wrappers run inside); ``ms()`` is
    the device time the calls spanned, summed."""

    def __init__(self, torch, module, names):
        self.torch, self.module = torch, module
        self._orig = {n: getattr(module, n) for n in names}
        self.events: dict = {n: [] for n in names}

    def __enter__(self):
        def wrap(name):
            orig = self._orig[name]

            def fn(*args, **kw):
                ev = [self.torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
                out = orig(*args, **kw)
                ev[1].record()
                self.events[name].append(ev)
                return out
            return fn
        for name in self._orig:
            setattr(self.module, name, wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.module, name, fn)

    def ms(self, name) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events.pop(name))


def train_state(torch) -> tuple:
    """The full-width train step of phase train (a) and its state: the
    config, seeded parameters and AdamW moments on the card, the
    ``SyntheticLM`` batch and the step function, after one warm-up step
    (learning rate 0 by the schedule's warmup), with its seconds."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.sharding import TrainStep
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw_init

    cfg = get_config(LM_ARCH)
    b, s = TRAIN_SHAPE
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    opt = adamw_init(params)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "state_gb": torch.cuda.memory_allocated() / 1e9}
    batch = {k: torch.as_tensor(x, device="cuda") for k, x in
             SyntheticLM(cfg.vocab, s, b, seed=0).batch_at(0).items()}
    shape = ShapeSpec("train_8k", "train", s, b)
    step = TrainStep(cfg, peak_lr=3e-4, warmup=1,
                     total_steps=TRAIN_STEPS + 1).step_fn(shape)
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)           # warm-up, lr 0
    torch.cuda.synchronize()
    out["warmup_s"] = time.perf_counter() - t0
    return cfg, params, opt, batch, step, m, out


def train_full_width(torch, ops, launches) -> dict:
    """(a) ``TrainStep`` on ``h2o-danube3-4b`` at full width and depth,
    B x S = TRAIN_SHAPE, one repeated ``SyntheticLM`` batch: a warm-up
    step (learning rate 0), then TRAIN_STEPS measured steps whose loss
    must fall and whose gradient norms must be finite, each launching the
    forward kernel twice a layer and the backward kernel once, all on
    the wgmma designs."""
    b, s = TRAIN_SHAPE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, opt, batch, step, m, out = train_state(torch)
    log(f"  train (a) {cfg.name} B={b} S={s}: state {out['state_gb']:.2f} "
        f"GB, warm-up step {out['warmup_s']:.3f} s, loss "
        f"{float(m['loss']):.4f}, lr {float(m['lr'])}")
    rows = []
    reset_counts()
    for i in range(TRAIN_STEPS):
        with EventSpans(torch, ops, ("_banded_bwd_kernel",
                                     "_banded_attention_kernel")) as ev:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            row = {"step": i + 1, "seconds": sec, "tokens_per_s": b * s / sec,
                   "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                   "bwd_kernel_ms": ev.ms("_banded_bwd_kernel"),
                   "fwd_kernel_ms": ev.ms("_banded_attention_kernel")}
        row["bwd_share"] = row["bwd_kernel_ms"] / 1e3 / sec
        rows.append(row)
        log(f"    step {row['step']}: {sec:.3f} s, "
            f"{row['tokens_per_s']:.1f} tokens/s, loss {row['loss']:.4f}, "
            f"grad_norm {row['grad_norm']:.4f}, lr {row['lr']:.3g}, "
            f"banded_attention_bwd {row['bwd_kernel_ms']:.1f} ms "
            f"(share {row['bwd_share']:.3f}), banded_attention "
            f"{row['fwd_kernel_ms']:.1f} ms")
    counts = dict(launches)
    out.update(steps=rows, launches=counts, designs=variant_counts(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               step_s=float(np.median([r["seconds"] for r in rows])))
    out["tokens_per_s"] = b * s / out["step_s"]
    del params, opt, m
    torch.cuda.empty_cache()
    if not all(np.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError(f"train (a): a gradient norm is not finite: "
                             f"{[r['grad_norm'] for r in rows]}")
    if not rows[2]["loss"] < rows[0]["loss"]:
        raise AssertionError(f"train (a): the loss did not fall from step 1 "
                             f"to step 3: {[r['loss'] for r in rows]}")
    want = {"block_attention": 2 * cfg.n_layers * TRAIN_STEPS,
            "block_attention_bwd": cfg.n_layers * TRAIN_STEPS}
    if any(counts[k] != n or out["designs"][k]["wgmma"] != n
           for k, n in want.items()):
        raise AssertionError(f"train (a) launched {counts} "
                             f"({out['designs']}), not {want} on wgmma")
    per_step = {k: v // TRAIN_STEPS
                for k, v in out["designs"]["block_attention_bwd"].items()}
    log(f"  train (a): median step {out['step_s']:.3f} s, "
        f"{out['tokens_per_s']:.1f} tokens/s, max_memory_allocated "
        f"{out['peak_mem_gb']:.2f} GB; launches per step: block_attention "
        f"{counts['block_attention'] // TRAIN_STEPS}, block_attention_bwd "
        f"{counts['block_attention_bwd'] // TRAIN_STEPS} (per design "
        f"{per_step})")
    return out


def train_driver(torch, launches) -> dict:
    """(b) ``launch/train.main`` on the card: the smoke config (window 32 <
    S = 128, so the kernels run), a drill failure, one restart, a falling
    loss (the driver asserts it)."""
    import contextlib
    import io
    import re
    import shutil
    from repro_torch.launch import train

    steps, drill = DRIVER_RUN
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(["--arch", "h2o-danube-3-4b", "--smoke", "--seq",
                         "128", "--batch", "2", "--steps", str(steps),
                         "--drill-fail-step", str(drill), "--ckpt-every",
                         "5", "--ckpt-dir", str(ckpt_dir)])
    wall = time.perf_counter() - t0
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    text = buf.getvalue().strip()
    log(f"  train (b): {text}")
    m = re.search(r"loss (\S+) -> (\S+) .*restarts=(\d+)", text)
    if rc != 0 or not m or int(m.group(3)) != 1:
        raise AssertionError(f"train (b): rc {rc}, output {text!r}: not one "
                             f"restart")
    counts = dict(launches)
    if counts["block_attention_bwd"] <= 0 or counts["block_attention"] <= 0:
        raise AssertionError(f"train (b) launched {counts}")
    return {"output": text, "wall_s": wall, "loss_first": float(m.group(1)),
            "loss_last": float(m.group(2)), "restarts": int(m.group(3)),
            "launches": counts}


def train_phase(torch, ops, ref, launches, ptxas) -> dict:
    """Phase train; ``ptxas`` is phase 1's summary of the backward's
    build (registers, spills and notes per kernel), logged beside its
    time."""
    out = {"kernel_small_max_abs_err": check_attention_bwd_small(torch,
                                                                  ref)}
    tm = time_attention_bwd(torch, ref)
    tm["ptxas"] = ptxas
    log(f"    banded_attention_bwd: design={tm['design']} ms={tm['ms']:.4f} "
        f"plain_ms={tm['plain_ms']:.4f} library_ms={tm['library_ms']:.4f} "
        f"(sdpa backward, band mask, enable_gqa) "
        f"bound_ms={tm['bound_ms']:.4f} ({tm['bound_by']}; bytes "
        f"{tm['bound_bytes_ms']:.4f}, operations {tm['bound_ops_ms']:.4f}) "
        f"{tm['achieved_tflop_per_s']:.1f} TFLOP/s share_of_bound="
        f"{tm['share_of_bound']:.4f} max_abs_err={tm['max_abs_err']:.3g} "
        f"{tm['shape']}")
    log("    its build (ptxas): " + ("\n      ".join([""] + ptxas) if ptxas
                                     else "built before this run"))
    out["timing"] = {"banded_attention_bwd": tm}
    out["full_width"] = train_full_width(torch, ops, launches)
    out["driver"] = train_driver(torch, launches)
    out["launches"] = {k: out["full_width"]["launches"][k]
                       + out["driver"]["launches"][k]
                       for k in out["driver"]["launches"]}
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
# phase families: the MoE, SSM and hybrid architectures at full width
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("phi3_5_moe", "mixtral_8x7b", "falcon_mamba_7b",
                "zamba2_2_7b")
#: serving depth per arch (None: the published depth).  The MoE stacks
#: serve at 16 of their 32 layers: whole, mixtral's bf16 weights are 93.1
#: GB, over the card's 80 GB, and phi3.5-moe's 83.5 GB leave no room for
#: the prefill.  falcon-mamba-7b (14.0 GB) and zamba2-2.7b (4.7 GB) fit.
FAMILY_SERVE_LAYERS = {"mixtral_8x7b": 16, "phi3_5_moe": 16,
                       "falcon_mamba_7b": None, "zamba2_2_7b": None}
#: prefill (batch, tokens): past mixtral's 4096-token window
FAMILY_PREFILL = (1, 8192)
#: tokens of the full-width MoE layer held against the CPU, and a near-tie
#: of the router (the k-th and (k+1)-th probabilities closer than this)
MOE_LAYER_TOKENS = 512
NEAR_TIE = 1e-6
#: the must-fail control's capacity factor: cap 80 for 512 tokens top-2 of
#: 8 experts, below the 128 pairs an expert gets on average
MOE_CUT_CAPACITY = 0.5
#: the full-width mamba layers held against the CPU (tokens), and the
#: tokens of mamba1_step held against mamba1_forward on the card
SSM_LAYER_S = 512
SSM_STEP_TOKENS = 64
#: the mixtral train step: layers, (batch, tokens).  A layer is 1.45e9
#: parameters; at 2 layers the bf16 weights and gradients take 12.1 GB and
#: the float32 AdamW moments 24.3 GB
FAMILY_TRAIN = (2, (1, 8192))


def to_device(tree: dict, device) -> dict:
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def families_smoke(torch, launches) -> dict:
    """(a) Each family's smoke config: a prefill of 2 x 64 tokens on the
    card against the same prefill on the CPU, logits within 1e-4 and the
    aux loss within 1e-5; mixtral's (window 32 < 64) launches
    ``banded_attention`` once a layer, the others never."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = get_smoke_config(arch)
        p_cpu = M.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        toks = torch.tensor(np.random.default_rng(2).integers(
            0, cfg.vocab, (2, 64)))
        with torch.inference_mode():
            want, want_aux = M.forward(cfg, p_cpu, {"tokens": toks})
            reset_counts()
            got, aux = M.forward(cfg, to_device(p_cpu, "cuda"),
                                 {"tokens": toks.cuda()})
            torch.cuda.synchronize()
        counts = dict(launches)
        err = float((got.cpu() - want).abs().max())
        aux_err = abs(float(aux) - float(want_aux))
        windowed = bool(cfg.swa_window) and cfg.swa_window < 64
        if not (err <= 1e-4 and aux_err <= 1e-5) or \
                counts["block_attention"] != (cfg.n_layers if windowed
                                              else 0):
            raise AssertionError(f"families (a) {arch}: card vs CPU max abs "
                                 f"err {err}, aux err {aux_err}, launches "
                                 f"{counts}")
        out[arch] = {"max_abs_err": err, "aux_err": aux_err,
                     "launches": counts}
        log(f"  (a) {arch} smoke prefill 2 x 64: card vs CPU max abs err "
            f"{err:.3g}, aux err {aux_err:.3g}, block_attention launches "
            f"{counts['block_attention']}")
    return out


def serve_family(torch, launches, arch) -> tuple:
    """(b), (d) One arch at full width (depth ``FAMILY_SERVE_LAYERS``),
    seeded weights on the card: a prefill of FAMILY_PREFILL tokens (after
    an uncounted warm-up at a quarter of them) whose logits must be
    finite, with the MoE FFN's and the scans' shares of it (CUDA events
    around ``moe_ffn_batched``, ``mamba1_scan`` and ``mamba2_scan``);
    mixtral's must launch ``banded_attention`` once a layer on ``wgmma``,
    the others never; then ``lm_serve.generate`` at LM_SERVE, every token
    in [0, vocab).  Returns the record and a copy of layer 0's weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch import lm_serve
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import ssm

    cfg = get_config(arch)
    if FAMILY_SERVE_LAYERS[arch]:
        cfg = cfg.scaled(n_layers=FAMILY_SERVE_LAYERS[arch])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    rec = {"layers": cfg.n_layers, "init_s": time.perf_counter() - t0,
           "params": sum(w.numel() for v in params.values() for w in (
               v.values() if isinstance(v, dict) else [v])),
           "state_gb": torch.cuda.memory_allocated() / 1e9}
    b, s = FAMILY_PREFILL
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device="cuda")
    windowed = bool(cfg.swa_window) and cfg.swa_window < s
    with torch.inference_mode():
        M.forward(cfg, params, {"tokens": tokens[:, :s // 4]})   # warm-up
        torch.cuda.synchronize()
        reset_counts()
        with EventSpans(torch, L, ("moe_ffn_batched",)) as moe, \
                EventSpans(torch, ssm, ("mamba1_scan", "mamba2_scan")) as sc:
            t0 = time.perf_counter()
            logits, _ = M.forward(cfg, params, {"tokens": tokens})
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        counts, designs = dict(launches), variant_counts()["block_attention"]
        if logits.shape != (b, s, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"families {arch}: prefill logits "
                                 f"{tuple(logits.shape)} not finite or of "
                                 f"the wrong shape")
        del logits
        want = cfg.n_layers if windowed else 0
        if counts["block_attention"] != want or designs["wgmma"] != want:
            raise AssertionError(f"families {arch}: the prefill launched "
                                 f"{counts} ({designs}), not {want} "
                                 f"banded_attention on wgmma")
        moe_ms = moe.ms("moe_ffn_batched")
        scan_ms = sc.ms("mamba1_scan") + sc.ms("mamba2_scan")
    rec["prefill"] = {"batch": b, "tokens": s, "seconds": prefill_s,
                      "tokens_per_s": b * s / prefill_s,
                      "moe_ms": moe_ms, "moe_share": moe_ms / 1e3 / prefill_s,
                      "scan_ms": scan_ms,
                      "scan_share": scan_ms / 1e3 / prefill_s,
                      "launches": counts, "attention_designs": designs,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  {arch} ({cfg.n_layers} layers, {rec['params'] / 1e9:.3f} B "
        f"parameters, {rec['state_gb']:.2f} GB, init {rec['init_s']:.2f} s): "
        f"prefill {b} x {s} {prefill_s:.3f} s "
        f"({b * s / prefill_s:.1f} tokens/s), moe_ffn_batched {moe_ms:.1f} ms "
        f"(share {rec['prefill']['moe_share']:.3f}), scan {scan_ms:.1f} ms "
        f"(share {rec['prefill']['scan_share']:.3f}), banded_attention "
        f"{designs}, max_memory_allocated "
        f"{rec['prefill']['peak_mem_gb']:.2f} GB")

    bs, plen, n_gen = LM_SERVE
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, (bs, plen)).astype(np.int32)
    lm_serve.generate(cfg, params, prompts[:, :2], 2, 4)      # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks_out = lm_serve.generate(cfg, params, prompts, n_gen, plen + n_gen)
    serve_s = time.perf_counter() - t0
    if toks_out.shape != (bs, n_gen) or not ((toks_out >= 0).all()
                                             and (toks_out < cfg.vocab).all()):
        raise AssertionError(f"families {arch}: generate gave "
                             f"{toks_out.shape} tokens outside "
                             f"[0, {cfg.vocab})")
    rec["serve"] = {"batch": bs, "prompt": plen, "gen": n_gen,
                    "seconds": serve_s, "tokens_per_s": bs * n_gen / serve_s,
                    "steps_per_s": (plen + n_gen - 1) / serve_s,
                    "launches": dict(launches),
                    "sample": toks_out[0].tolist()}
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"    generate batch {bs} prompt {plen} gen {n_gen}: {serve_s:.3f} s, "
        f"{bs * n_gen / serve_s:.1f} tokens/s, "
        f"{(plen + n_gen - 1) / serve_s:.1f} steps/s; max_memory_allocated "
        f"{rec['peak_mem_gb']:.2f} GB")
    first = (0, 0) if cfg.family == "hybrid" else (0,)
    layer0 = {k: w[first].clone() for k, w in params["layers"].items()}
    del params
    torch.cuda.empty_cache()
    rec["launches"] = {k: counts[k] + rec["serve"]["launches"][k]
                       for k in counts}
    return cfg, rec, layer0


def check_moe_rows(torch, what, got, want32) -> float:
    """A bf16 MoE FFN's output against the plain float32 result on the same
    bf16 values, each element: |got - want32| <= 2**-7 |want32| + 2**-4
    rms(want32).  The FFN rounds to bf16 between its products (the gate
    and up projections, silu, their product, the down projection, the
    gate weighting and the sum over k), so it cannot meet the single
    rounding of :func:`check_elementwise`'s bf16 rule: the intermediates'
    roundings, summed over the hidden units, reach 0.020-0.027 rms(want)
    in a CPU emulation (512 x 1024 x 3584, bf16 against float32); the
    output's own roundings take 2**-7 |want|.  A pair dropped on one side
    moves its token by about 4.6 rms."""
    diff = (got.float() - want32).abs()
    rms = float(want32.pow(2).mean().sqrt())
    excess = (diff - 2 ** -7 * want32.abs() - 2 ** -4 * rms).flatten()
    i = int(excess.argmax())
    if float(excess[i]) > 0:
        raise AssertionError(
            f"{what}: |got - want| {float(diff.flatten()[i]):.4g} past "
            f"2**-7 |want| + 2**-4 rms(want) (rms {rms:.4g}) at flat index "
            f"{i}; max abs err {float(diff.max()):.4g}")
    return float(diff.max())


def check_moe_layer(torch, cfg, lp) -> dict:
    """(c) One full-width MoE layer (``lp``: layer 0's weights, bf16) on
    MOE_LAYER_TOKENS seeded bf16 tokens: ``moe_ffn`` on the card against
    ``moe_ffn`` on the CPU on the same values in float32.  The experts each
    token chooses (``moe_route``) must agree except at near-ties (counted,
    logged); the outputs of agreeing tokens must pass
    :func:`check_moe_rows`, which the card's layer with its capacity cut to
    MOE_CUT_CAPACITY (pairs dropped on the card only) must miss."""
    from repro_torch.models import layers as L
    x = torch.randn((MOE_LAYER_TOKENS, cfg.d_model), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5)
                    ).to(torch.bfloat16)
    w = [lp[k] for k in ("router", "w_gate", "w_up", "w_down")]
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.moe_capacity_factor)
    with torch.inference_mode():
        got, aux = L.moe_ffn(x, *w, **kw)
        _, _, idx = L.moe_route(x, w[0], cfg.top_k)
        cut, _ = L.moe_ffn(x, *w, top_k=cfg.top_k,
                           capacity_factor=MOE_CUT_CAPACITY)
        x32, w32 = x.float().cpu(), [t.float().cpu() for t in w]
        t0 = time.perf_counter()
        want, want_aux = L.moe_ffn(x32, *w32, **kw)
        cpu_s = time.perf_counter() - t0
        probs, _, idx32 = L.moe_route(x32, w32[0], cfg.top_k)
    top = probs.topk(cfg.top_k + 1, dim=-1).values
    near = (top[:, -2] - top[:, -1]) < NEAR_TIE
    agree = (idx.sort(-1).values.cpu() == idx32.sort(-1).values).all(-1)
    if (~agree & ~near).any():
        raise AssertionError(f"families (c): the card and the CPU route "
                             f"{int((~agree & ~near).sum())} tokens to other "
                             f"experts away from a near-tie")
    what = f"moe_ffn {cfg.name} layer 0, {MOE_LAYER_TOKENS} tokens"
    err = check_moe_rows(torch, what, got.cpu()[agree], want[agree])
    try:
        check_moe_rows(torch, what + " (control)", cut.cpu()[agree],
                       want[agree])
    except AssertionError as e:
        control = str(e)
    else:
        raise AssertionError(f"{what}: its capacity cut to "
                             f"{MOE_CUT_CAPACITY} passes the check: the "
                             f"tolerance is too loose")
    out = {"tokens": MOE_LAYER_TOKENS, "max_abs_err": err,
           "near_ties": int(near.sum()), "disagreeing": int((~agree).sum()),
           "aux": float(aux), "cpu_aux": float(want_aux), "cpu_s": cpu_s,
           "control": control}
    log(f"  (c) {what}: max abs err {err:.4g} (rms "
        f"{float(want.pow(2).mean().sqrt()):.4g}), near-ties "
        f"{out['near_ties']}, tokens routed otherwise {out['disagreeing']}, "
        f"aux {out['aux']:.6f} (CPU {out['cpu_aux']:.6f}); the control "
        f"misses: {control}")
    return out


def check_ssm_layer(torch, cfg, lp) -> dict:
    """(d) One full-width mamba layer (``lp``: layer 0's weights, cast to
    float32): the mixer's forward on SSM_LAYER_S seeded tokens on the card
    against the CPU (float32 sums in other orders: the element rule of
    :func:`check_elementwise` and 1e-5 relative Frobenius).  For mamba1,
    also ``mamba1_step`` over SSM_STEP_TOKENS tokens against
    ``mamba1_forward`` on them, on the card, by the same rule."""
    from repro_torch.models import ssm
    lp = {k: w.float() for k, w in lp.items()}
    u = torch.randn((1, SSM_LAYER_S, cfg.d_model), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6))
    if cfg.mixer == "mamba1":
        fwd, kw = ssm.mamba1_forward, dict(state=cfg.ssm_state)
    else:
        fwd = ssm.mamba2_forward
        kw = dict(state=cfg.ssm_state, head_dim=cfg.ssm_head_dim)

    def held(what, got, want):
        err = check_elementwise(torch, what, got, want, torch.float32)
        rel = float((got - want).norm() / want.norm())
        if not rel <= 1e-5:
            raise AssertionError(f"{what}: relative error {rel:.3g}")
        return {"max_abs_err": err, "rel_err": rel,
                "rms": float(want.pow(2).mean().sqrt())}

    with torch.inference_mode():
        got = fwd(lp, u, **kw)
        want = fwd(to_device(lp, "cpu"), u.cpu(), **kw)
        out = {"layer": held(f"{cfg.mixer} layer 0 of {cfg.name}, S = "
                             f"{SSM_LAYER_S}", got.cpu(), want)}
        if cfg.mixer == "mamba1":
            un = u[:, :SSM_STEP_TOKENS]
            st = ssm.MambaState(
                torch.zeros((1, cfg.d_conv - 1, cfg.d_inner), device="cuda"),
                torch.zeros((1, cfg.d_inner, cfg.ssm_state), device="cuda"))
            ys = []
            for t in range(SSM_STEP_TOKENS):
                y, st = ssm.mamba1_step(lp, un[:, t], st, **kw)
                ys.append(y)
            out["step"] = held(f"mamba1_step x {SSM_STEP_TOKENS} vs "
                               f"mamba1_forward", torch.stack(ys, 1),
                               fwd(lp, un, **kw))
    log(f"  (d) {cfg.mixer} layer of {cfg.name} in float32: card vs CPU "
        f"{out['layer']}" + (f"; mamba1_step vs mamba1_forward on the card "
                             f"{out['step']}" if "step" in out else ""))
    return out


def family_train(torch, ops, launches) -> dict:
    """(e) ``TrainStep`` on mixtral-8x7b at full width, FAMILY_TRAIN's
    depth and shape, one ``SyntheticLM`` batch: a warm-up step (learning
    rate 0), then one step whose loss and gradient norm must be finite and
    which launches ``banded_attention`` twice a layer (the forward and its
    remat recompute) and its backward once a layer, all on ``wgmma``."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.sharding import TrainStep
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw_init

    layers, (b, s) = FAMILY_TRAIN
    cfg = get_config("mixtral_8x7b").scaled(n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    opt = adamw_init(params)
    torch.cuda.synchronize()
    out = {"layers": layers, "batch": b, "tokens": s,
           "state_gb": torch.cuda.memory_allocated() / 1e9}
    batch = {k: torch.as_tensor(x, device="cuda") for k, x in
             SyntheticLM(cfg.vocab, s, b, seed=0).batch_at(0).items()}
    step = TrainStep(cfg, peak_lr=3e-4, warmup=1, total_steps=3).step_fn(
        ShapeSpec("train_8k", "train", s, b))
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)           # warm-up, lr 0
    torch.cuda.synchronize()
    out["warmup_s"] = time.perf_counter() - t0
    reset_counts()
    with EventSpans(torch, ops, ("_banded_bwd_kernel",
                                 "_banded_attention_kernel")) as ev:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        out["step_s"] = time.perf_counter() - t0
        out["bwd_kernel_ms"] = ev.ms("_banded_bwd_kernel")
        out["fwd_kernel_ms"] = ev.ms("_banded_attention_kernel")
    out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               aux=float(m["aux"]), tokens_per_s=b * s / out["step_s"],
               launches=dict(launches), designs=variant_counts(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, opt, m
    torch.cuda.empty_cache()
    if not (np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])):
        raise AssertionError(f"families (e): loss {out['loss']}, grad norm "
                             f"{out['grad_norm']}")
    want = {"block_attention": 2 * layers, "block_attention_bwd": layers}
    if any(out["launches"][k] != n or out["designs"][k]["wgmma"] != n
           for k, n in want.items()):
        raise AssertionError(f"families (e) launched {out['launches']} "
                             f"({out['designs']}), not {want} on wgmma")
    log(f"  (e) {cfg.name} train step, {layers} layers, B={b} S={s}: state "
        f"{out['state_gb']:.2f} GB, warm-up {out['warmup_s']:.3f} s, step "
        f"{out['step_s']:.3f} s ({out['tokens_per_s']:.1f} tokens/s), loss "
        f"{out['loss']:.4f} (aux {out['aux']:.4f}), grad_norm "
        f"{out['grad_norm']:.4f}, banded_attention {out['fwd_kernel_ms']:.1f} "
        f"ms, its backward {out['bwd_kernel_ms']:.1f} ms, launches "
        f"{ {k: out['launches'][k] for k in want} }, max_memory_allocated "
        f"{out['peak_mem_gb']:.2f} GB")
    return out


def families_phase(torch, ops, launches) -> dict:
    """Phase families: (a) the smoke configs card against CPU; (b) the MoE
    configs served at full width with (c) mixtral's layer 0 held against
    the CPU; (d) the SSM and hybrid configs served at full width and depth
    with a mamba layer of each held against the CPU; (e) a full-width
    mixtral train step."""
    out = {"smoke": families_smoke(torch, launches), "serve": {}}
    parts = [out["smoke"][a]["launches"] for a in FAMILY_ARCHS]
    for arch in FAMILY_ARCHS:
        cfg, rec, layer0 = serve_family(torch, launches, arch)
        out["serve"][arch] = rec
        parts.append(rec["launches"])
        if arch == "mixtral_8x7b":
            out["moe_layer"] = check_moe_layer(torch, cfg, layer0)
        elif cfg.mixer != "attention":
            out[f"{cfg.mixer}_layer"] = check_ssm_layer(torch, cfg, layer0)
        del layer0
    out["train"] = family_train(torch, ops, launches)
    parts.append(out["train"]["launches"])
    out["launches"] = {k: sum(p[k] for p in parts) for k in launches}
    log(f"    card: {gpu_name_and_limit()}")
    return out


# ---------------------------------------------------------------------------
# phase frontends: the audio and VLM frontends
# ---------------------------------------------------------------------------

FRONTEND_ARCHS = ("hubert_xlarge", "internvl2_2b")
#: the smoke configs' (batch, positions) on the card against the CPU
FRONTEND_SMOKE = (2, 64)
#: full width and depth: (batch, positions) of the encoder forward, the
#: prefill and the train steps (internvl2-2b: 256 patches + 7936 tokens)
FRONTEND_SHAPE = (1, 8192)
FRONTEND_TRAIN_STEPS = 2


def frontend_grads(torch, cfg, params, batch) -> tuple:
    """(logits, loss, gradients) of ``loss_fn`` on a batch, as the train
    step takes them (a leaf the loss does not read gets zeros)."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves, tree_map
    with torch.no_grad():
        logits, _ = M.forward(cfg, params, batch)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = M.loss_fn(cfg, live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live),
                                materialize_grads=True)
    return logits, loss.detach(), grads


def frontends_smoke(torch, launches) -> dict:
    """(a) Each smoke config on the driver's batch (frames; patches and
    text) at FRONTEND_SMOKE: logits within 1e-4, the loss within 1e-5
    relative and each gradient leaf within 1e-4 relative Frobenius of the
    CPU's (float32); no kernel launches (no window)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import batch_to, train_batch
    from repro_torch.models import model as M

    b, s = FRONTEND_SMOKE
    out = {}
    for arch in FRONTEND_ARCHS:
        cfg = get_smoke_config(arch)
        p_cpu = M.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        raw = train_batch(cfg, SyntheticLM(cfg.vocab, s, b, seed=0), 0, b, s)
        want = frontend_grads(torch, cfg, p_cpu, batch_to(cfg, raw, "cpu"))
        reset_counts()
        got = frontend_grads(torch, cfg, to_device(p_cpu, "cuda"),
                             batch_to(cfg, raw, "cuda"))
        torch.cuda.synchronize()
        counts = dict(launches)
        rec = {"logits_max_abs_err": float((got[0].cpu() - want[0]).abs()
                                           .max()),
               "loss_rel_err": abs(float(got[1]) / float(want[1]) - 1),
               "grad_rel_err": max(float((g.cpu() - w).norm()
                                         / max(float(w.norm()), 1e-30))
                                   for g, w in zip(got[2], want[2])),
               "launches": counts}
        if not (rec["logits_max_abs_err"] <= 1e-4
                and rec["loss_rel_err"] <= 1e-5
                and rec["grad_rel_err"] <= 1e-4) or any(counts.values()):
            raise AssertionError(f"frontends (a) {arch}: card vs CPU {rec}")
        out[arch] = rec
        log(f"  (a) {arch} smoke {b} x {s}: card vs CPU logits max abs err "
            f"{rec['logits_max_abs_err']:.3g}, loss rel err "
            f"{rec['loss_rel_err']:.3g}, gradients rel err (worst leaf) "
            f"{rec['grad_rel_err']:.3g}; launches {counts}")
    return out


def frontend_full(torch, launches, arch) -> dict:
    """(b), (c) One frontend at full width and depth, seeded weights on
    the card: the forward over FRONTEND_SHAPE positions of the driver's
    batch (after a warm-up at 1024), finite logits; internvl2-2b also
    ``lm_serve.generate`` at LM_SERVE; then FRONTEND_TRAIN_STEPS
    ``TrainStep`` steps on the driver's batches of steps 0, 1, finite
    losses and gradient norms."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import lm_serve
    from repro_torch.launch.sharding import TrainStep
    from repro_torch.launch.train import batch_to, train_batch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw_init

    cfg = get_config(arch)
    b, s = FRONTEND_SHAPE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    rec = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "init_s": time.perf_counter() - t0,
           "params": sum(w.numel() for v in params.values() for w in (
               v.values() if isinstance(v, dict) else [v])),
           "state_gb": torch.cuda.memory_allocated() / 1e9}
    data = SyntheticLM(cfg.vocab, s, b, seed=0)

    def batch(step, seq=s, d=data):
        return batch_to(cfg, train_batch(cfg, d, step, b, seq), "cuda")

    def inputs(bt):
        return {k: v for k, v in bt.items() if k != "targets"}

    reset_counts()
    with torch.inference_mode():
        M.forward(cfg, params, inputs(batch(0, 1024, SyntheticLM(
            cfg.vocab, 1024, b, seed=0))))                      # warm-up
        fwd = inputs(batch(0))
        torch.cuda.synchronize()
        with EventSpans(torch, L, ("chunked_attention",)) as ev:
            t0 = time.perf_counter()
            logits, _ = M.forward(cfg, params, fwd)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
            attn_ms = ev.ms("chunked_attention")
        ok = logits.shape == (b, s, cfg.vocab) and \
            bool(torch.isfinite(logits).all())
        del logits, fwd
    if not ok:
        raise AssertionError(f"frontends {arch}: forward logits not finite "
                             f"or not {(b, s, cfg.vocab)}")
    rec["forward"] = {"batch": b, "positions": s, "seconds": fwd_s,
                      "positions_per_s": b * s / fwd_s,
                      "attention_ms": attn_ms,
                      "attention_share": attn_ms / 1e3 / fwd_s,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if cfg.frontend == "patches":
        rec["forward"]["patches"] = cfg.n_patches
    log(f"  {arch} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{rec['params'] / 1e9:.3f} B parameters, {rec['state_gb']:.2f} GB, "
        f"init {rec['init_s']:.2f} s): forward {b} x {s} "
        + (f"({cfg.n_patches} patches + {s - cfg.n_patches} tokens) "
           if cfg.frontend == "patches" else "frames ")
        + f"{fwd_s:.3f} s ({b * s / fwd_s:.1f} positions/s), plain "
        f"chunked_attention {attn_ms:.1f} ms (share "
        f"{rec['forward']['attention_share']:.3f}), max_memory_allocated "
        f"{rec['forward']['peak_mem_gb']:.2f} GB")

    if not cfg.is_encoder_only:
        bs, plen, n_gen = LM_SERVE
        prompts = np.random.default_rng(3).integers(
            0, cfg.vocab, (bs, plen)).astype(np.int32)
        lm_serve.generate(cfg, params, prompts[:, :2], 2, 4)     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = lm_serve.generate(cfg, params, prompts, n_gen, plen + n_gen)
        serve_s = time.perf_counter() - t0
        if toks.shape != (bs, n_gen) or not ((toks >= 0).all()
                                             and (toks < cfg.vocab).all()):
            raise AssertionError(f"frontends {arch}: generate gave "
                                 f"{toks.shape} tokens outside [0, "
                                 f"{cfg.vocab})")
        rec["serve"] = {"batch": bs, "prompt": plen, "gen": n_gen,
                        "seconds": serve_s,
                        "tokens_per_s": bs * n_gen / serve_s,
                        "sample": toks[0].tolist()}
        log(f"    generate batch {bs} prompt {plen} gen {n_gen}: "
            f"{serve_s:.3f} s, {bs * n_gen / serve_s:.1f} tokens/s")

    torch.cuda.reset_peak_memory_stats()
    opt = adamw_init(params)
    step = TrainStep(cfg, peak_lr=3e-4, warmup=1,
                     total_steps=FRONTEND_TRAIN_STEPS + 1).step_fn(
        ShapeSpec("train_8k", "train", s, b))
    rows = []
    for i in range(FRONTEND_TRAIN_STEPS):
        bt = batch(i)
        torch.cuda.synchronize()
        with EventSpans(torch, L, ("chunked_attention",)) as ev:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, bt)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            attn_ms = ev.ms("chunked_attention")
        rows.append({"step": i + 1, "seconds": sec,
                     "positions_per_s": b * s / sec,
                     "attention_fwd_ms": attn_ms,
                     "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"])})
        log(f"    train step {i + 1}: {sec:.3f} s "
            f"({b * s / sec:.1f} positions/s; chunked_attention forward "
            f"and remat recompute {attn_ms:.1f} ms), loss "
            f"{rows[-1]['loss']:.4f}, grad_norm {rows[-1]['grad_norm']:.4f}, "
            f"lr {rows[-1]['lr']:.3g}")
    rec["train"] = {"batch": b, "positions": s, "steps": rows,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    rec["launches"] = dict(launches)
    del params, opt, m
    torch.cuda.empty_cache()
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows):
        raise AssertionError(f"frontends {arch}: train steps {rows}")
    if any(rec["launches"].values()):
        raise AssertionError(f"frontends {arch}: window-free, yet launched "
                             f"{rec['launches']}")
    log(f"    train max_memory_allocated {rec['train']['peak_mem_gb']:.2f} GB")
    return rec


def frontends_phase(torch, launches) -> dict:
    """Phase frontends: (a) the smoke configs card against CPU; (b)
    hubert-xlarge and (c) internvl2-2b at full width and depth."""
    out = {"smoke": frontends_smoke(torch, launches)}
    for arch in FRONTEND_ARCHS:
        out[arch] = frontend_full(torch, launches, arch)
    out["launches"] = {k: 0 for k in launches}
    log(f"    card: {gpu_name_and_limit()}")
    return out


# ---------------------------------------------------------------------------
# phase dp: the data-parallel train step on gloo ranks
# ---------------------------------------------------------------------------

#: ranks (the mesh's data axis; model axis 1), layers of h2o-danube3-4b at
#: full width, tokens a row; one row a rank
DP_RANKS, DP_LAYERS, DP_SEQ = 2, 2, 8192
#: bound on the worst leaf's relative Frobenius error of the averaged bf16
#: gradient against the one-device gradient of the whole batch (PERF.md
#: §4): each rank's gradient, the average and the activations of an
#: 8192-row product against a 16384-row one each round to bf16 (2**-9)
DP_GRAD_BOUND = 2e-2


def _leaf_rels(got, want) -> list:
    """Each leaf's relative Frobenius error, float32 sums."""
    return [(float((g.float() - w.float()).square().sum()) /
             max(float(w.float().square().sum()), 1e-60)) ** 0.5
            for g, w in zip(got, want)]


def _rel_errs(got, want) -> tuple:
    """(worst leaf, all leaves) relative Frobenius errors, float32 sums."""
    worst, num, den = 0.0, 0.0, 0.0
    for g, w in zip(got, want):
        d2 = float((g.float() - w.float()).square().sum())
        w2 = float(w.float().square().sum())
        worst = max(worst, (d2 / max(w2, 1e-60)) ** 0.5)
        num, den = num + d2, den + w2
    return worst, (num / den) ** 0.5


def dp_rank(rank: int, p: int) -> dict:
    """One rank of phase dp: the averaged gradient of its row, held by
    rank 0 against the one-device gradient of the whole batch (and its own
    row's, the control); then one ``TrainStep`` step (ZeRO-1), timed, its
    parameters against rank 0's and its moment slices against the
    one-device step's."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.sharding import TrainStep, tree_blocks
    from repro_torch.launch.train import batch_to
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.optim.adamw import _slabs, tree_leaves

    prebuilt_only()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_device_mesh("cpu", (p, 1), mesh_dim_names=("data", "model"))
    cfg = get_config(LM_ARCH).scaled(n_layers=DP_LAYERS)
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    data = SyntheticLM(cfg.vocab, DP_SEQ, p, seed=0)
    mine = batch_to(cfg, data.batch_at(0, rank, p), "cuda")
    shape = ShapeSpec("dp", "train", DP_SEQ, p)
    dp = TrainStep(cfg, mesh, peak_lr=3e-4, warmup=1, total_steps=3)
    want = {"block_attention": 2 * DP_LAYERS,
            "block_attention_bwd": DP_LAYERS}

    def launched(what):
        counts, designs = phase_launches().values()
        if any(counts[k] != n or designs[k]["wgmma"] != n
               for k, n in want.items()):
            raise AssertionError(f"dp rank {rank} {what}: launched {counts} "
                                 f"({designs}), not {want} on wgmma")
        return counts

    out = {"rank": rank}
    reset_counts()
    loss, _, grads = dp.grads_fn(shape)(params, mine)
    torch.cuda.synchronize()
    out["grads_launches"] = launched("gradient")
    out["loss"] = float(loss)
    one = TrainStep(cfg)
    loss1, _, g1 = one.grads_fn(shape)(
        params, batch_to(cfg, data.batch_at(0), "cuda"))
    if rank == 0:
        out["loss_one_device"] = float(loss1)
        out["grad_rel_err"], out["grad_rel_err_all"] = _rel_errs(
            tree_leaves(grads), tree_leaves(g1))
        _, _, own = one.grads_fn(ShapeSpec("dp1", "train", DP_SEQ, 1))(
            params, mine)
        out["no_allreduce_rel_err"], out["no_allreduce_rel_err_all"] = \
            _rel_errs(tree_leaves(own), tree_leaves(g1))
        del own
    # the one-device step's moments, this rank's ZeRO-1 slices: AdamW's
    # first moments are (1 - b) of the clipped gradient and its square
    _, gn1 = clip_by_global_norm(g1, dp.clip_norm)
    zspecs = dp.opt_shardings().m
    m1 = [t.float() * 0.1 for t in tree_leaves(tree_blocks(g1, zspecs,
                                                           mesh))]
    v1 = [t.float().square() * 0.05 for t in tree_leaves(
        tree_blocks(g1, zspecs, mesh))]
    del grads, g1
    torch.cuda.empty_cache()
    dist.barrier()

    opt = dp.adamw_init(params)
    dp.comm_bytes, dp.comm_seconds = 0, 0.0
    reset_counts()
    dist.barrier()
    t0 = time.perf_counter()
    params, opt, m = dp.step_fn(shape)(params, opt, mine)
    torch.cuda.synchronize()
    # what an all-reduce of the float32 gradients alone would move: a
    # ring's 2 (p - 1) / p of their bytes
    ar_bytes = sum(2 * (p - 1) * 4 * t.numel() // p
                   for t in tree_leaves(params))
    out.update(step_s=time.perf_counter() - t0, comm_s=dp.comm_seconds,
               comm_bytes=dp.comm_bytes, allreduce_bytes=ar_bytes,
               step_loss=float(m["loss"]),
               grad_norm=float(m["grad_norm"]),
               step_launches=launched("step"),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    out["moment_m_rel_err"], _ = _rel_errs(tree_leaves(opt.m), m1)
    out["moment_v_rel_err"], _ = _rel_errs(tree_leaves(opt.v), v1)
    out["moment_share"] = sum(t.numel() for t in tree_leaves(opt.m)) / \
        sum(t.numel() for t in tree_leaves(params))
    del m1, v1
    diff = torch.zeros(())
    for t in tree_leaves(params):
        for (ts,) in _slabs(t):
            mine_h = ts.cpu()
            ref = mine_h.clone()
            dist.broadcast(ref, 0)
            diff = torch.maximum(diff, (mine_h.float() - ref.float()).abs()
                                 .max())
    dist.all_reduce(diff, op=dist.ReduceOp.MAX)
    out["across_ranks_max_diff"] = float(diff)
    return out


def dp_phase(torch) -> dict:
    """Phase dp: DP_RANKS gloo ranks sharing ``cuda:0`` on the mesh (data
    DP_RANKS, model 1), h2o-danube3-4b at full width and DP_LAYERS layers,
    one row of DP_SEQ tokens a rank: the averaged gradient within
    DP_GRAD_BOUND of the one-device gradient of the whole batch, which the
    rank's own gradient (no all-reduce) must miss; then one ZeRO-1 step
    whose parameters are equal on every rank and whose moments are each
    rank's half, within DP_GRAD_BOUND (m) and twice it (v, a square) of
    the same slice of the one-device step's, and whose collectives (a
    reduce-scatter of the gradients, an all-gather of the parameters)
    move no more than an all-reduce of the float32 gradients would."""
    from repro_torch.launch.mesh import launch_ranks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = launch_ranks(dp_rank, DP_RANKS, timeout=RANK_TIMEOUT)
    r0 = res[0]
    out = {"ranks": res, "wall_s": time.perf_counter() - t0,
           "bound": DP_GRAD_BOUND,
           "launches": {k: sum(r["grads_launches"][k] + r["step_launches"][k]
                               for r in res) for k in r0["step_launches"]}}
    log(f"  {DP_RANKS} gloo ranks on cuda:0, (data {DP_RANKS}, model 1), "
        f"{LM_ARCH} {DP_LAYERS} layers, {DP_RANKS} x {DP_SEQ} tokens: loss "
        f"{[round(r['loss'], 6) for r in res]} (one device "
        f"{r0['loss_one_device']:.6f}); averaged gradient rel err, worst "
        f"leaf {r0['grad_rel_err']:.3g} (all leaves "
        f"{r0['grad_rel_err_all']:.3g}), bound {DP_GRAD_BOUND}; without the "
        f"all-reduce {r0['no_allreduce_rel_err']:.3g} (all "
        f"{r0['no_allreduce_rel_err_all']:.3g})")
    log(f"    step s {[round(r['step_s'], 4) for r in res]}, collectives s "
        f"{[round(r['comm_s'], 4) for r in res]}, bytes "
        f"{[r['comm_bytes'] for r in res]} a rank (an all-reduce of the "
        f"float32 gradients {r0['allreduce_bytes']}); loss "
        f"{r0['step_loss']:.6f}, grad_norm {r0['grad_norm']:.6f}; params "
        f"max diff across ranks "
        f"{max(r['across_ranks_max_diff'] for r in res)}; ZeRO-1 moments "
        f"{[r['moment_share'] for r in res]} of the parameters a rank, "
        f"rel err against the one-device slices m "
        f"{max(r['moment_m_rel_err'] for r in res):.3g}, v "
        f"{max(r['moment_v_rel_err'] for r in res):.3g}; launches "
        f"{out['launches']}; max_memory_allocated "
        f"{[round(r['peak_mem_gb'], 2) for r in res]} GB; wall_s="
        f"{out['wall_s']:.3f} (ranks share one card: counts, no multi-GPU "
        f"speed)")
    if not r0["grad_rel_err"] <= DP_GRAD_BOUND:
        raise AssertionError(f"dp: averaged gradient rel err "
                             f"{r0['grad_rel_err']} over {DP_GRAD_BOUND}")
    if not r0["no_allreduce_rel_err"] > DP_GRAD_BOUND:
        raise AssertionError(f"dp: the control without the all-reduce "
                             f"({r0['no_allreduce_rel_err']}) meets the bound")
    if any(r["across_ranks_max_diff"] != 0.0 for r in res):
        raise AssertionError("dp: the ranks' parameters differ")
    if not all(r["moment_m_rel_err"] <= DP_GRAD_BOUND and
               r["moment_v_rel_err"] <= 2 * DP_GRAD_BOUND and
               r["moment_share"] == 1 / DP_RANKS for r in res):
        raise AssertionError(f"dp: ZeRO-1 moments {res}")
    if not all(np.isfinite(r["step_loss"]) and np.isfinite(r["grad_norm"])
               and 0 < r["comm_bytes"] <= r["allreduce_bytes"] + 64
               for r in res):
        raise AssertionError(f"dp: step records {res}")
    log(f"    card: {gpu_name_and_limit()}")
    return out


# ---------------------------------------------------------------------------
# phase tp: tensor parallelism on the model axis
# ---------------------------------------------------------------------------

#: ranks on the model axis (mesh (data 1, model TP_RANKS)); prefill tokens
#: at full depth; decode (batch, teacher-forced tokens); train step
#: (layers, tokens)
TP_RANKS, TP_PREFILL, TP_DECODE, TP_TRAIN = 2, 8192, (4, 16), (4, 8192)
#: bound on the relative Frobenius error of the prefill's and each decode
#: step's logits against one device's (PERF.md §4): 48 row-parallel
#: outputs each rounded once more to bf16 (2**-9) before their sum, a
#: random walk of sqrt(48) 2**-9 = 1.4e-2, with 2x room
TP_LOGIT_BOUND = 3e-2
#: bound on the worst gradient leaf of the sharded float32 step against
#: the one-device float32 gradient's blocks: the CPU tests' 1e-5 scaled by
#: sqrt(S / 64) (PERF.md §4).  float32 runs the fma kernels
TP_GRAD_BOUND = 1e-5 * (TP_TRAIN[1] / 64) ** 0.5
#: bound, leaf by leaf, on the sharded bf16 gradient's distance from the
#: float32 gradient at the same weights, as a multiple of the one-device
#: bf16 gradient's own distance (the wgmma kernels' path): the sharded
#: pass rounds each row-parallel partial sum to bf16 once more before it
#: is summed, which may add a few times the one-device rounding noise to
#: a leaf summed over many tokens (a norm scale); a missing all-reduce
#: or a leaf left out reads about 1 / (the one-device distance), 50-100
TP_BF16_GRAD_RATIO = 4.0
#: bound, leaf by leaf, on the sharded step's update (parameters after
#: minus before) against the one-device step's: AdamW's first update is
#: about lr sign(g), and a gradient element whose bf16 error flips its
#: sign moves by 2 lr, so a share f of flipped elements reads about
#: 2 sqrt(f); an update that is not made reads 1
TP_UPDATE_BOUND = 0.5


def _rel(torch, got, want) -> float:
    """Relative Frobenius error, float32 sums a row at a time."""
    num = den = 0.0
    for g, w in zip(got.reshape(-1, got.shape[-1]),
                    want.reshape(-1, want.shape[-1])):
        num += float((g.float() - w.float()).square().sum())
        den += float(w.float().square().sum())
    return (num / max(den, 1e-60)) ** 0.5


def drop_one_sum(tp, i: int) -> None:
    """Make the i-th later call of ``tp.sum`` (from 0) return the rank's
    partial untouched: the must-fail control.  Every rank drops the same
    call, since the layers make the same collectives in the same
    order."""
    real, calls = tp.sum, iter(range(1 << 30))
    tp.sum = lambda x: x if next(calls) == i else real(x)


def tp_rank(rank: int, p: int, small: bool = False) -> dict:
    """One rank of phase tp on the mesh (data 1, model p), h2o-danube3-4b
    at full width (``small``: its smoke config on the CPU, a rehearsal).
    (a) ``make_prefill_fn`` at full depth over 1 x TP_PREFILL tokens, its
    launches, the heads each attention call gets, the gathered leaves, its
    collectives; rank 0 holds the logits against the one-device forward,
    and those of a run that skips layer 0's attention all-reduce.  (b)
    ``ServeStep`` teacher-forced at TP_DECODE, timed; rank 0 against the
    one-device decode step by step.  (c) A TP_TRAIN[0]-layer ``TrainStep``
    (ZeRO-1; data 1, so the moments are the parameter blocks): its
    gradient pass against the one-device gradient's blocks, one timed
    step against the one-device step's parameter blocks; (d) the gradient
    pass in float32 against one device's, and the control without layer
    0's attention all-reduce."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import (ServeStep, TrainStep,
                                             make_prefill_fn,
                                             param_shardings, tree_blocks)
    from repro_torch.launch.train import batch_to
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map

    dev = "cpu" if small else "cuda"
    if not small:
        prebuilt_only()
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_device_mesh("cpu", (1, p), mesh_dim_names=("data", "model"))
    base = get_smoke_config(LM_ARCH) if small else get_config(LM_ARCH)
    n_pre = 64 if small else TP_PREFILL
    n_layers, s_train = (2, 64) if small else TP_TRAIN

    def sync():
        if not small:
            torch.cuda.synchronize()

    def params_of(cfg):
        full = M.init_params(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
        mine = tree_map(lambda t: t.clone(), tree_blocks(
            full, param_shardings(cfg, mesh), mesh))
        return full, mine

    def launched(what, want):
        counts, designs = phase_launches().values()
        if not small and any(counts[k] != n or designs[k]["wgmma"] != n
                             for k, n in want.items()):
            raise AssertionError(f"tp rank {rank} {what}: launched {counts} "
                                 f"({designs}), not {want} on wgmma")
        return counts

    def stats_of(st):
        return {"comm_bytes": st.bytes, "comm_s": st.seconds,
                "gathered": dict(st.gathered)}

    out = {"rank": rank}
    # (a) prefill at full depth
    cfg = base
    full, params = params_of(cfg)
    if rank:
        del full
    batch = batch_to(cfg, {"tokens": SyntheticLM(cfg.vocab, n_pre, 1, seed=0)
                           .batch_at(0)["tokens"]}, dev)
    prefill = make_prefill_fn(cfg, mesh)
    heads, orig = [], ops.banded_attention

    def record(q, k, v, **kw):
        heads.append((q.shape[0], k.shape[0]))
        return orig(q, k, v, **kw)
    ops.banded_attention = record
    try:
        reset_counts()
        dist.barrier()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_launches"] = launched(
            "prefill", {"block_attention": cfg.n_layers})
    finally:
        ops.banded_attention = orig
    out["prefill_heads"] = sorted(set(heads))
    out["prefill"] = stats_of(prefill.tp.stats)
    drop_one_sum(prefill.tp, 1)
    control = prefill(params, batch)
    if rank == 0:
        with torch.no_grad():
            want = M.forward(cfg, full, batch, remat=False)[0]
        out["prefill_rel_err"] = _rel(torch, logits, want)
        out["prefill_control_rel_err"] = _rel(torch, control, want)
        del want
    del logits, control
    # (b) decode, teacher-forced
    b, n_dec = (2, 8) if small else TP_DECODE
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, n_dec))).to(dev)
    ss = ServeStep(cfg, mesh, ShapeSpec("tp", "decode", n_dec, b))
    cache, step = ss.init_cache(dev), ss.step_fn()
    got = []
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    for pos in range(n_dec):
        lg, cache = step(params, toks[:, pos], cache, pos)
        got.append(lg)
    sync()
    out["decode_s"] = time.perf_counter() - t0
    out["decode_tokens_per_s"] = b * n_dec / out["decode_s"]
    out["decode"] = stats_of(ss.tp.stats)
    if rank == 0:
        cache1 = M.init_cache(cfg, b, n_dec, device=dev)
        errs, agree = [], 0
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            for pos in range(n_dec):
                want, cache1 = M.decode_step(cfg, full, toks[:, pos], cache1,
                                             pos)
                errs.append(_rel(torch, got[pos], want))
                agree += int((got[pos].argmax(-1) == want.argmax(-1)).sum())
        sync()
        out.update(decode_rel_err=max(errs), greedy_agree=agree,
                   greedy_of=b * n_dec,
                   decode_one_device_s=time.perf_counter() - t0)
        del full, cache1
    del params, cache, got
    if not small:
        torch.cuda.empty_cache()
    # (c) the train step: the gradient pass against one device's, both in
    # bf16 and held leaf by leaf against the float32 gradient at the same
    # weights; one timed step, its update against the one-device step's
    cfg = base.scaled(n_layers=n_layers)
    cfg32 = cfg.scaled(dtype="float32")
    full, params = params_of(cfg)
    batch = batch_to(cfg, SyntheticLM(cfg.vocab, s_train, 1, seed=0)
                     .batch_at(0), dev)
    shape = ShapeSpec("tp", "train", s_train, 1)
    kw = dict(peak_lr=3e-4, warmup=0, total_steps=3)
    ts = TrainStep(cfg, mesh, **kw)
    want_launch = {"block_attention": 2 * n_layers,
                   "block_attention_bwd": n_layers}
    reset_counts()
    dist.barrier()
    loss, _, grads = ts.grads_fn(shape)(params, batch)
    sync()
    out["grads_launches"] = launched("gradient", want_launch)
    out["loss"] = float(loss)
    one = TrainStep(cfg, **kw)
    loss1, _, g1 = one.grads_fn(shape)(full, batch)
    specs = ts.param_shardings()
    out["loss_one_device"] = float(loss1)
    full32 = tree_map(lambda t: t.to(torch.float32, copy=True), full)
    _, _, g32 = TrainStep(cfg32, **kw).grads_fn(shape)(full32, batch)
    g32 = tree_map(lambda t: t.clone(), tree_blocks(g32, specs, mesh))
    names = [".".join(path) for path, _ in M._leaves(g32)]
    tp_err = _leaf_rels(tree_leaves(grads), tree_leaves(g32))
    one_err = _leaf_rels(tree_leaves(tree_blocks(g1, specs, mesh)),
                         tree_leaves(g32))
    ratios = [a / max(b, 1e-30) for a, b in zip(tp_err, one_err)]
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    out.update(bf16_grad_rel_err=max(tp_err),
               bf16_grad_one_device_rel_err=max(one_err),
               bf16_grad_ratio=ratios[worst], bf16_grad_ratio_leaf=(
                   names[worst], tp_err[worst], one_err[worst]))
    del grads, g1
    if not small:
        torch.cuda.empty_cache()
    before = tree_map(lambda t: t.clone(), params)
    opt = ts.adamw_init(params)
    ts.comm_bytes, ts.comm_seconds = 0, 0.0
    reset_counts()
    dist.barrier()
    t0 = time.perf_counter()
    params, opt, m = ts.step_fn(shape)(params, opt, batch)
    sync()
    out.update(step_s=time.perf_counter() - t0, step_loss=float(m["loss"]),
               grad_norm=float(m["grad_norm"]),
               step_launches=launched("step", want_launch),
               step_comm_bytes=ts.comm_bytes, step_comm_s=ts.comm_seconds)
    p1, _, m1 = one.step_fn(shape)(full, adamw_init(full), batch)
    upd = _leaf_rels((p.float() - b.float() for p, b in zip(
        tree_leaves(params), tree_leaves(before))), (
        w.float() - b.float() for w, b in zip(
            tree_leaves(tree_blocks(p1, specs, mesh)), tree_leaves(before))))
    worst = max(range(len(upd)), key=upd.__getitem__)
    out.update(update_rel_err=upd[worst], update_rel_err_leaf=names[worst],
               grad_norm_one_device=float(m1["grad_norm"]))
    del full, params, before, opt, p1
    if not small:
        torch.cuda.empty_cache()
    # (d) the gradient pass in float32 (the fma kernels) against one
    # device's, and without layer 0's attention all-reduce (the control)
    params = tree_map(lambda t: t.clone(), tree_blocks(full32, specs, mesh))
    del full32
    _, _, grads = TrainStep(cfg32, mesh, **kw).grads_fn(shape)(params, batch)
    out["grad_rel_err"], out["grad_rel_err_all"] = _rel_errs(
        tree_leaves(grads), tree_leaves(g32))
    del grads
    ctl = TrainStep(cfg32, mesh, **kw)
    ctl._build()
    drop_one_sum(ctl.tp, 1)
    _, _, cg = ctl.grads_fn(shape)(params, batch)
    out["control_rel_err"], out["control_rel_err_all"] = _rel_errs(
        tree_leaves(cg), tree_leaves(g32))
    if not small:
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def tp_phase(torch) -> dict:
    """Phase tp: TP_RANKS gloo ranks sharing ``cuda:0`` on the mesh (data
    1, model TP_RANKS), h2o-danube3-4b at full width (``tp_rank``): the
    prefill and each decode step within TP_LOGIT_BOUND of one device,
    which the prefill without one all-reduce must miss; 24 wgmma forward
    launches a rank on 16 query and 4 kv heads and no gathered leaf; the
    train step's launches, its bf16 gradient leaves within
    TP_BF16_GRAD_RATIO of the one-device bf16 gradient's distance from
    float32, its update within TP_UPDATE_BOUND of the one-device step's,
    leaf by leaf; its float32 gradients within TP_GRAD_BOUND (the control
    must miss)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import launch_ranks
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    res = launch_ranks(tp_rank, TP_RANKS, timeout=RANK_TIMEOUT)
    r0 = res[0]
    keys = ("prefill_launches", "grads_launches", "step_launches")
    out = {"ranks": res, "wall_s": time.perf_counter() - t0,
           "bounds": {"logits": TP_LOGIT_BOUND, "grads": TP_GRAD_BOUND,
                      "bf16_grad_ratio": TP_BF16_GRAD_RATIO,
                      "update": TP_UPDATE_BOUND},
           "launches": {k: sum(r[key][k] for r in res for key in keys)
                        for k in r0["step_launches"]}}
    heads = (cfg.n_heads // TP_RANKS, cfg.n_kv_heads // TP_RANKS)
    log(f"  {TP_RANKS} gloo ranks on cuda:0, (data 1, model {TP_RANKS}), "
        f"{LM_ARCH} at full width")
    log(f"    prefill 1 x {TP_PREFILL}, {cfg.n_layers} layers: s "
        f"{[round(r['prefill_s'], 4) for r in res]}; logits rel err "
        f"{r0['prefill_rel_err']:.4g} (bound {TP_LOGIT_BOUND}), without "
        f"layer 0's attention all-reduce {r0['prefill_control_rel_err']:.4g}"
        f"; attention calls (q heads, kv heads) "
        f"{[r['prefill_heads'] for r in res]}; gathered leaves "
        f"{[r['prefill']['gathered'] for r in res]}; collectives bytes "
        f"{[r['prefill']['comm_bytes'] for r in res]}, s "
        f"{[round(r['prefill']['comm_s'], 4) for r in res]}")
    log(f"    decode batch {TP_DECODE[0]} x {TP_DECODE[1]} teacher-forced: "
        f"{[round(r['decode_tokens_per_s'], 2) for r in res]} tokens/s (one "
        f"device {TP_DECODE[0] * TP_DECODE[1] / r0['decode_one_device_s']:.2f}"
        f"); worst step rel err {r0['decode_rel_err']:.4g}; greedy tokens "
        f"agree {r0['greedy_agree']} of {r0['greedy_of']}; collectives bytes "
        f"{[r['decode']['comm_bytes'] for r in res]}, s "
        f"{[round(r['decode']['comm_s'], 4) for r in res]}")
    bad = max(res, key=lambda r: r["bf16_grad_ratio"])
    upd = max(res, key=lambda r: r["update_rel_err"])
    log(f"    train {TP_TRAIN[0]} layers, 1 x {TP_TRAIN[1]}: loss "
        f"{r0['loss']:.6f} (one device {r0['loss_one_device']:.6f}); bf16 "
        f"gradient rel err from float32 at the same weights, worst leaf "
        f"{max(r['bf16_grad_rel_err'] for r in res):.4g} (one device "
        f"{max(r['bf16_grad_one_device_rel_err'] for r in res):.4g}); worst "
        f"ratio {bad['bf16_grad_ratio']:.4g} at {bad['bf16_grad_ratio_leaf']}"
        f" (bound {TP_BF16_GRAD_RATIO}); float32 gradient rel err worst leaf "
        f"{max(r['grad_rel_err'] for r in res):.4g} (all "
        f"{max(r['grad_rel_err_all'] for r in res):.4g}), bound "
        f"{TP_GRAD_BOUND:.4g}; without layer 0's attention all-reduce "
        f"{min(r['control_rel_err'] for r in res):.4g}; step s "
        f"{[round(r['step_s'], 4) for r in res]}, collectives bytes "
        f"{[r['step_comm_bytes'] for r in res]}, s "
        f"{[round(r['step_comm_s'], 4) for r in res]}; update rel err "
        f"against one device's, worst leaf {upd['update_rel_err']:.4g} "
        f"({upd['update_rel_err_leaf']}, bound {TP_UPDATE_BOUND}); "
        f"launches {out['launches']}; "
        f"max_memory_allocated {[round(r['peak_mem_gb'], 2) for r in res]}"
        f" GB; wall_s={out['wall_s']:.3f} (ranks share one card: counts, "
        f"no multi-GPU speed)")
    checks = {
        "prefill logits": r0["prefill_rel_err"] <= TP_LOGIT_BOUND,
        "prefill control misses": r0["prefill_control_rel_err"] >
        TP_LOGIT_BOUND,
        "decode logits": r0["decode_rel_err"] <= TP_LOGIT_BOUND,
        "heads": all(r["prefill_heads"] == [heads] for r in res),
        "no gathered leaf": all(not r["prefill"]["gathered"] for r in res),
        "gradients": all(r["grad_rel_err"] <= TP_GRAD_BOUND for r in res),
        "gradient control misses": all(r["control_rel_err"] > TP_GRAD_BOUND
                                       for r in res),
        "bf16 gradients": all(r["bf16_grad_ratio"] <= TP_BF16_GRAD_RATIO
                              for r in res),
        "update": all(r["update_rel_err"] <= TP_UPDATE_BOUND for r in res),
        "finite": all(np.isfinite(r["step_loss"]) and
                      np.isfinite(r["grad_norm"]) for r in res),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"tp: failed {failed}")
    log(f"    card: {gpu_name_and_limit()}")
    return out


# ---------------------------------------------------------------------------
# phase trace: one full-width train step under the profiler
# ---------------------------------------------------------------------------

#: kernels of a train step by what they compute (the first match names a
#: kernel's group; names are the CUDA kernels' own)
STEP_GROUPS = (("banded_attention_bwd", ("attention_bwd_",)),
               ("banded_attention", ("banded_attention",)),
               ("matmul", ("gemm", "sm90_xmma", "cutlass", "nvjet")))
TRACE_TOP = 15


def train_trace(torch, launches) -> dict:
    """Phase train (a)'s full-width step once more, on a fresh state,
    under ``torch.profiler`` (CUDA activity only; :func:`device_idle`):
    the step's seconds, the device's idle share and its kernels' device
    time by name and group.  It runs after every timed phase, since a
    profiler session slows every later launch of the process."""
    b, s = TRAIN_SHAPE
    cfg, params, opt, batch, step, _, out = train_state(torch)
    reset_counts()
    t0 = time.perf_counter()
    (params, opt, m), idle = device_idle(
        torch, lambda: step(params, opt, batch), "train_step", top=True)
    out["traced_step_s"] = time.perf_counter() - t0
    out["launches"] = dict(launches)
    out["designs"] = variant_counts()
    out["loss"] = float(m["loss"])
    del params, opt, m
    torch.cuda.empty_cache()
    kernels = idle.pop("kernels_ms")
    groups = {g: 0.0 for g, _ in STEP_GROUPS}
    groups["other"] = 0.0
    for name, ms in kernels.items():
        g = next((g for g, keys in STEP_GROUPS
                  if any(k in name for k in keys)), "other")
        groups[g] += ms
    busy_ms = sum(kernels.values())
    out.update(idle=idle, groups_ms=groups, kernel_ms_total=busy_ms,
               top=sorted(kernels.items(), key=lambda kv: -kv[1])[:TRACE_TOP])
    if out["launches"]["block_attention_bwd"] != cfg.n_layers or \
            out["designs"]["block_attention_bwd"]["wgmma"] != cfg.n_layers:
        raise AssertionError(f"the traced step launched {out['launches']} "
                             f"({out['designs']})")
    log(f"  traced step B={b} S={s}: {out['traced_step_s']:.3f} s (warm-up "
        f"{out['warmup_s']:.3f} s), loss {out['loss']:.4f}, device idle_share "
        f"{idle['idle_share']:.4f} (window {idle['window_s']:.3f} s, busy "
        f"{idle['device_busy_s']:.4f} s), kernels {busy_ms:.1f} ms")
    for g, ms in groups.items():
        log(f"    {g:22s} {ms:10.3f} ms  share {ms / busy_ms:.4f}")
    for name, ms in out["top"]:
        log(f"    {ms:10.3f} ms  {name[:150]}")
    log(f"    card: {gpu_name_and_limit()}")
    return out


# ---------------------------------------------------------------------------
# phase 4: report
# ---------------------------------------------------------------------------

#: the design of each kernel that the report's row measures (for
#: banded_attention, the one its bf16 calls take; see each csrc/ header)
DESIGN = {"bsmm_pairs": "persistent-warp-streams-cp.async-3xtf32-mma",
          "batched_gemm": "persistent-cp.async-ring-fma",
          "banded_attention": "wgmma-tma-split-p",
          "banded_attention_bwd": "wgmma-tma-dq-dv-dk-grids-split-p-ds"}

#: the phase whose run gives each kernel's headline row
HEADLINE = {"bsmm_pairs": "banded", "batched_gemm": "banded_gemm",
            "banded_attention": "lm", "banded_attention_bwd": "train"}


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
                      r"banded_attention_wgmma|attention_bwd_dq_kernel|"
                      r"attention_bwd_dkv_kernel|attention_bwd_dq_wgmma|"
                      r"attention_bwd_dkv_wgmma)I(\w*?)EE", ln)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2) + "E")
            args += [("dv", "dk")[int(b)]
                     for b in re.findall(r"Lb([01])E", m.group(2) + "E")]
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
            sym = re.search(r"(banded_attention_wgmma|attention_bwd_dq_wgmma|"
                            r"attention_bwd_dkv_wgmma)ILi(\d+)E", ln)
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
    notes = {name: ptxas_summary(text) for name, text in logs.items()}
    for name, lines in notes.items():
        log(f"  nvcc {name}:\n" + "\n".join("    " + ln for ln in lines))
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

    log("phase mesh: MeshEngine on a torch.distributed group")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = mesh_phase(torch, ops, ref)
    mesh["mesh_s"] = time.perf_counter() - t0
    for k in ("bsmm_pairs", "batched_gemm"):
        total[k] += mesh["launches"][k]
        worst[k] = max(worst[k], mesh["max_abs_err"][k])
    log(f"  mesh_s={mesh['mesh_s']:.3f} launches={total}")

    log("phase train: the training path at full width")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    phases["train"] = train_phase(torch, ops, ref, _build.LAUNCHES,
                                  notes.get("block_attention_bwd", []))
    worst["banded_attention_bwd"] = phases["train"][
        "kernel_small_max_abs_err"]
    total = {k: total.get(k, 0) + phases["train"]["launches"][k]
             for k in _build.KERNELS}
    log(f"  train_s={time.perf_counter() - t0:.3f} launches={total}")

    log("phase families: the MoE, SSM and hybrid architectures")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    families = families_phase(torch, ops, _build.LAUNCHES)
    families["families_s"] = time.perf_counter() - t0
    total = {k: total[k] + families["launches"][k] for k in _build.KERNELS}
    log(f"  families_s={families['families_s']:.3f} launches={total}")

    log("phase frontends: hubert-xlarge and internvl2-2b")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    frontends = frontends_phase(torch, _build.LAUNCHES)
    frontends["frontends_s"] = time.perf_counter() - t0
    total = {k: total[k] + frontends["launches"][k] for k in _build.KERNELS}
    log(f"  frontends_s={frontends['frontends_s']:.3f} launches={total}")

    log("phase dp: the data-parallel train step on gloo ranks")
    t0 = time.perf_counter()
    dp = dp_phase(torch)
    dp["dp_s"] = time.perf_counter() - t0
    total = {k: total[k] + dp["launches"].get(k, 0) for k in _build.KERNELS}
    log(f"  dp_s={dp['dp_s']:.3f} launches={total}")

    log("phase tp: tensor parallelism on gloo ranks")
    t0 = time.perf_counter()
    tp = tp_phase(torch)
    tp["tp_s"] = time.perf_counter() - t0
    total = {k: total[k] + tp["launches"].get(k, 0) for k in _build.KERNELS}
    log(f"  tp_s={tp['tp_s']:.3f} launches={total}")

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

    log("phase trace: one full-width train step under torch.profiler")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    trace = train_trace(torch, _build.LAUNCHES)
    trace["trace_s"] = time.perf_counter() - t0
    total = {k: total[k] + trace["launches"][k] for k in _build.KERNELS}
    log(f"  trace_s={trace['trace_s']:.3f} launches={total}")

    log("phase 4: report")
    rows = kernel_rows(phases, total, worst)
    elapsed = time.perf_counter() - t_start
    log(f"  smoke_s={elapsed:.3f} host_construction_share="
        f"{build_share / elapsed:.3f}")
    log("record: " + json.dumps({"card": card, "phases": phases,
                                 "bs8_wave": bs8, "sim": sim,
                                 "solvers": solvers, "mesh": mesh,
                                 "families": families,
                                 "frontends": frontends, "dp": dp,
                                 "tp": tp, "serve": serve,
                                 "trace": trace,
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
