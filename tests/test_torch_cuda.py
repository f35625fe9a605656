"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one.  They import neither jax nor the reference package, so they
run on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import TorchEngine  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _within(got, want32) -> bool:
    """Each element of a kernel's output against the plain version's
    float32 result on the same inputs (for bfloat16, the plain version run
    on the inputs cast to float32).  float32: atol 1e-4 (both sum in
    float32, in other orders).  bfloat16: 2**-8 |want| + 1e-3 rms(want):
    the kernel sums in float32 and rounds once, at the output, by at most
    half a bf16 ulp (2**-8 of the value), and the float32 sums' order
    stays far inside 1e-3 of the output's rms."""
    diff = (got.float() - want32).abs()
    if got.numel() == 0:
        return True
    if got.dtype == torch.float32:
        return bool((diff <= 1e-4).all())
    rms = want32.pow(2).mean().sqrt()
    return bool((diff <= 2 ** -8 * want32.abs() + 1e-3 * rms).all())


def _drop_last_k(a, b):
    """The operands of the same products with their last k-step dropped."""
    return a[:, :, :-1], b[:, :-1, :]


def _tf32(x):
    """x as float32 rounded to TF32 the way ``cvt.rna.tf32.f32`` rounds (to
    nearest, ties away from zero): the inputs of a one-pass TF32 product."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("bs", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions(cuda_device, bs, dtype):
    """Both multiply kernels element by element against their plain
    versions' float32 results (:func:`_within`); the plain version with
    the last k-step of every product dropped must miss that check."""
    rng = np.random.default_rng(bs)
    scale = bs ** -0.25           # unit-variance product entries
    a = torch.tensor(rng.standard_normal((20, bs, bs)) * scale, dtype=dtype,
                     device=cuda_device)
    b = torch.tensor(rng.standard_normal((24, bs, bs)) * scale, dtype=dtype,
                     device=cuda_device)
    sa = rng.integers(0, 20, 101).astype(np.int32)
    sb = rng.integers(0, 24, 101).astype(np.int32)
    seg = np.sort(rng.integers(0, 36, 101)).astype(np.int32)
    seg[-9:] = 40                 # dropped pairs; slots 36..39 unvisited
    sa_t, sb_t, seg_t = (torch.tensor(x, device=cuda_device)
                         for x in (sa, sb, seg))
    before = dict(ops.LAUNCHES)
    got = ops.bsmm_pairs(a, b, sa_t, sb_t, seg_t, cap_c=40)
    prods = ops.batched_gemm(a, b[:20])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["bsmm_pairs"] == before["bsmm_pairs"] + 1
    assert ops.LAUNCHES["batched_gemm"] == before["batched_gemm"] + 1
    a32, b32 = a.float(), b.float()
    want32 = ref.bsmm_pairs_ref(a32, b32, sa_t, sb_t, seg_t, 40)
    assert got.dtype == dtype
    assert _within(got, want32)
    assert bool((got[36:] == 0).all())
    short = ref.bsmm_pairs_ref(*_drop_last_k(a, b), sa_t, sb_t, seg_t, 40)
    assert not _within(short, want32)
    if dtype == torch.float32 and bs >= 16:
        # the tensor-core design without 3xTF32's correction terms
        assert not _within(ref.bsmm_pairs_ref(_tf32(a), _tf32(b), sa_t, sb_t,
                                              seg_t, 40), want32)
    want32 = ref.batched_gemm_ref(a32, b32[:20])
    assert prods.dtype == dtype
    assert _within(prods, want32)
    assert not _within(ref.batched_gemm_ref(*_drop_last_k(a, b[:20])),
                       want32)


def _check_pairs(a, b, sa, sb, seg, cap_c):
    """bsmm_pairs on the card against its plain version's float32 result
    (:func:`_within`), on the design :func:`design_for` picks (counted per
    design); the last k-step dropped, and in float32 on the tensor-core
    design one-pass TF32, must miss the check.  Returns the kernel's C."""
    from repro_torch.kernels import bsmm_pairs as kbp
    design = "mma" if a.shape[1] >= 16 else "fma"
    assert kbp.design_for(a) == design
    before = dict(ops.VARIANT_LAUNCHES["bsmm_pairs"])
    got = ops.bsmm_pairs(a, b, sa, sb, seg, cap_c=cap_c)
    torch.cuda.synchronize()
    after = ops.VARIANT_LAUNCHES["bsmm_pairs"]
    assert after[design] == before[design] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    sa, sb = sa.clamp(0, a.shape[0] - 1), sb.clamp(0, b.shape[0] - 1)
    want32 = ref.bsmm_pairs_ref(a.float(), b.float(), sa, sb, seg, cap_c)
    assert got.dtype == a.dtype and got.shape == want32.shape
    assert _within(got, want32)
    if int((seg < cap_c).sum()):
        assert not _within(ref.bsmm_pairs_ref(*_drop_last_k(a, b), sa, sb,
                                              seg, cap_c), want32)
        if a.dtype == torch.float32 and design == "mma":
            assert not _within(ref.bsmm_pairs_ref(_tf32(a), _tf32(b), sa, sb,
                                                  seg, cap_c), want32)
    return got


def _ids(x, device):
    return torch.tensor(np.asarray(x, np.int32), device=device)


@pytest.mark.parametrize("case", ["long_run", "singletons", "ragged_chunks"])
@pytest.mark.parametrize("bs", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsmm_pairs_run_shapes(cuda_device, case, bs, dtype):
    """Runs the persistent grid and the ring must get right:

    long_run       one slot with 64 pairs (longer than any ring), between an
                   empty slot and a slot of one pair;
    singletons     20000 slots of one pair each: every warp of the grid
                   walks many chunks and its ring crosses slot and chunk
                   boundaries on every pair;
    ragged_chunks  cap_c = 1001 and runs of 0-6 pairs, so the last chunk is
                   short whatever the chunk size the launch picks.
    """
    rng = np.random.default_rng(bs * 7 + (dtype == torch.float32))
    if case == "long_run":
        cap_a = cap_b = 70
        seg = [1] * 64 + [2]
        cap_c = 3
    elif case == "singletons":
        cap_a = cap_b = 300
        cap_c = 20000
        seg = np.arange(cap_c)
    else:
        cap_a, cap_b, cap_c = 50, 60, 1001
        seg = np.repeat(np.arange(cap_c), rng.integers(0, 7, cap_c))
    n = len(seg)
    a, b = _stack(rng, cap_a, bs, dtype, cuda_device), _stack(
        rng, cap_b, bs, dtype, cuda_device)
    got = _check_pairs(a, b, _ids(rng.integers(0, cap_a, n), cuda_device),
                       _ids(rng.integers(0, cap_b, n), cuda_device),
                       _ids(seg, cuda_device), cap_c)
    if case == "long_run":
        assert bool((got[0] == 0).all())


@pytest.mark.parametrize("bs", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsmm_pairs_takes_views_off_the_16_byte_grid(cuda_device, bs, dtype):
    """Block stacks that start off the 16-byte grid are copied, not
    refused, and give the plain version's result."""
    rng = np.random.default_rng(bs)
    flat = torch.tensor(rng.standard_normal(1 + 9 * bs * bs) * bs ** -0.25,
                        dtype=dtype, device=cuda_device)
    a = flat[1:].view(9, bs, bs)
    b = flat[1 + 2 * bs * bs:].view(7, bs, bs)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    _check_pairs(a, b, _ids(rng.integers(0, 9, 40), cuda_device),
                 _ids(rng.integers(0, 7, 40), cuda_device),
                 _ids(np.sort(rng.integers(0, 11, 40)), cuda_device), 11)


@pytest.mark.parametrize("bs", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsmm_pairs_slot_depends_only_on_its_run(cuda_device, bs, dtype):
    """One run of 7 pairs, placed alone in a one-slot call, and the same
    run at slot 1234 of 3000 among other runs (another grid, other chunk
    boundaries, other neighbours), give bitwise-equal C blocks."""
    rng = np.random.default_rng(100 + bs)
    a, b = (_stack(rng, 40, bs, dtype, cuda_device) for _ in range(2))
    ra, rb = rng.integers(0, 40, 7), rng.integers(0, 40, 7)
    alone = ops.bsmm_pairs(a, b, _ids(ra, cuda_device), _ids(rb, cuda_device),
                           _ids(np.zeros(7), cuda_device), cap_c=1)
    cap_c, at = 3000, 1234
    runs = rng.integers(1, 9, cap_c)
    runs[at] = 7
    seg = np.repeat(np.arange(cap_c), runs)
    sa, sb = rng.integers(0, 40, len(seg)), rng.integers(0, 40, len(seg))
    first = int(runs[:at].sum())
    sa[first:first + 7], sb[first:first + 7] = ra, rb
    among = _check_pairs(a, b, _ids(sa, cuda_device), _ids(sb, cuda_device),
                         _ids(seg, cuda_device), cap_c)
    assert torch.equal(among[at], alone[0])
    assert not torch.equal(among[at - 1], alone[0])


@pytest.mark.parametrize("bs", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsmm_pairs_propagates_nan(cuda_device, bs, dtype):
    """A NaN in an A or a B block, with the bits of a NaN made on the card
    (all mantissa bits set) or of a quiet NaN, comes out NaN in exactly the
    C entries where the plain version has one; the rest within the
    element check."""
    rng = np.random.default_rng(bs + 1)
    a, b = (_stack(rng, 12, bs, dtype, cuda_device) for _ in range(2))
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    nans = (0x7FFFFFFF, 0x7FC00000) if dtype == torch.float32 else (
        0x7FFF, 0x7FC0)
    a.view(bits)[3, 1, bs - 1] = nans[0]
    b.view(bits)[5, bs - 1, 0] = nans[1]
    assert bool(a[3, 1, bs - 1].isnan()) and bool(b[5, bs - 1, 0].isnan())
    sa = _ids(rng.integers(0, 12, 90), cuda_device)
    sb = _ids(rng.integers(0, 12, 90), cuda_device)
    seg = _ids(np.sort(rng.integers(0, 30, 90)), cuda_device)
    got = ops.bsmm_pairs(a, b, sa, sb, seg, cap_c=30)
    torch.cuda.synchronize()
    want32 = ref.bsmm_pairs_ref(a.float(), b.float(), sa, sb, seg, 30)
    assert bool(want32.isnan().any())
    assert torch.equal(got.isnan(), want32.isnan())
    fin = ~want32.isnan()
    assert _within(got[fin], want32[fin])


def _stack(rng, p, bs, dtype, device):
    scale = bs ** -0.25
    return torch.tensor(rng.standard_normal((p, bs, bs)) * scale,
                        dtype=dtype, device=device)


@pytest.mark.parametrize("p", [0, 1, 4, 1003, "many"])
@pytest.mark.parametrize("bs", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_gemm_matches_plain_version(cuda_device, p, bs, dtype):
    """P = 0, one product, one more than the kernel's 3 ring stages, a
    ragged 1003, and "many" (4 * 2**22 / bs**2 + 3: every block of the
    persistent grid walks many steps and its ring wraps many times);
    element by element (:func:`_within`), and the last k-step dropped
    must miss."""
    if p == "many":
        p = 4 * 2 ** 22 // bs ** 2 + 3
    rng = np.random.default_rng(1000 * bs + p)
    a, b = (_stack(rng, p, bs, dtype, cuda_device) for _ in range(2))
    before = ops.LAUNCHES["batched_gemm"]
    got = ops.batched_gemm(a, b)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["batched_gemm"] == before + (1 if p else 0)
    assert got.dtype == dtype and got.shape == (p, bs, bs)
    want32 = ref.batched_gemm_ref(a.float(), b.float())
    assert _within(got, want32)
    if p:
        assert not _within(ref.batched_gemm_ref(*_drop_last_k(a, b)), want32)


def test_batched_gemm_takes_views_off_the_16_byte_grid(cuda_device):
    flat = torch.randn(1 + 7 * 16, device=cuda_device)
    a = flat[1:].view(7, 4, 4)            # starts 4 bytes past the grid
    got = ops.batched_gemm(a, a)
    torch.cuda.synchronize()
    assert _within(got, ref.batched_gemm_ref(a, a))


def test_session_runs_through_the_kernels(cuda_device):
    from repro_torch import Session
    n = 512
    idx = np.arange(n)
    a = np.where(np.abs(idx[:, None] - idx[None, :]) <= 20,
                 np.random.default_rng(0).standard_normal((n, n)), 0.0)
    for kernel in ("pairs", "gemm"):
        name = "bsmm_pairs" if kernel == "pairs" else "batched_gemm"
        sess = Session(engine=TorchEngine(kernel=kernel), leaf_n=128, bs=16)
        before = ops.LAUNCHES[name]
        c = (sess.from_dense(a) @ sess.from_dense(a).T).to_dense()
        assert ops.LAUNCHES[name] == before + sess.engine_stats()["waves"]
        np.testing.assert_allclose(c, a @ a.T, atol=1e-3)


def _banded_session(engine, n=512, d=20, p=8):
    """Build, simulate the build phase, multiply, simulate the multiply."""
    from repro_torch import Session
    idx = np.arange(n)
    a = np.where(np.abs(idx[:, None] - idx[None, :]) <= d,
                 np.random.default_rng(1).standard_normal((n, n)), 0.0)
    sess = Session(engine=engine, leaf_n=128, bs=16, p=p, seed=2,
                   placement="random")
    A, B = sess.from_dense(a), sess.from_dense(a.T)
    sess.simulate()
    C = A @ B
    return sess, C, sess.simulate(fresh_stats=True)


def test_simulate_on_the_card_matches_the_cpu(cuda_device):
    """``Scheduler.run`` flushes the card's deferred waves before reading
    the tasks.  The report equals the torch engine's on the CPU (float32
    leaves on both), and its task counts and flops equal the numpy
    engine's (whose float64 leaves move twice the bytes)."""
    card, c_card, r_card = _banded_session(TorchEngine())
    cpu, _, r_cpu = _banded_session(TorchEngine(device="cpu"))
    host, c_host, r_host = _banded_session("numpy")
    assert card.engine_stats()["waves"] > 0
    assert r_card.to_dict() == r_cpu.to_dict()
    assert r_card.trace.schedule() == r_cpu.trace.schedule()
    assert r_card.n_tasks == r_host.n_tasks
    assert r_card.total_flops == r_host.total_flops
    assert [n.flops for n in card.graph.nodes] == \
        [n.flops for n in host.graph.nodes]
    np.testing.assert_allclose(c_card.to_dense(), c_host.to_dense(),
                               atol=1e-4)


def test_inverse_factor_on_the_card_matches_the_cpu(cuda_device):
    """``inverse_factor(method="localized")`` at n = 512: every multiply
    a bsmm_pairs wave on the card, within the reference's float32
    tolerance of the same factorization on the CPU."""
    from repro_torch import Session
    from repro_torch.solvers import inverse_factor
    n = 512
    idx = np.arange(n)
    dist = np.abs(idx[:, None] - idx[None, :])
    rng = np.random.default_rng(0)
    s = np.where(dist <= 8, rng.standard_normal((n, n)), 0.0) * 0.5 ** dist
    s = (s + s.T) / 2.0
    s *= 0.45 / (np.abs(s).sum(1) - np.abs(np.diag(s))).max()
    np.fill_diagonal(s, 1.0)
    out = []
    for engine in (TorchEngine(), TorchEngine(device="cpu")):
        sess = Session(engine=engine, leaf_n=64, bs=16)
        before = ops.LAUNCHES["bsmm_pairs"]
        z, rep = inverse_factor(sess.from_dense(s, upper=True),
                                method="localized", tol=1e-4, tau=1e-7)
        out.append((z.to_dense(), rep, ops.LAUNCHES["bsmm_pairs"] - before))
    (zc, rc, launched), (zh, rh, _) = out
    assert launched > 0
    assert rc.converged and rc.residual <= 2e-4 and rc.splits == rh.splits
    np.testing.assert_allclose(zc, zh, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(zc.T @ s @ zc, np.eye(n), atol=2e-4,
                               rtol=2e-4)


def test_free_on_the_card_releases_device_memory(cuda_device):
    """``Session.free`` after a simulated multiply: the chunk store's
    owned bytes drop by what it reports, and no device memory stays
    allocated for the freed matrix (each wave's buffers are released once
    its result is back on the host)."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    sess, c, _ = _banded_session(TorchEngine())
    c.to_dense()
    stats = sess.scheduler.store.stats
    owned = sum(st.owned_bytes for st in stats)
    freed = sess.free(c)
    assert freed > 0
    assert sum(st.owned_bytes for st in stats) == owned - freed
    del c
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,s,d,window,block", [
    (3, 128, 16, 32, 32),
    (2, 96, 120, 32, 32),      # S not a multiple of the kernel's 64-row tile
    (2, 160, 160, 64, 32),
    (1, 64, 120, 128, 64),     # window > S: full attention
])
def test_banded_attention_matches_plain_version(cuda_device, causal, dtype,
                                                h, s, d, window, block):
    """Each element against the plain version's float32 result before its
    cast.  float32: atol 1e-4 (both sum in float32, in other orders).
    bfloat16: 2**-8 |want| + 1e-3 rms(want): the kernel rounds once, at
    the output, by at most half a bf16 ulp (2**-8 of the value), and the
    float32 sums' order stays far inside 1e-3 of the output's rms.  Where
    the band is narrower than S, the plain version with the window one
    key short must fail that check."""
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.tensor(rng.standard_normal((h, s, d)), dtype=dtype,
                            device=cuda_device) for _ in range(3))
    before = ops.LAUNCHES["block_attention"]
    got = ops.banded_attention(q, k, v, window=window, block_q=block,
                               block_kv=block, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["block_attention"] == before + 1
    want32 = ref.banded_attention_ref(q.float(), k.float(), v.float(),
                                      window, causal=causal)
    assert got.dtype == dtype and got.shape == want32.shape
    assert _within(got, want32)
    if window < s:
        short = ref.banded_attention_ref(q, k, v, window - 1, causal=causal)
        assert not _within(short, want32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,h_kv,s,d,window", [
    (8, 2, 200, 120, 64),      # the LM's GQA and hd; S a multiple of no tile
    (8, 1, 333, 128, 128),     # one kv head for all
    (4, 4, 130, 16, 64),       # no groups; narrow head
    (6, 3, 257, 160, 192),     # hd 160: three 64-column boxes
    (2, 1, 96, 64, 300),       # window > S
    # the wgmma design at the edges of its tiles: one row, a window of one
    # key, S just under, at and over one 64-row tile and one 128-row block
    (4, 2, 1, 8, 1), (4, 2, 63, 8, 1), (4, 2, 63, 120, 63),
    (4, 2, 65, 8, 2), (4, 2, 129, 120, 64), (4, 2, 300, 120, 128),
])
def test_banded_attention_kv_groups_match_plain_version(
        cuda_device, causal, dtype, h, h_kv, s, d, window):
    """k, v with H_kv < H heads, element by element against the plain
    version's float32 result (:func:`_within`); bfloat16 with D % 8 == 0
    goes to the tensor-core design, everything else to the FMA design
    (counted per design); the window one key short must miss the check."""
    from repro_torch.kernels import block_attention as kba
    rng = np.random.default_rng(h * s + d)
    q = torch.tensor(rng.standard_normal((h, s, d)), dtype=dtype,
                     device=cuda_device)
    k, v = (torch.tensor(rng.standard_normal((h_kv, s, d)), dtype=dtype,
                         device=cuda_device) for _ in range(2))
    design = "wgmma" if dtype == torch.bfloat16 and d % 8 == 0 else "fma"
    assert kba.design_for(q, k, v) == design
    before = dict(ops.VARIANT_LAUNCHES["block_attention"])
    got = kba.banded_attention(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    after = ops.VARIANT_LAUNCHES["block_attention"]
    assert after[design] == before[design] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    want32 = ref.banded_attention_ref(q.float(), k.float(), v.float(),
                                      window, causal=causal)
    assert got.dtype == dtype and got.shape == want32.shape
    assert _within(got, want32)
    if window < s:
        short = ref.banded_attention_ref(q, k, v, window - 1, causal=causal)
        assert not _within(short, want32)


def test_banded_attention_unaligned_bf16_goes_to_the_fma_design(
        cuda_device):
    """A bf16 view that starts off the 16-byte grid cannot be a TMA tensor
    map: the wrapper sends it to the FMA design, which takes it."""
    from repro_torch.kernels import block_attention as kba
    flat = torch.randn(1 + 2 * 96 * 16, device=cuda_device).to(
        torch.bfloat16)
    q = flat[1:].view(2, 96, 16)
    assert q.is_contiguous() and q.data_ptr() % 16
    assert kba.design_for(q, q, q) == "fma"
    before = dict(ops.VARIANT_LAUNCHES["block_attention"])
    got = kba.banded_attention(q, q, q, window=32)
    torch.cuda.synchronize()
    assert ops.VARIANT_LAUNCHES["block_attention"]["fma"] == before["fma"] + 1
    want32 = ref.banded_attention_ref(q.float(), q.float(), q.float(), 32)
    assert _within(got, want32)


def test_banded_attention_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import block_attention as kba
    q = torch.zeros((1, 64, 16), device=cuda_device)
    with pytest.raises(TypeError):
        kba.banded_attention(q.half(), q.half(), q.half(), window=16)
    with pytest.raises(ValueError):
        kba.banded_attention(q[:, :, :15].contiguous(),
                             q[:, :, :15].contiguous(),
                             q[:, :, :15].contiguous(), window=16)
    with pytest.raises(ValueError):
        kba.banded_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                             q, q, window=16)


@pytest.mark.parametrize("batch", [1, 2])
def test_lm_prefill_runs_through_the_kernel(cuda_device, batch):
    """A window-path prefill of the h2o smoke config launches the kernel
    once per layer and agrees with the same prefill on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    cfg = get_smoke_config("h2o_danube3_4b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, 64)))
    with torch.inference_mode():
        want, _ = M.forward(cfg, params, {"tokens": tokens})
        gpu = {k: ({n: w.to(cuda_device) for n, w in v.items()}
                   if isinstance(v, dict) else v.to(cuda_device))
               for k, v in params.items()}
        before = ops.LAUNCHES["block_attention"]
        got, _ = M.forward(cfg, gpu, {"tokens": tokens.to(cuda_device)})
        torch.cuda.synchronize()
    assert ops.LAUNCHES["block_attention"] == before + cfg.n_layers
    assert float((got.cpu() - want).abs().max()) <= 1e-4


def _to(params, device):
    return {k: ({n: w.to(device) for n, w in v.items()}
                if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


@pytest.mark.parametrize("arch", ["phi3_5_moe", "mixtral_8x7b",
                                  "falcon_mamba_7b", "zamba2_2_7b"])
def test_family_prefill_on_the_card_matches_the_cpu(cuda_device, arch):
    """The MoE, SSM and hybrid smoke configs' prefill (S = 64) on the card
    against the same prefill on the CPU, within 1e-4; mixtral's (window
    32 < 64) launches the attention kernel once a layer, the others
    never."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)))
    with torch.inference_mode():
        want, want_aux = M.forward(cfg, params, {"tokens": tokens})
        before = ops.LAUNCHES["block_attention"]
        got, aux = M.forward(cfg, _to(params, cuda_device),
                             {"tokens": tokens.to(cuda_device)})
        torch.cuda.synchronize()
    windowed = arch == "mixtral_8x7b"
    assert ops.LAUNCHES["block_attention"] == before + (
        cfg.n_layers if windowed else 0)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert abs(float(aux) - float(want_aux)) <= 1e-5


def test_mixtral_remat_gradients_on_the_card_match_the_cpu(cuda_device):
    """``loss_fn``'s gradients of the mixtral smoke config (S = 128 >
    window 32, remat) on the card against the CPU's, 1e-4 a leaf
    (relative Frobenius): both attention kernels, the MoE dispatch and
    its aux loss under ``torch.utils.checkpoint``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cfg = get_smoke_config("mixtral_8x7b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = SyntheticLM(cfg.vocab, 128, 2, seed=3).batch_at(0)

    def grads(p, device):
        live = tree_map(lambda w: w.to(device).requires_grad_(), p)
        loss, _ = M.loss_fn(cfg, live, {k: torch.from_numpy(v).to(device)
                                        for k, v in batch.items()})
        return loss, torch.autograd.grad(loss, tree_leaves(live))

    want_loss, want = grads(params, "cpu")
    before = dict(ops.LAUNCHES)
    got_loss, got = grads(params, cuda_device)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["block_attention"] == \
        before["block_attention"] + 2 * cfg.n_layers
    assert ops.LAUNCHES["block_attention_bwd"] == \
        before["block_attention_bwd"] + cfg.n_layers
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5
    for g, w in zip(got, want):
        rel = float((g.cpu() - w).norm() / w.norm().clamp_min(1e-30))
        assert rel <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,h_kv,s,d,window", [
    (8, 2, 200, 120, 64),      # the LM's GQA and hd; S a multiple of no tile
    (4, 4, 130, 160, 32),      # hd 160: the 32-row tiles; no groups
    (8, 2, 257, 120, 32),      # G 4; S = 2 * 128 + 1; window under a tile
    (4, 4, 257, 128, 64),      # hd 128, G 1; window one tile
    (4, 1, 200, 128, 32),      # hd 128, G 4
    (2, 2, 200, 120, 256),     # window >= S: every key in the band
])
def test_banded_attention_backward_matches_plain_version(
        cuda_device, dtype, causal, h, h_kv, s, d, window):
    """dq, dk and dv of the backward kernel, each element against the
    plain backward's float32 result on the same inputs (:func:`_within`);
    the plain backward without the ``rowsum(P dP)`` term must miss it.
    bf16 with hd <= 128 runs the ``wgmma`` design, the rest ``fma``."""
    from repro_torch.kernels import block_attention_bwd as kbb
    rng = np.random.default_rng(s + d)
    q, do = (torch.tensor(rng.standard_normal((h, s, d)), dtype=dtype,
                          device=cuda_device) for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((h_kv, s, d)), dtype=dtype,
                         device=cuda_device) for _ in range(2))
    design = "wgmma" if dtype == torch.bfloat16 and d <= 128 else "fma"
    before = ops.LAUNCHES["block_attention_bwd"]
    per_design = dict(ops.VARIANT_LAUNCHES["block_attention_bwd"])
    got = kbb.banded_attention_bwd(q, k, v, do, window=window, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["block_attention_bwd"] == before + 1
    per_design[design] += 1
    assert ops.VARIANT_LAUNCHES["block_attention_bwd"] == per_design
    want = ref.banded_attention_bwd_ref(q.float(), k.float(), v.float(),
                                        do.float(), window, causal=causal)
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert _within(a, w)
    # the control: dS = P dP, the softmax's row term dropped
    g = h // h_kv
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    ke, ve = (t.repeat_interleave(g, dim=0) for t in (k32, v32))
    scores = torch.einsum("hqd,hkd->hqk", q32, ke) / d ** 0.5
    mask = ref.band_mask(s, window, causal, device=cuda_device)
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    ds = p * torch.einsum("hqd,hkd->hqk", do32, ve)
    assert not _within(torch.einsum("hqk,hkd->hqd", ds, ke) / d ** 0.5,
                       want[0])


def test_lm_backward_launches_the_kernel_once_per_layer(cuda_device):
    """``loss_fn``'s backward on the h2o smoke config (S = 128 > window
    32): the forward kernel twice a layer (the forward and its remat
    recompute), the backward kernel once."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    cfg = get_smoke_config("h2o_danube3_4b")
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                           device=cuda_device)
    for w in (params["embed"], *params["layers"].values()):
        w.requires_grad_()
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 129)), device=cuda_device)
    _build.reset_launches()
    loss, _ = M.loss_fn(cfg, params, {"tokens": toks[:, :-1],
                                      "targets": toks[:, 1:]})
    loss.backward()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["block_attention"] == 2 * cfg.n_layers
    assert ops.LAUNCHES["block_attention_bwd"] == cfg.n_layers
    # the smoke config is float32 (hd 16): every backward on the fma design
    assert cfg.torch_dtype == torch.float32
    assert ops.VARIANT_LAUNCHES["block_attention_bwd"] == {
        "fma": cfg.n_layers, "wgmma": 0}
    assert all(bool(torch.isfinite(w.grad).all())
               for w in params["layers"].values())


def test_train_step_on_the_card_takes_no_plain_path(cuda_device,
                                                    monkeypatch):
    """One ``TrainStep`` of the h2o smoke config on the card with the
    plain attention versions made to raise: the step runs through the
    kernels, and its loss equals the CPU step's within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.sharding import TrainStep
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    cfg = get_smoke_config("h2o_danube3_4b")
    batch = SyntheticLM(cfg.vocab, 128, 2).batch_at(0)
    step = TrainStep(cfg, peak_lr=1e-2, warmup=1).step_fn()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    gpu = {k: ({n: w.to(cuda_device) for n, w in v.items()}
               if isinstance(v, dict) else v.to(cuda_device))
           for k, v in params.items()}
    _, _, want = step(params, adamw_init(params),
                      {k: torch.from_numpy(v) for k, v in batch.items()})

    def plain(*a, **k):
        raise AssertionError("a plain attention version ran on the card")

    monkeypatch.setattr(ref, "banded_attention_ref", plain)
    monkeypatch.setattr(ref, "banded_attention_bwd_ref", plain)
    _, opt, got = step(gpu, adamw_init(gpu),
                       {k: torch.from_numpy(v).to(cuda_device)
                        for k, v in batch.items()})
    torch.cuda.synchronize()
    assert int(opt.step) == 1
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-4


# ---------------------------------------------------------------------------
# plan serving on the card
# ---------------------------------------------------------------------------

def _serve_mats(n=256, seed=0):
    """Three banded operands (half-bandwidth 40) and a symmetric iterate
    with eigenvalues in [0, 1] on full support."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    band = np.abs(i[:, None] - i[None, :]) <= 40
    mats = {f"M{k}": rng.standard_normal((n, n)) * band for k in range(3)}
    h = rng.standard_normal((n, n))
    w, v = np.linalg.eigh((h + h.T) / 2)
    mats["X"] = v @ np.diag((w.max() - w) / (w.max() - w.min())) @ v.T
    return mats


def _serve_reqs():
    from repro_torch.serve import Request
    return [Request.multiply("M0", "M1"), Request.multiply("M1", "M2"),
            Request.multiply("M2", "M0"), Request.multiply("M0", "M0"),
            Request.sp2("X", ne=64.0, iters=3)]


def _serve_on_card(reqs, mats, **cfg):
    """Serve ``reqs`` on the card (``PlanServer()``'s default device),
    leaf_n 64, bs 32; returns the server and the results."""
    from repro_torch.serve import PlanServer
    srv = PlanServer(leaf_n=64, bs=32, max_queue=32, **cfg)
    for nm, a in mats.items():
        srv.register(nm, a)
    tickets = [srv.submit(r) for r in reqs]
    srv.drain()
    assert all(t.done for t in tickets), [t.error for t in tickets]
    return srv, [t.result for t in tickets]


def test_serve_coalesced_equals_serial_on_the_card(cuda_device):
    """Two sessions on the card, four requests in flight: every result
    equals the same request served alone, bitwise (each ``bsmm_pairs``
    slot sums its own run of pairs, whatever else shares the wave), and
    the float64 product within float32 rounding."""
    mats = _serve_mats()
    reqs = _serve_reqs()
    srv, got = _serve_on_card(reqs, mats, n_sessions=2, max_inflight=4)
    assert all(s.graph.engine.device.type == "cuda" for s in srv.sessions)
    assert srv.coalescer.merged_waves > 0
    for r, g in zip(reqs, got):
        _, (want,) = _serve_on_card([r], mats, n_sessions=1, max_inflight=1)
        np.testing.assert_array_equal(g, want)
    for r, g in zip(reqs[:4], got):
        want = mats[r.a] @ mats[r.b]
        assert np.linalg.norm(g - want) <= 1e-5 * np.linalg.norm(want)


def test_serve_prewarm_leaves_no_cold_compile_on_the_card(cuda_device):
    from repro_torch.serve import Request
    mats = {"X": _serve_mats()["X"]}
    reqs = [Request.sp2("X", ne=64.0, iters=3)] * 3
    srv, _ = _serve_on_card(reqs, mats, n_sessions=2, max_inflight=4,
                            prewarm=True)
    assert srv.counters["cold_compiles"] == 0
    assert srv.coalescer.merged_waves > 0


def serving_waves(srv) -> int:
    """The waves a server ran: the coalescer's dispatches, and the waves
    an engine flushed on its own (a rebind flushes the pending work that
    reads the rebound input), which its log keeps without ``coalesced``."""
    own = sum(1 for s in srv.sessions for w in s.graph.engine._waves
              if "coalesced" not in w)
    return len(srv.coalescer.waves) + own


def test_every_serving_wave_is_a_bsmm_pairs_mma_launch(cuda_device):
    """Each serving wave is one ``bsmm_pairs`` launch on the tensor-core
    design, and no other kernel runs."""
    from repro_torch.kernels import _build
    mats = _serve_mats()
    _build.reset_launches()
    srv, _ = _serve_on_card(_serve_reqs(), mats, n_sessions=2,
                            max_inflight=4)
    waves = serving_waves(srv)
    assert len(srv.coalescer.waves) > 0
    assert ops.LAUNCHES == {"bsmm_pairs": waves, "batched_gemm": 0,
                            "block_attention": 0, "block_attention_bwd": 0}
    assert ops.VARIANT_LAUNCHES["bsmm_pairs"] == {"fma": 0, "mma": waves}


def test_engines_on_the_card_and_the_cpu_never_share_a_wave(cuda_device):
    from repro_torch import Session
    from repro_torch.serve import WaveCoalescer
    rng = np.random.default_rng(3)
    outs, vals, graphs = [], [], []
    for dev in ("cuda", "cpu"):
        sess = Session(engine=TorchEngine(device=dev), lazy=True, leaf_n=64,
                       bs=32)
        v = rng.standard_normal((128, 128))
        x = sess.from_dense(v, name="X")
        plan = sess.compile(x @ x)
        plan.run()
        outs.append(plan.run(X=v, flush=False))
        vals.append(v)
        graphs.append(sess.graph)
    co = WaveCoalescer()
    assert co.flush(graphs) == 2
    assert co.merged_waves == 0 and co.solo_waves == 2
    for out, v in zip(outs, vals):
        np.testing.assert_allclose(out.to_dense(), v @ v, atol=1e-4)


@pytest.mark.parametrize("kernel,bs", [("gemm", 8), ("gemm", 32),
                                       ("pairs", 8), ("pairs", 32)])
def test_mesh_engine_world_of_one_on_the_card(cuda_device, kernel, bs):
    """``MeshEngine()`` alone on the card (no process group): the same
    leaves as ``TorchEngine`` within float32, one launch of its kernel per
    wave on the design the block size selects, no bytes on the wire."""
    from repro_torch import Session
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsmm_pairs as kbp
    from repro_torch.launch.mesh_exec import MeshEngine
    n = 512
    idx = np.arange(n)
    a = np.where(np.abs(idx[:, None] - idx[None, :]) <= 20,
                 np.random.default_rng(0).standard_normal((n, n)), 0.0)
    out = []
    for eng in (MeshEngine(kernel=kernel), TorchEngine(kernel=kernel)):
        sess = Session(engine=eng, leaf_n=128, bs=bs)
        _build.reset_launches()
        c = (sess.from_dense(a) @ sess.from_dense(a).T).to_dense()
        out.append((c, sess.engine_stats(), dict(ops.LAUNCHES),
                    {k: dict(v) for k, v in ops.VARIANT_LAUNCHES.items()}))
    (c, st, launches, designs), (want, tst, _, _) = out
    np.testing.assert_allclose(c, want, atol=1e-4)
    np.testing.assert_allclose(c, a @ a.T, atol=1e-3)
    waves = st["waves"]
    assert waves == tst["waves"] > 0
    name = "bsmm_pairs" if kernel == "pairs" else "batched_gemm"
    assert launches == {**dict.fromkeys(launches, 0), name: waves}
    if kernel == "pairs":
        design = kbp.design_for(torch.empty(1, bs, bs))
        assert designs["bsmm_pairs"][design] == waves
    assert st["collective_bytes"] == [0] and st["fetched_bytes"] == [0]
    assert st["pushed_bytes"] == [sum(w["unique_blocks"]
                                      for w in st["wave_log"]) * 4 * bs * bs]


@pytest.mark.parametrize("use_pair_kernel", [False, True])
def test_bsmm_on_the_card_matches_the_cpu(cuda_device, use_pair_kernel):
    """The capacity-bounded ``bsmm`` through the kernels on the card
    against its plain versions on the CPU, same packed operands."""
    from repro_torch.core import blocksparse as bsp
    from repro_torch.core.bsmm import bsmm
    rng = np.random.default_rng(4)
    n, bs = 512, 32
    idx = np.arange(n)
    a = np.where(np.abs(idx[:, None] - idx[None, :]) <= 70,
                 rng.standard_normal((n, n)), 0.0).astype(np.float32)
    ma = a.reshape(n // bs, bs, n // bs, bs).any(axis=(1, 3))
    caps, cap_c = bsp.plan_caps(ma, ma), bsp.plan_c_cap(ma, ma)
    res = []
    for dev in ("cuda", "cpu"):
        m = bsp.from_dense(torch.from_numpy(a).to(dev), bs, int(ma.sum()))
        name = "bsmm_pairs" if use_pair_kernel else "batched_gemm"
        before = ops.LAUNCHES[name]
        c, info = bsmm(m, m, pair_caps=caps, cap_c=cap_c,
                       use_pair_kernel=use_pair_kernel)
        assert ops.LAUNCHES[name] == before + (dev == "cuda")
        res.append((bsp.to_dense(c).cpu(), int(info["n_pairs"])))
    (got, n_card), (want, n_cpu) = res
    assert n_card == n_cpu
    assert _within(got, want)
    np.testing.assert_allclose(got.numpy(), a @ a, atol=1e-3)


@pytest.mark.parametrize("arch", ["hubert_xlarge", "internvl2_2b"])
def test_frontend_gradients_on_the_card_match_the_cpu(cuda_device, arch):
    """``TrainStep``'s loss and unclipped gradients of the audio (frames)
    and VLM (patches and text) smoke configs on the driver's batch, card
    against CPU: the loss within 1e-5, each gradient leaf within 1e-4
    relative Frobenius (float32 sums in other orders), then one step's
    gradient norm within 1e-5.  Parameters after the step are not
    compared: AdamW's first update is about ``lr * sign(g)``, which flips
    where g is near zero.  Window-free, so no kernel launches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.sharding import TrainStep
    from repro_torch.launch.train import batch_to, train_batch
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves
    cfg = get_smoke_config(arch)
    raw = train_batch(cfg, SyntheticLM(cfg.vocab, 64, 2, seed=0), 0, 2, 64)
    builder = TrainStep(cfg, peak_lr=1e-2, warmup=1, total_steps=10)
    shape = ShapeSpec("t", "train", 64, 2)
    res = []
    before = dict(ops.LAUNCHES)
    for dev in ("cpu", cuda_device):
        params = _to(M.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu"), dev)
        batch = batch_to(cfg, raw, dev)
        loss, _, grads = builder.grads_fn(shape)(params, batch)
        _, _, m = builder.step_fn(shape)(params, adamw_init(params), batch)
        res.append((float(loss), tree_leaves(grads), float(m["grad_norm"])))
    assert ops.LAUNCHES == before
    (want, wg, wn), (got, gg, gn) = res
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(gn, wn, rtol=1e-5)
    for g, w in zip(gg, wg):
        assert float((g.cpu() - w).norm() / w.norm().clamp_min(1e-30)) <= 1e-4
