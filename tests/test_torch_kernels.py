"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; the same numpy inputs go through ``repro.kernels.ops`` with the
Pallas kernel bodies in interpret mode.  The CUDA kernels themselves run
only on a GPU: their tests are in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import batched_gemm as kbg  # noqa: E402
from repro_torch.kernels import block_attention as kba  # noqa: E402
from repro_torch.kernels import block_attention_bwd as kbb  # noqa: E402
from repro_torch.kernels import bsmm_pairs as kbp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str, bs: int, f32: float) -> float:
    return f32 if dtype == "float32" else 5e-2 * bs


def _pair(x: np.ndarray, dtype: str):
    """The same numpy data as a jax array and a CPU torch tensor."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.tensor(x, dtype=td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pairs_case(cap_a, cap_b, cap_c, n_pairs, bs, seed=0):
    rng = np.random.default_rng(seed)
    ab = rng.standard_normal((cap_a, bs, bs))
    bb = rng.standard_normal((cap_b, bs, bs))
    sa = rng.integers(0, cap_a, n_pairs).astype(np.int32)
    sb = rng.integers(0, cap_b, n_pairs).astype(np.int32)
    seg = np.sort(rng.integers(0, cap_c, n_pairs)).astype(np.int32)
    return ab, bb, sa, sb, seg


def _both_pairs(ab, bb, sa, sb, seg, cap_c, dtype="float32"):
    ja, ta = _pair(ab, dtype)
    jb, tb = _pair(bb, dtype)
    got = ops.bsmm_pairs(ta, tb, torch.from_numpy(sa), torch.from_numpy(sb),
                         torch.from_numpy(seg), cap_c=cap_c)
    want = jops.bsmm_pairs(ja, jb, jnp.asarray(sa), jnp.asarray(sb),
                           jnp.asarray(seg), cap_c=cap_c, use_pallas=True,
                           interpret=True)
    assert got.dtype == DTYPES[dtype][1]
    assert tuple(got.shape) == tuple(want.shape)
    return got, want


@pytest.mark.pallas
class TestBatchedGemm:
    @pytest.mark.parametrize("bs", [4, 8, 16, 32, 64])
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_sweep(self, bs, dtype):
        rng = np.random.default_rng(bs)
        x, y = rng.standard_normal((2, 16, bs, bs))
        (ja, ta), (jb, tb) = _pair(x, dtype), _pair(y, dtype)
        got = ops.batched_gemm(ta, tb)
        want = jops.batched_gemm(ja, jb, use_pallas=True, interpret=True)
        assert got.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   atol=_tol(dtype, bs, 1e-5))

    @pytest.mark.parametrize("p", [2, 6, 24, 0])
    def test_odd_batch_sizes(self, p):
        rng = np.random.default_rng(p)
        x, y = rng.standard_normal((2, p, 16, 16))
        (ja, ta), (jb, tb) = _pair(x, "float32"), _pair(y, "float32")
        got = ops.batched_gemm(ta, tb)
        want = jops.batched_gemm(ja, jb, use_pallas=True, interpret=True)
        assert tuple(got.shape) == (p, 16, 16)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)


@pytest.mark.pallas
class TestBsmmPairs:
    @pytest.mark.parametrize("bs", [4, 8, 16, 32, 64])
    def test_sweep_block_sizes(self, bs):
        case = _pairs_case(12, 12, 6, 30, bs)
        got, want = _both_pairs(*case, cap_c=6)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)

    @pytest.mark.parametrize("n_pairs", [1, 17, 33])
    def test_odd_pair_counts(self, n_pairs):
        case = _pairs_case(9, 7, 5, n_pairs, 8, seed=n_pairs)
        got, want = _both_pairs(*case, cap_c=5)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)

    def test_invalid_pairs_dropped(self):
        ab, bb, sa, sb, seg = _pairs_case(8, 8, 4, 16, 8)
        seg[-5:] = 4                      # invalid marker == cap_c
        sa[-5:] = 99                      # ... pointing anywhere
        sb[-5:] = -2
        got, want = _both_pairs(ab, bb, sa, sb, seg, cap_c=4)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)

    def test_unvisited_slots_zero(self):
        """C slots with no contributing pair must come back zero."""
        ab, bb, _, _, _ = _pairs_case(4, 4, 4, 4, 8)
        zeros = np.zeros(4, np.int32)     # all pairs hit slot 0
        got, want = _both_pairs(ab, bb, zeros, zeros, zeros, cap_c=4)
        assert np.all(_f32(got)[1:] == 0)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)

    @pytest.mark.parametrize("bs", [8, 16])
    def test_bfloat16(self, bs):
        """bf16 inputs accumulate in f32 (the oracle's contract; the Pallas
        body rounds each product to bf16 first), compared in f32."""
        case = _pairs_case(8, 8, 4, 16, bs)
        got, want = _both_pairs(*case, cap_c=4, dtype="bfloat16")
        np.testing.assert_allclose(_f32(got), _f32(want), atol=5e-2 * bs)


def _tf32(x: np.ndarray, rounding: str = "rna") -> np.ndarray:
    """x as TF32: 10 of float32's 23 mantissa bits kept, rounded as
    ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero) or
    truncated (what the tensor cores read of a float32 register, and the
    split of ``csrc/bsmm_pairs.cu``)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    if rounding == "rna":
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


class TestTf32Numerics:
    """Why the float32 tensor-core design of ``csrc/bsmm_pairs.cu`` splits
    each operand: a plain emulation, on the CPU, of its arithmetic on runs
    of 5 pairs of unit-variance products (the smoke's scale), against
    float64.  The contract is atol 1e-4 per element and rel 1e-5 in the
    Frobenius norm.  One-pass TF32 (one rounding of each input) misses
    both; 3xTF32 (``a_hi b_hi + a_hi b_lo + a_lo b_hi``, ``x_hi = tf32(x)``,
    ``x_lo = tf32(x - x_hi)``), each pair summed on its own and then added
    to the slot in float32, as the kernel does, meets both, whether the
    parts are rounded or, as in the kernel, truncated."""

    @staticmethod
    def _emulate(bs: int, scheme: str, rounding: str = "rna"):
        rng = np.random.default_rng(bs)
        slots, run = 200, 5
        a = (rng.standard_normal((slots * run, bs, bs))
             * bs ** -0.25).astype(np.float32)
        b = (rng.standard_normal((slots * run, bs, bs))
             * bs ** -0.25).astype(np.float32)
        want = np.matmul(a.astype(np.float64), b.astype(np.float64)).reshape(
            slots, run, bs, bs).sum(1)
        ah, bh = _tf32(a, rounding), _tf32(b, rounding)
        if scheme == "one_pass":
            prods = np.matmul(ah, bh)
        else:
            al, bl = _tf32(a - ah, rounding), _tf32(b - bh, rounding)
            prods = np.matmul(ah, bl) + np.matmul(al, bh) + np.matmul(ah, bh)
        got = np.zeros((slots, bs, bs), np.float32)
        for r in range(run):                    # pair by pair, in order
            got += prods.reshape(slots, run, bs, bs)[:, r]
        err = float(np.abs(got - want).max())
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        return err, rel

    @pytest.mark.parametrize("bs", [16, 32, 64])
    def test_one_pass_tf32_misses_the_float32_contract(self, bs):
        err, rel = self._emulate(bs, "one_pass")
        assert err > 1e-4 and rel > 1e-5

    @pytest.mark.parametrize("rounding", ["rna", "truncate"])
    @pytest.mark.parametrize("bs", [16, 32, 64])
    def test_3xtf32_meets_the_float32_contract(self, bs, rounding):
        err, rel = self._emulate(bs, "three_pass", rounding)
        assert err <= 1e-4 and rel <= 1e-5

    def test_tf32_rounding_is_to_nearest_ties_away(self):
        one = np.float32(1.0)
        ulp = np.float32(2.0 ** -10)             # TF32's spacing at 1
        x = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11),
                      1 + 3 * 2.0 ** -11], np.float32)
        np.testing.assert_array_equal(
            _tf32(x), np.array([one + ulp, one, -(one + ulp),
                                one + 2 * ulp], np.float32))
        np.testing.assert_array_equal(
            _tf32(x, "truncate"), np.array([one, one, -one, one + ulp],
                                           np.float32))


class TestBsmmPairsDesigns:
    @pytest.mark.parametrize("bs,design", [(4, "fma"), (8, "fma"),
                                           (16, "mma"), (32, "mma"),
                                           (64, "mma")])
    def test_design_for_block_size(self, bs, design):
        """Tensor cores where a block fills whole m16n8 tiles."""
        for dtype in (torch.float32, torch.bfloat16):
            assert kbp.design_for(torch.zeros((1, bs, bs),
                                              dtype=dtype)) == design

    def test_launches_are_counted_per_design(self):
        assert set(ops.VARIANT_LAUNCHES["bsmm_pairs"]) == set(kbp.DESIGNS)
        _build.VARIANT_LAUNCHES["bsmm_pairs"]["mma"] += 3
        _build.reset_launches()
        assert all(v == 0 for v in ops.VARIANT_LAUNCHES["bsmm_pairs"].values())


class TestBandedAttentionBwdDesigns:
    @pytest.mark.parametrize("dtype,d,design", [
        (torch.bfloat16, 120, "wgmma"), (torch.bfloat16, 128, "wgmma"),
        (torch.bfloat16, 64, "wgmma"), (torch.float32, 120, "fma"),
        (torch.bfloat16, 122, "fma"), (torch.bfloat16, 160, "fma")])
    def test_design_for_type_and_head_dim(self, dtype, d, design):
        """Tensor cores for bf16 heads that fill whole 8-column steps and
        at most two 64-column boxes; the FMA design for the rest."""
        q = torch.zeros((4, 16, d), dtype=dtype)
        kv = torch.zeros((2, 16, d), dtype=dtype)
        assert kbb.design_for(q, kv, kv) == design
        assert kbb.design_for(q, kv, kv, q) == design

    def test_design_for_an_unaligned_view(self):
        """A base off the 16-byte grid (which TMA's tensor maps refuse)
        goes to the FMA design."""
        buf = torch.zeros(4 * 16 * 120 + 1, dtype=torch.bfloat16)
        q = buf[1:].view(4, 16, 120)
        kv = torch.zeros((2, 16, 120), dtype=torch.bfloat16)
        assert q.data_ptr() % 16 and kbb.design_for(q, kv, kv) == "fma"

    def test_launches_are_counted_per_design(self):
        assert tuple(ops.VARIANT_LAUNCHES["block_attention_bwd"]) \
            == kbb.DESIGNS
        _build.VARIANT_LAUNCHES["block_attention_bwd"]["wgmma"] += 2
        _build.VARIANT_LAUNCHES["block_attention_bwd"]["fma"] += 1
        _build.reset_launches()
        assert all(v == 0 for v in
                   ops.VARIANT_LAUNCHES["block_attention_bwd"].values())


def _within_bf16(got, want32) -> float:
    """The largest excess of |got - want32| over the smoke's bf16 rule
    (2**-8 |want| + 1e-3 rms(want)); <= 0 where every element meets it."""
    rms = want32.pow(2).mean().sqrt()
    return float(((got.float() - want32).abs()
                  - (2 ** -8 * want32.abs() + 1e-3 * rms)).max())


class TestBwdFragmentRounding:
    """Why the tensor-core backward (``csrc/block_attention_bwd.cu``,
    ``wgmma``) splits P and dS: a plain emulation, on the CPU, of its
    arithmetic on the smoke's first small shape (H 8, H_kv 2, S 300, D 64,
    window 128, bf16 inputs).  Scores, the softmax, dP and dS are float32;
    P and dS are rounded to bf16 before ``P^T do``, ``dS^T q`` and
    ``dS k`` (the A operands of the tensor cores), once (``single``) or as
    ``hi + lo`` with ``hi = bf16(x)``, ``lo = bf16(x - hi)`` (``split``);
    the products sum in float32 and each gradient is rounded to bf16 once.
    Against the plain float32 backward, the split meets the smoke's bf16
    rule on dq, dk and dv; a single rounding misses it on each."""

    @staticmethod
    def _emulate(q, k, v, do, window, causal, rounding):
        h, s, d = q.shape
        g = h // k.shape[0]
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        ke, ve = (t.repeat_interleave(g, 0) for t in (k32, v32))
        scores = torch.einsum("hqd,hkd->hqk", q32, ke) / d ** 0.5
        mask = ref.band_mask(s, window, causal)
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        dp = torch.einsum("hqd,hkd->hqk", do32, ve)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))

        def operand(x):
            hi = x.to(torch.bfloat16).float()
            if rounding == "single":
                return hi
            return hi + (x - hi).to(torch.bfloat16).float()

        pr, dsr = operand(p), operand(ds)
        dq = torch.einsum("hqk,hkd->hqd", dsr, ke) / d ** 0.5
        dk = torch.einsum("hqk,hqd->hkd", dsr, q32).reshape(
            -1, g, s, d).sum(1) / d ** 0.5
        dv = torch.einsum("hqk,hqd->hkd", pr, do32).reshape(
            -1, g, s, d).sum(1)
        return [t.to(torch.bfloat16) for t in (dq, dk, dv)]

    @pytest.mark.parametrize("causal", [True, False])
    def test_split_meets_and_single_rounding_misses(self, causal):
        rng = np.random.default_rng(5)
        h, h_kv, s, d, window = 8, 2, 300, 64, 128
        q, do = (torch.tensor(rng.standard_normal((h, s, d)),
                              dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.tensor(rng.standard_normal((h_kv, s, d)),
                             dtype=torch.bfloat16) for _ in range(2))
        want = ref.banded_attention_bwd_ref(q.float(), k.float(), v.float(),
                                            do.float(), window, causal=causal)
        split = self._emulate(q, k, v, do, window, causal, "split")
        single = self._emulate(q, k, v, do, window, causal, "single")
        for name, a, b, w in zip(("dq", "dk", "dv"), split, single, want):
            assert _within_bf16(a, w) <= 0, name
            assert _within_bf16(b, w) > 0, name


class TestBuildHash:
    def test_a_header_edit_renames_the_library(self, tmp_path, monkeypatch):
        """The library's name hashes the headers under csrc/ as well as the
        source, so an edited header is rebuilt, never loaded stale."""
        import shutil
        csrc = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        monkeypatch.setattr(_build, "CSRC", csrc)
        headers = sorted(csrc.glob("*.cuh"))
        assert headers
        names = {k: _build._lib_path(k).name for k in _build.KERNELS}
        headers[0].write_text(headers[0].read_text() + "\n// edited\n")
        after = {k: _build._lib_path(k).name for k in _build.KERNELS}
        assert all(after[k] != names[k] for k in _build.KERNELS)
        src = _build.source_of("block_attention_bwd")
        src.write_text(src.read_text() + "\n// edited\n")
        assert _build._lib_path("block_attention_bwd").name \
            != after["block_attention_bwd"]


class TestDispatch:
    def test_plain_versions_on_cpu_match_ref(self):
        ab, bb, sa, sb, seg = _pairs_case(5, 6, 3, 9, 8)
        t = [torch.from_numpy(x) for x in (ab, bb, sa, sb, seg)]
        got = ops.bsmm_pairs(*[x.float() if x.is_floating_point() else x
                               for x in t], cap_c=3)
        want = ref.bsmm_pairs_ref(t[0].float(), t[1].float(), *t[2:], 3)
        assert torch.equal(got, want)

    def test_other_devices_refused(self):
        a = torch.empty((2, 8, 8), device="meta")
        with pytest.raises(ValueError, match="device"):
            ops.batched_gemm(a, a)

    @pytest.mark.parametrize("kernel", [kbg.batched_gemm, kbp.bsmm_pairs,
                                        kba.banded_attention,
                                        kbb.banded_attention_bwd])
    def test_kernel_wrappers_refuse_cpu_tensors(self, kernel):
        """The launch wrappers never run a plain version themselves."""
        a = torch.zeros((2, 8, 8))
        idx = torch.zeros(2, dtype=torch.int32)
        args, kw = {kbg.batched_gemm: ((a, a), {}),
                    kbp.bsmm_pairs: ((a, a, idx, idx, idx), {"cap_c": 1}),
                    kba.banded_attention: ((a, a, a), {"window": 4}),
                    kbb.banded_attention_bwd: ((a, a, a, a),
                                               {"window": 4})}[kernel]
        with pytest.raises(ValueError, match="CUDA"):
            kernel(*args, **kw)

    def test_sources_exist_and_are_named_by_loader(self):
        # kernel (csrc/<name>.cu) -> its C entry points' prefix
        entry = {"bsmm_pairs": "bsmm_pairs", "batched_gemm": "batched_gemm",
                 "block_attention": "banded_attention",
                 "block_attention_bwd": "banded_attention_bwd"}
        assert set(_build.KERNELS) == set(entry)
        for name in _build.KERNELS:
            src = _build.source_of(name)
            assert src.is_file() and src.suffix == ".cu"
            text = src.read_text()
            assert f'extern "C" int {entry[name]}_f32(' in text
            assert f'extern "C" int {entry[name]}_bf16(' in text
            assert "src/repro/kernels/" in text     # names the TPU kernel
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
        assert set(ops.LAUNCHES) == set(_build.KERNELS)
        with pytest.raises(ValueError, match="unknown kernel"):
            _build.source_of("banded_attention")
