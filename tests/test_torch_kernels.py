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

    @pytest.mark.parametrize("kernel", [kbg.batched_gemm, kbp.bsmm_pairs])
    def test_kernel_wrappers_refuse_cpu_tensors(self, kernel):
        """The launch wrappers never run a plain version themselves."""
        a = torch.zeros((2, 8, 8))
        idx = torch.zeros(2, dtype=torch.int32)
        args = (a, a) if kernel is kbg.batched_gemm else (a, a, idx, idx,
                                                          idx)
        kw = {} if kernel is kbg.batched_gemm else {"cap_c": 1}
        with pytest.raises(ValueError, match="CUDA"):
            kernel(*args, **kw)

    def test_sources_exist_and_are_named_by_loader(self):
        assert set(_build.KERNELS) == {"bsmm_pairs", "batched_gemm"}
        for name in _build.KERNELS:
            src = _build.source_of(name)
            assert src.is_file() and src.suffix == ".cu"
            text = src.read_text()
            assert f'extern "C" int {name}_f32(' in text
            assert f'extern "C" int {name}_bf16(' in text
            assert "src/repro/kernels/" in text     # names the TPU kernel
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
        assert set(ops.LAUNCHES) == set(_build.KERNELS)
        with pytest.raises(ValueError, match="unknown kernel"):
            _build.source_of("banded_attention")
