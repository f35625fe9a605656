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


def _tol(want, bs):
    """float32: atol 1e-4; bfloat16: 2e-2 of the largest |value| (a few
    bf16 ulps), never looser than 5e-2*bs."""
    if want.dtype == torch.float32:
        return 1e-4
    return min(2e-2 * float(want.float().abs().max()), 5e-2 * bs)


@pytest.mark.parametrize("bs", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions(cuda_device, bs, dtype):
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
    want = ref.bsmm_pairs_ref(a, b, sa_t, sb_t, seg_t, 40)
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= _tol(want, bs)
    assert bool((got[36:] == 0).all())
    want = ref.batched_gemm_ref(a, b[:20])
    assert float((prods.float() - want.float()).abs().max()) <= _tol(want, bs)


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
