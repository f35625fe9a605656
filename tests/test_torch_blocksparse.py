"""The port's packed block-sparse format and capacity-bounded bsmm against
the reference's.

The same seeded numpy inputs go through ``repro.core.blocksparse`` /
``repro.core.bsmm`` (jax on the CPU; the pair kernel in interpret mode)
and ``repro_torch.core.blocksparse`` / ``repro_torch.core.bsmm`` (CPU
tensors: the kernels' plain versions).  Packing, slot maps, the mask
pyramid and the pair enumerations must be equal element for element;
products agree within float32 (atol 1e-4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import blocksparse as r_bsp  # noqa: E402
from repro.core import bsmm as r_bsmm  # noqa: E402
from repro.core import morton as r_morton  # noqa: E402
from repro.core.patterns import (banded_mask,  # noqa: E402
                                 block_mask_from_element_mask, random_mask,
                                 values_for_mask)
from repro_torch.core import blocksparse as t_bsp  # noqa: E402
from repro_torch.core import bsmm as t_bsmm  # noqa: E402
from repro_torch.core import morton as t_morton  # noqa: E402

FIELDS = ("blocks", "rows", "cols", "nnzb", "slot")


def _pair(a, bs, cap):
    return (r_bsp.from_dense(jnp.asarray(a), bs, cap),
            t_bsp.from_dense(torch.from_numpy(a), bs, cap))


def _equal(ref, port, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(port, f).numpy(), err_msg=f)


def _operands(n, bs, pa, pb):
    a = values_for_mask(pa, seed=0).astype(np.float32)
    b = values_for_mask(pb, seed=1).astype(np.float32)
    return (a, b, block_mask_from_element_mask(np.abs(a) > 0, bs),
            block_mask_from_element_mask(np.abs(b) > 0, bs))


class TestMorton:
    def test_numpy_part_is_the_reference(self):
        g = 16
        r, c = np.repeat(np.arange(g), g), np.tile(np.arange(g), g)
        np.testing.assert_array_equal(t_morton.encode(r, c),
                                      r_morton.encode(r, c))
        np.testing.assert_array_equal(t_morton.morton_permutation(g),
                                      r_morton.morton_permutation(g))
        np.testing.assert_array_equal(t_morton.owner_of_block(r, c, g, 4),
                                      r_morton.owner_of_block(r, c, g, 4))

    def test_torch_encode_is_jnp_encode(self):
        rng = np.random.default_rng(0)
        r, c = rng.integers(0, 2 ** 16, (2, 500))
        want = np.asarray(r_morton.jnp_encode(jnp.asarray(r, jnp.int32),
                                              jnp.asarray(c, jnp.int32)))
        got = t_morton.torch_encode(torch.from_numpy(r), torch.from_numpy(c))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


class TestFormat:
    @pytest.mark.parametrize("bs,cap", [(4, 200), (8, 64), (8, 10)])
    def test_from_dense_equals_reference(self, bs, cap):
        """Including a capacity below the occupied count (truncated in
        row-major order, nnzb still the true count)."""
        a = values_for_mask(random_mask(64, 0.1, seed=2), seed=2).astype(
            np.float32)
        ref, port = _pair(a, bs, cap)
        _equal(ref, port)
        np.testing.assert_array_equal(np.asarray(r_bsp.to_dense(ref)),
                                      t_bsp.to_dense(port).numpy())

    @pytest.mark.parametrize("bs", [4, 8])
    def test_roundtrip(self, bs):
        a = values_for_mask(banded_mask(64, 6), seed=0).astype(np.float32)
        _, port = _pair(a, bs, 200)
        np.testing.assert_array_equal(t_bsp.to_dense(port).numpy(), a)
        assert int(port.nnzb) == block_mask_from_element_mask(
            np.abs(a) > 0, bs).sum()
        assert (port.blocks[int(port.nnzb):] == 0).all()
        assert (port.slot[-1, :] == -1).all() and (port.slot[:, -1] == -1).all()

    def test_from_blocks(self):
        bs, grid = 4, 4
        rows, cols = np.array([0, 2]), np.array([1, 3])
        blocks = np.random.default_rng(0).standard_normal(
            (2, bs, bs)).astype(np.float32)
        ref = r_bsp.from_blocks(rows, cols, jnp.asarray(blocks), grid, cap=8)
        port = t_bsp.from_blocks(rows, cols, torch.from_numpy(blocks), grid,
                                 cap=8)
        _equal(ref, port)
        np.testing.assert_array_equal(np.asarray(r_bsp.to_dense(ref)),
                                      t_bsp.to_dense(port).numpy())


class TestMaskPyramid:
    def test_pyramid_equals_reference(self):
        mask = np.random.default_rng(0).random((16, 16)) < 0.1
        ref = r_bsp.mask_pyramid(jnp.asarray(mask))
        port = t_bsp.mask_pyramid(torch.from_numpy(mask))
        assert [p.shape[0] for p in port] == [16, 8, 4, 2, 1]
        for x, y in zip(ref, port):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        for x, y in zip(t_bsp._np_pyramid(mask), port):
            np.testing.assert_array_equal(x, y.numpy())


class TestPairEnumeration:
    def _masks(self, n, bs, seed):
        return (block_mask_from_element_mask(random_mask(n, 0.15, seed=seed),
                                             bs),
                block_mask_from_element_mask(
                    random_mask(n, 0.15, seed=seed + 1), bs))

    @pytest.mark.parametrize("case", ["plain", "mask_c", "overflow",
                                      "empty"])
    def test_hier_equals_reference(self, case):
        ma, mb = self._masks(64, 4, 0)
        caps = r_bsp.plan_caps(ma, mb, slack=2.0)
        assert caps == t_bsp.plan_caps(ma, mb, slack=2.0)
        mc = None
        if case == "mask_c":
            mc = np.zeros_like(ma)
            mc[:5, 3:] = True
        elif case == "overflow":
            caps[-1] = 64
        elif case == "empty":
            mb = np.zeros_like(mb)
        pr, cr = r_bsp.enumerate_pairs_hier(
            jnp.asarray(ma), jnp.asarray(mb), caps,
            mask_c=None if mc is None else jnp.asarray(mc))
        pt, ct = t_bsp.enumerate_pairs_hier(
            torch.from_numpy(ma), torch.from_numpy(mb), caps,
            mask_c=None if mc is None else torch.from_numpy(mc))
        np.testing.assert_array_equal(np.asarray(pr), pt.numpy())
        assert int(cr) == int(ct)
        if case == "overflow":
            assert int(ct) > 64 and pt.shape[0] == 64

    def test_flat_equals_reference(self):
        ma, mb = self._masks(64, 4, 3)
        cap = t_bsp.plan_caps(ma, mb)[-1]
        pr, cr = r_bsp.enumerate_pairs_flat(jnp.asarray(ma), jnp.asarray(mb),
                                            cap)
        pt, ct = t_bsp.enumerate_pairs_flat(torch.from_numpy(ma),
                                            torch.from_numpy(mb), cap)
        np.testing.assert_array_equal(np.asarray(pr), pt.numpy())
        assert int(cr) == int(ct)

    def test_planners_equal_reference(self):
        ma, mb = self._masks(64, 4, 5)
        assert t_bsp.plan_c_cap(ma, mb) == r_bsp.plan_c_cap(ma, mb)
        assert t_bsmm.pair_counts_per_level(ma, mb) == \
            r_bsmm.pair_counts_per_level(ma, mb)
        assert t_bsmm.useful_flops(ma, mb, 8) == r_bsmm.useful_flops(ma, mb,
                                                                     8)


class TestBsmm:
    def _run(self, n, bs, pa, pb, **kw):
        a, b, ma, mb = _operands(n, bs, pa, pb)
        caps = r_bsp.plan_caps(ma, mb)
        cap_c = r_bsp.plan_c_cap(ma, mb)
        cap_ab = max(int(ma.sum()), int(mb.sum()), 8)
        ra, ta = _pair(a, bs, cap_ab)
        rb, tb = _pair(b, bs, cap_ab)
        rkw = dict(kw, interpret=kw.get("use_pair_kernel", False))
        rc, rinfo = r_bsmm.bsmm(ra, rb, pair_caps=caps, cap_c=cap_c, **rkw)
        tc, tinfo = t_bsmm.bsmm(ta, tb, pair_caps=caps, cap_c=cap_c, **kw)
        _equal(rc, tc, ("rows", "cols", "nnzb", "slot"))
        assert int(rinfo["n_pairs"]) == int(tinfo["n_pairs"])
        assert rinfo["pair_cap"] == tinfo["pair_cap"]
        got = t_bsp.to_dense(tc).numpy()
        np.testing.assert_allclose(got, np.asarray(r_bsp.to_dense(rc)),
                                   atol=1e-4)
        np.testing.assert_allclose(got, a @ b, atol=1e-4)
        return tc, tinfo

    @pytest.mark.parametrize("pattern", ["banded", "random"])
    @pytest.mark.parametrize("hierarchical", [True, False])
    def test_gemm_path_matches_reference(self, pattern, hierarchical):
        pa, pb = {"banded": (banded_mask(64, 6), banded_mask(64, 4)),
                  "random": (random_mask(64, 0.1, seed=3),
                             random_mask(64, 0.15, seed=4))}[pattern]
        self._run(64, 4 if pattern == "banded" else 8, pa, pb,
                  hierarchical=hierarchical)

    def test_pair_kernel_path_matches_reference(self):
        """The reference runs its Pallas kernel in interpret mode (n 64)."""
        self._run(64, 8, banded_mask(64, 8), banded_mask(64, 8),
                  use_pair_kernel=True)

    def test_default_gemm_goes_through_ops(self, monkeypatch):
        """The default gemm_fn is kernels.ops.batched_gemm, the pair path
        kernels.ops.bsmm_pairs (the CUDA kernels on the card)."""
        from repro_torch.kernels import ops
        seen = []
        for name in ("batched_gemm", "bsmm_pairs"):
            orig = getattr(ops, name)
            monkeypatch.setattr(ops, name, lambda *a, _o=orig, _n=name, **k:
                                (seen.append(_n), _o(*a, **k))[1])
        for pair in (False, True):
            self._run(32, 4, banded_mask(32, 3), banded_mask(32, 3),
                      use_pair_kernel=pair)
        assert seen == ["batched_gemm", "bsmm_pairs"]

    def test_from_dense_wrapper(self):
        a = values_for_mask(banded_mask(32, 3), seed=7).astype(np.float32)
        ma = block_mask_from_element_mask(np.abs(a) > 0, 4)
        out, info = t_bsmm.bsmm_from_dense(
            torch.from_numpy(a), torch.from_numpy(a), bs=4, cap_a=64,
            cap_b=64, cap_c=t_bsp.plan_c_cap(ma, ma),
            pair_caps=tuple(t_bsp.plan_caps(ma, ma)))
        np.testing.assert_allclose(out.numpy(), a @ a, atol=1e-4)
        assert int(info["n_pairs"]) <= info["pair_cap"]
