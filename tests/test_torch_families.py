"""The port's MoE FFN and Mamba mixers against the reference's, on the CPU.

The same numpy inputs go through ``repro`` (JAX) and ``repro_torch`` (plain
PyTorch): ``layers.moe_ffn`` / ``moe_ffn_batched`` (outputs, the aux loss
and the (token, slot) pairs dropped over capacity) and ``models/ssm.py``
(the causal conv, both mixers' chunked forward and decode step).  The
model-level checks of the four architectures (forward, decode, generate,
gradients, checkpoints) extend ``test_torch_lm.py`` and
``test_torch_train.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _hyp import given, settings, st  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

FAMILIES = ["phi3_5_moe", "mixtral_8x7b", "falcon_mamba_7b", "zamba2_2_7b"]

#: float32 agreement of two float32 implementations that sum in other
#: orders (einsum vs lax.dot, a Python loop vs lax.scan)
F32_ATOL = 1e-5
#: the mixers' outputs at |y| ~ 1 after a chunked scan: the port's doubling
#: scan associates the products of decays in another order than XLA's
#: associative_scan, so float32 rounding differs by a few ulps a step
SSM_ATOL = 2e-5
#: bf16 MoE outputs (|out| ~ 1): JAX and PyTorch round the expert products
#: and silu to bf16 at other points, a few bf16 ulps (2**-8 relative) each
BF16_ATOL = 3e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _both(x, jdtype=jnp.float32, tdtype=torch.float32):
    return jnp.asarray(x, jdtype), torch.tensor(x, dtype=tdtype)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_inputs(seed, t=256, d=16, e=8, ff=24):
    """Tokens whose router prefers expert 0 (a shared offset along its
    column), so capacity factors <= 1 drop pairs; expert weights of unit
    scale."""
    rng = np.random.default_rng(seed)
    offset = rng.standard_normal(d)
    x = rng.standard_normal((t, d)) * 0.5 + offset
    rw = rng.standard_normal((d, e)) * 0.3
    rw[:, 0] += offset / np.linalg.norm(offset) ** 2
    wg, wu = (rng.standard_normal((e, d, ff)) * d ** -0.5 for _ in range(2))
    wd = rng.standard_normal((e, ff, d)) * ff ** -0.5
    return [a.astype(np.float32) for a in (x, rw, wg, wu, wd)]


def _kept_pairs(fn, x, rw, wg, wu, wd, **kw):
    """(T, E) bool: the (token, expert) pairs whose product reached the
    output.  Each expert writes only its own block of the output's
    columns, so a block is nonzero exactly where the pair was kept (the k
    experts of a token are distinct)."""
    e, ff, d = wd.shape
    blk = d // e
    wd = wd.copy()
    for i in range(e):
        wd[i, :, :i * blk] = 0.0
        wd[i, :, (i + 1) * blk:] = 0.0
    out, _ = fn(x, rw, wg, wu, wd, **kw)
    out = _np(out).reshape(out.shape[0], e, blk)
    return np.abs(out).sum(-1) > 0


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.25])
def test_moe_ffn_matches_reference(top_k, capacity_factor):
    """Outputs within F32_ATOL, aux within rtol 1e-6, and the same
    (token, slot) pairs dropped: none at capacity factor 8, some at 1 and
    0.25 (the router prefers expert 0)."""
    arrs = _moe_inputs(top_k)
    (jx, x), (jr, r), (jg, g), (ju, u), (jd, dn) = (_both(a) for a in arrs)
    kw = dict(top_k=top_k, capacity_factor=capacity_factor)
    got, aux = L.moe_ffn(x, r, g, u, dn, **kw)
    want, jaux = JL.moe_ffn(jx, jr, jg, ju, jd, **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)

    kept = _kept_pairs(lambda *a, **k: L.moe_ffn(
        *(torch.from_numpy(t) for t in a), **k), *arrs, **kw)
    jkept = _kept_pairs(lambda *a, **k: JL.moe_ffn(
        *(jnp.asarray(t) for t in a), **k), *arrs, **kw)
    np.testing.assert_array_equal(kept, jkept)
    dropped = arrs[0].shape[0] * top_k - int(kept.sum())
    assert (dropped == 0) == (capacity_factor == 8.0), dropped


def test_moe_capacity_drop_matches_reference():
    """The reference's ``test_moe_capacity_drop`` case: a +-1 router sends
    every token to expert 0 or 1 at top_k 1 and capacity factor 0.25.  Its
    two probabilities are distinct for every token (no tie for ``topk`` to
    break), and the port zeroes the same tokens."""
    rng = np.random.default_rng(4)
    t, d, e, ff = 64, 4, 2, 8
    x = rng.standard_normal((t, d)).astype(np.float32)
    rw = np.stack([np.ones(d), -np.ones(d)], 1).astype(np.float32)
    ws = [rng.standard_normal(sh).astype(np.float32)
          for sh in ((e, d, ff), (e, d, ff), (e, ff, d))]
    assert (np.abs(x.sum(1)) > 1e-3).all()       # p0 != p1 for every token
    got, _ = L.moe_ffn(*(torch.from_numpy(a) for a in [x, rw] + ws),
                       top_k=1, capacity_factor=0.25)
    want, _ = JL.moe_ffn(*(jnp.asarray(a) for a in [x, rw] + ws),
                         top_k=1, capacity_factor=0.25)
    zeros = (_np(got) == 0).all(-1)
    assert zeros.any() and np.isfinite(_np(got)).all()
    np.testing.assert_array_equal(zeros, (_np(want) == 0).all(-1))
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)


def test_moe_ffn_bfloat16_matches_reference():
    """bf16 tokens and weights: the same routing (float32 logits of the
    same bf16 values), outputs within BF16_ATOL."""
    arrs = _moe_inputs(5, t=64)
    both = [_both(a, jnp.bfloat16, torch.bfloat16) for a in arrs]
    got, aux = L.moe_ffn(*(b[1] for b in both), top_k=2,
                         capacity_factor=1.25)
    want, jaux = JL.moe_ffn(*(b[0] for b in both), top_k=2,
                            capacity_factor=1.25)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_ffn_batched_matches_reference():
    """B = 3 rows, each routed with its own capacity (the reference vmaps
    over B); the aux loss is the rows' mean.  Row 2 is row 0 reversed, so
    the running count drops other tokens of it; each row equals
    ``moe_ffn`` of that row alone."""
    x, rw, wg, wu, wd = _moe_inputs(6, t=64)
    xb = np.stack([x, 2 * x, x[::-1]]).copy()
    kw = dict(top_k=2, capacity_factor=1.0)
    got, aux = L.moe_ffn_batched(*(torch.from_numpy(a) for a in
                                   (xb, rw, wg, wu, wd)), **kw)
    want, jaux = JL.moe_ffn_batched(*(jnp.asarray(a) for a in
                                      (xb, rw, wg, wu, wd)), **kw)
    assert got.shape == xb.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    for i in range(3):
        row, _ = L.moe_ffn(torch.from_numpy(xb[i]), *(
            torch.from_numpy(a) for a in (rw, wg, wu, wd)), **kw)
        np.testing.assert_allclose(_np(got[i]), _np(row), atol=F32_ATOL)


def test_moe_reshard_axis_is_a_mesh_hook():
    """The hook takes a real axis and stores it (a layout hint, as the
    reference's is to GSPMD): one device's MoE FFN is unchanged
    (tests/test_torch_tensor_parallel.py runs it on ranks)."""
    rng = np.random.default_rng(3)
    x, rw = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in ((16, 8), (8, 4)))
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((4, 8, 12), (4, 8, 12), (4, 12, 8))]
    L.set_moe_reshard_axis(None)
    want, _ = L.moe_ffn(x, rw, *w, top_k=2)
    L.set_moe_reshard_axis("model")
    try:
        got, _ = L.moe_ffn(x, rw, *w, top_k=2)
    finally:
        L.set_moe_reshard_axis(None)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

def _mamba1_params(rng, d=8, di=16, n=4, k=4, dtr=2):
    p = {"in_proj": (d, 2 * di), "conv": (di, k), "x_proj": (di, dtr + 2 * n),
         "dt_proj": (dtr, di), "out_proj": (di, d)}
    p = {name: rng.standard_normal(sh) * 0.3 for name, sh in p.items()}
    p["dt_bias"] = rng.standard_normal(di) * 0.3 - 1.0
    p["A_log"] = rng.standard_normal((di, n)) * 0.3
    p["D"] = rng.standard_normal(di) * 0.3
    return {k: v.astype(np.float32) for k, v in p.items()}, n


def _mamba2_params(rng, d=8, di=32, n=4, hd=8, k=4):
    nh = di // hd
    p = {"in_proj": (d, 2 * di + 2 * n + nh), "conv": (di + 2 * n, k),
         "out_proj": (di, d)}
    p = {name: rng.standard_normal(sh) * 0.3 for name, sh in p.items()}
    p["A_log"] = rng.standard_normal(nh) * 0.3
    p["D"] = rng.standard_normal(nh) * 0.3
    p["dt_bias"] = rng.standard_normal(nh) * 0.3 - 1.0
    p["norm_scale"] = rng.standard_normal(di) * 0.1
    return {k: v.astype(np.float32) for k, v in p.items()}, n, hd


def _params_both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def test_causal_conv_and_conv_step_match_reference():
    rng = np.random.default_rng(0)
    jx, x = _both(rng.standard_normal((2, 16, 6)))
    jw, w = _both(rng.standard_normal((6, 4)))
    np.testing.assert_allclose(_np(ssm.causal_conv1d(x, w)),
                               _np(jssm.causal_conv1d(jx, jw)), atol=1e-6)
    js, s = _both(rng.standard_normal((2, 3, 6)))
    out, new = ssm.conv_step(x[:, 0], s, w)
    jout, jnew = jssm.conv_step(jx[:, 0], js, jw)
    np.testing.assert_allclose(_np(out), _np(jout), atol=1e-6)
    np.testing.assert_array_equal(_np(new), _np(jnew))


@pytest.mark.parametrize("mixer", ["mamba1", "mamba2"])
@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 8), (32, 4), (32, 8)])
def test_mixer_forward_matches_reference(mixer, s, chunk):
    """The chunked forward, float32, within SSM_ATOL (the doubling scan's
    association order is not XLA's: equal within rounding, not bitwise)."""
    rng = np.random.default_rng(s + chunk)
    u = rng.standard_normal((2, s, 8)).astype(np.float32)
    if mixer == "mamba1":
        p, n = _mamba1_params(rng)
        jp, tp = _params_both(p)
        got = ssm.mamba1_forward(tp, torch.from_numpy(u), state=n,
                                 chunk=chunk)
        want = jssm.mamba1_forward(jp, jnp.asarray(u), state=n, chunk=chunk)
    else:
        p, n, hd = _mamba2_params(rng)
        jp, tp = _params_both(p)
        got = ssm.mamba2_forward(tp, torch.from_numpy(u), state=n,
                                 head_dim=hd, chunk=chunk)
        want = jssm.mamba2_forward(jp, jnp.asarray(u), state=n, head_dim=hd,
                                   chunk=chunk)
    assert got.shape == u.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=SSM_ATOL)


#: the mixers' weights the model holds in its own type (``init_params``
#: keeps dt_bias, A_log, D and the norms float32)
_MIXER_WEIGHTS = ("in_proj", "conv", "x_proj", "dt_proj", "out_proj")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mixer", ["mamba1", "mamba2"])
def test_mixer_forward_bfloat16_matches_reference(mixer, seed):
    """bf16 input and weights, S = 256 in chunks of 64, as the card runs
    the mixers: the port within twice the reference's own distance (max
    abs) from the float32 reference on the same bf16 values, both from the
    reference and from that float32 result."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((2, 256, 8)).astype(np.float32)
    if mixer == "mamba1":
        p, n = _mamba1_params(rng)
        kw = dict(state=n)
    else:
        p, n, hd = _mamba2_params(rng)
        kw = dict(state=n, head_dim=hd)
    jb = {k: jnp.asarray(v, jnp.bfloat16 if k in _MIXER_WEIGHTS
                         else jnp.float32) for k, v in p.items()}
    tb = {k: _from_jax(v) for k, v in jb.items()}
    ju = jnp.asarray(u, jnp.bfloat16)
    fwd, jfwd = getattr(ssm, f"{mixer}_forward"), \
        getattr(jssm, f"{mixer}_forward")
    got = fwd(tb, _from_jax(ju), chunk=64, **kw)
    want = jfwd(jb, ju, chunk=64, **kw)
    f32 = jfwd({k: v.astype(jnp.float32) for k, v in jb.items()},
               ju.astype(jnp.float32), chunk=64, **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    tol = 2 * float(np.abs(_np(want) - _np(f32)).max())
    assert float(np.abs(_np(got) - _np(want)).max()) <= tol
    assert float(np.abs(_np(got) - _np(f32)).max()) <= tol


def _from_jax(x) -> torch.Tensor:
    """A jax array as a CPU tensor of its type (bf16 by its bits)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("mixer", ["mamba1", "mamba2"])
def test_mixer_step_matches_reference(mixer):
    """Twelve decode steps from a random state: outputs and both states."""
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 12, 8)).astype(np.float32)
    if mixer == "mamba1":
        p, n = _mamba1_params(rng)
        shapes = ((2, 3, 16), (2, 16, n))
        step, jstep, kw = ssm.mamba1_step, jssm.mamba1_step, dict(state=n)
        st_cls, jst_cls = ssm.MambaState, jssm.MambaState
    else:
        p, n, hd = _mamba2_params(rng)
        shapes = ((2, 3, 32 + 2 * n), (2, 4, hd, n))
        step, jstep = ssm.mamba2_step, jssm.mamba2_step
        kw = dict(state=n, head_dim=hd)
        st_cls, jst_cls = ssm.Mamba2State, jssm.Mamba2State
    jp, tp = _params_both(p)
    init = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    stt = st_cls(*(torch.from_numpy(a) for a in init))
    jst = jst_cls(*(jnp.asarray(a) for a in init))
    for t in range(u.shape[1]):
        y, stt = step(tp, torch.from_numpy(u[:, t]), stt, **kw)
        jy, jst = jstep(jp, jnp.asarray(u[:, t]), jst, **kw)
        np.testing.assert_allclose(_np(y), _np(jy), atol=F32_ATOL)
    for a, b in zip(stt, jst):
        np.testing.assert_allclose(_np(a), _np(b), atol=F32_ATOL)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000), s=st.sampled_from([8, 16]),
       chunk=st.sampled_from([1, 2, 4, 8, 16]))
def test_property_mamba1_chunked_forward_equals_stepping(seed, s, chunk):
    """The port's counterpart of the reference's
    ``test_property_ssm_step_matches_forward``: mamba1's chunked forward
    (any chunking) equals sequential stepping, atol 1e-5."""
    rng = np.random.default_rng(seed)
    d, di, n, k, dtr = 4, 8, 2, 3, 2
    p = {"in_proj": (d, 2 * di), "conv": (di, k), "x_proj": (di, dtr + 2 * n),
         "dt_proj": (dtr, di), "out_proj": (di, d)}
    p = {name: torch.tensor(rng.standard_normal(sh) * .3,
                            dtype=torch.float32) for name, sh in p.items()}
    p.update(dt_bias=torch.zeros(di), A_log=torch.zeros(di, n),
             D=torch.zeros(di))
    u = torch.tensor(rng.standard_normal((1, s, d)), dtype=torch.float32)
    y_full = ssm.mamba1_forward(p, u, state=n, chunk=chunk)
    stt = ssm.MambaState(torch.zeros(1, k - 1, di), torch.zeros(1, di, n))
    ys = []
    for t in range(s):
        y, stt = ssm.mamba1_step(p, u[:, t], stt, state=n)
        ys.append(y)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(y_full),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the four configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_and_parameter_counts_match_reference(arch):
    """The published config, its parameter counts and the port's schema
    (every leaf's shape at full width) equal the reference's."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert M.param_shapes(cfg) == JM.param_shapes(jcfg)


def test_mamba2_conv_fan_in_is_its_first_axis():
    """The reference's init scales every weight by shape[-2] ** -0.5, so
    the mamba2 conv (di + 2N, K) draws at (di + 2N) ** -0.5 (a quirk the
    port keeps)."""
    cfg = get_smoke_config("zamba2_2_7b")
    conv = M.init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")["layers"]["conv"]
    fan_in = cfg.d_inner + 2 * cfg.ssm_state
    assert conv.shape[-2:] == (fan_in, cfg.d_conv)
    assert abs(float(conv.std()) * fan_in ** 0.5 - 1) < 0.1
