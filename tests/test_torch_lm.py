"""The port's LM path against the reference's, on the CPU.

The same numpy inputs go through ``repro`` (JAX; the Pallas attention
kernel in interpret mode) and ``repro_torch`` (its plain PyTorch versions,
since the tensors lie on the CPU).  Weights are the reference's
``init_params`` draws carried across with ``params_from_numpy``.  The
CUDA kernel itself runs only on a GPU: its tests are in
``test_torch_cuda.py``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import lm_serve as jserve  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import lm_serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

DENSE = ["h2o_danube3_4b", "llama3_2_3b", "olmo_1b", "stablelm_12b"]
#: the MoE, SSM and hybrid families
FAMILIES = ["phi3_5_moe", "mixtral_8x7b", "falcon_mamba_7b", "zamba2_2_7b"]
#: the audio (frames) and VLM (patches) frontends
FRONTENDS = ["hubert_xlarge", "internvl2_2b"]

#: float32 agreement of two float32 implementations that sum in other
#: orders (einsum vs lax.dot, a Python loop vs lax.scan)
F32_ATOL = 2e-5
#: logits of the smoke models (|logit| ~ 2) after two layers of float32
LOGIT_ATOL = 1e-4


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, jdtype=jnp.float32, tdtype=torch.float32):
    """The same numpy data as a jax array and a CPU torch tensor."""
    return jnp.asarray(x, jdtype), torch.tensor(x, dtype=tdtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# kernel contract: ops.banded_attention against the Pallas kernel and oracle
# ---------------------------------------------------------------------------

class TestBandedAttentionContract:
    @pytest.mark.parametrize("window,block", [(16, 16), (32, 16), (32, 32)])
    def test_sweep_windows(self, window, block):
        rng = np.random.default_rng(window + block)
        (jq, q), (jk, k), (jv, v) = (_both(_rand(rng, (2, 64, 16)))
                                     for _ in range(3))
        got = ops.banded_attention(q, k, v, window=window, block_q=block,
                                   block_kv=block)
        pallas = jops.banded_attention(jq, jk, jv, window=window,
                                       block_q=block, block_kv=block,
                                       use_pallas=True, interpret=True)
        oracle = jref.banded_attention_ref(jq, jk, jv, window)
        np.testing.assert_allclose(_np(got), _np(pallas), atol=F32_ATOL)
        np.testing.assert_allclose(_np(got), _np(oracle), atol=F32_ATOL)

    def test_bidirectional(self):
        rng = np.random.default_rng(1)
        (jq, q), (jk, k), (jv, v) = (_both(_rand(rng, (1, 64, 8)))
                                     for _ in range(3))
        got = ops.banded_attention(q, k, v, window=16, block_q=16,
                                   block_kv=16, causal=False)
        pallas = jops.banded_attention(jq, jk, jv, window=16, block_q=16,
                                       block_kv=16, causal=False,
                                       use_pallas=True, interpret=True)
        oracle = jref.banded_attention_ref(jq, jk, jv, 16, causal=False)
        np.testing.assert_allclose(_np(got), _np(pallas), atol=F32_ATOL)
        np.testing.assert_allclose(_np(got), _np(oracle), atol=F32_ATOL)

    @pytest.mark.parametrize("causal", [True, False])
    def test_window_covering_all_is_full_attention(self, causal):
        """window >= S: ordinary causal (or full) attention."""
        rng = np.random.default_rng(2)
        q, k, v = (torch.tensor(_rand(rng, (1, 32, 8))) for _ in range(3))
        got = ops.banded_attention(q, k, v, window=32, block_q=16,
                                   block_kv=16, causal=causal)
        scores = torch.einsum("hqd,hkd->hqk", q, k) / np.sqrt(8)
        if causal:
            scores = scores.masked_fill(
                ~torch.ones(32, 32, dtype=torch.bool).tril(), float("-inf"))
        want = torch.einsum("hqk,hkd->hqd", torch.softmax(scores, -1), v)
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)

    def test_bfloat16(self):
        """The port rounds like the Pallas kernel (float32 inside, bf16
        once at the output); the reference's oracle also rounds the scaled
        scores and p to bf16.  atol 3e-2: a few bf16 ulps at |out| ~ 1."""
        rng = np.random.default_rng(3)
        (jq, q), (jk, k), (jv, v) = (
            _both(_rand(rng, (2, 64, 16)), jnp.bfloat16, torch.bfloat16)
            for _ in range(3))
        got = ops.banded_attention(q, k, v, window=16, block_q=16,
                                   block_kv=16)
        assert got.dtype == torch.bfloat16
        pallas = jops.banded_attention(jq, jk, jv, window=16, block_q=16,
                                       block_kv=16, use_pallas=True,
                                       interpret=True)
        oracle = jref.banded_attention_ref(jq, jk, jv, 16)
        np.testing.assert_allclose(_np(got), _np(pallas), atol=3e-2)
        np.testing.assert_allclose(_np(got), _np(oracle), atol=3e-2)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_uniform_v_gives_ones(self, seed):
        """With v = all-ones the softmax weights of every row sum to 1."""
        rng = np.random.default_rng(seed)
        q, k = (torch.tensor(_rand(rng, (1, 32, 8))) for _ in range(2))
        got = ops.banded_attention(q, k, torch.ones(1, 32, 8), window=16,
                                   block_q=16, block_kv=16)
        np.testing.assert_allclose(_np(got), np.ones((1, 32, 8)), atol=1e-5)

    @pytest.mark.parametrize("kw", [dict(block_q=16, block_kv=32),
                                    dict(block_q=24, block_kv=24),
                                    dict(window=24)])
    def test_refuses_the_reference_contract_violations(self, kw):
        q = torch.zeros(1, 48, 8)
        args = dict(window=16, block_q=16, block_kv=16)
        args.update(kw)
        with pytest.raises(ValueError):
            ops.banded_attention(q, q, q, **args)


    @pytest.mark.parametrize("kv_heads", [1, 2, 8])
    @pytest.mark.parametrize("causal", [True, False])
    def test_grouped_kv_heads_equal_expanded_kv(self, kv_heads, causal):
        """k, v with H_kv dividing H: query head h reads kv head
        h // (H // H_kv), exactly as the same call on k, v copied over each
        group (plain version and ops, float32 and bfloat16)."""
        rng = np.random.default_rng(kv_heads)
        h, s, d = 8, 64, 16
        q = torch.tensor(_rand(rng, (h, s, d)))
        k, v = (torch.tensor(_rand(rng, (kv_heads, s, d))) for _ in range(2))
        g = h // kv_heads
        ke, ve = (t.repeat_interleave(g, dim=0) for t in (k, v))
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd, ked, ved = (t.to(dtype) for t in (q, k, v, ke, ve))
            want = ref.banded_attention_ref(qd, ked, ved, 16, causal=causal)
            got = ref.banded_attention_ref(qd, kd, vd, 16, causal=causal)
            assert torch.equal(got, want)
            got = ops.banded_attention(qd, kd, vd, window=16, block_q=16,
                                       block_kv=16, causal=causal)
            assert got.dtype == dtype and torch.equal(got, want)
        # and head by head against the reference's oracle on the expanded k, v
        oracle = jref.banded_attention_ref(
            jnp.asarray(q.numpy()), jnp.asarray(ke.numpy()),
            jnp.asarray(ve.numpy()), 16, causal=causal)
        np.testing.assert_allclose(
            _np(ops.banded_attention(q, k, v, window=16, block_q=16,
                                     block_kv=16, causal=causal)),
            _np(oracle), atol=F32_ATOL)

    @pytest.mark.parametrize("kv_shape", [(3, 48, 8), (5, 48, 8), (2, 32, 8),
                                          (2, 48, 4), (0, 48, 8)])
    def test_refuses_kv_heads_that_do_not_divide(self, kv_shape):
        q = torch.zeros(4, 48, 8)
        kv = torch.zeros(kv_shape)
        with pytest.raises(ValueError):
            ops.banded_attention(q, kv, kv, window=16, block_q=16,
                                 block_kv=16)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_windowed_attention_matches_reference(causal):
    """(B, S, KV, G, hd) with G > 1, float32, every row compared (no row is
    fully masked: each query sees itself)."""
    rng = np.random.default_rng(4)
    b, s, kv, g, hd = 2, 64, 2, 3, 8
    jq, q = _both(_rand(rng, (b, s, kv, g, hd)))
    jk, k = _both(_rand(rng, (b, s, kv, hd)))
    jv, v = _both(_rand(rng, (b, s, kv, hd)))
    got = L.windowed_attention(q, k, v, window=32, causal=causal, block=16)
    want = JL.windowed_attention(jq, jk, jv, window=32, causal=causal,
                                 block=16)
    assert got.shape == (b, s, kv, g, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)


def test_windowed_attention_goes_through_ops_banded_attention(monkeypatch):
    calls = []
    real = ops.banded_attention

    def spy(q, k, v, **kw):
        # the CUDA kernel takes contiguous (H, S, D) tensors only
        assert all(t.is_contiguous() for t in (q, k, v))
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "banded_attention", spy)
    cfg = get_smoke_config("h2o_danube3_4b")
    params = M.init_params(cfg, device="cpu")
    M.forward(cfg, params, {"tokens": torch.zeros((1, 64), dtype=torch.long)})
    assert len(calls) == cfg.n_layers
    heads = cfg.n_heads
    # k and v arrive with the kv heads only: no copy over the group
    assert cfg.n_kv_heads < heads
    assert calls[0] == ((heads, 64, cfg.hd), (cfg.n_kv_heads, 64, cfg.hd),
                        (cfg.n_kv_heads, 64, cfg.hd),
                        dict(window=32, block_q=32, block_kv=32,
                             causal=True))


def test_chunked_and_decode_attention_match_reference():
    rng = np.random.default_rng(5)
    b, s, kv, g, hd = 2, 32, 2, 2, 8
    jq, q = _both(_rand(rng, (b, s, kv, g, hd)))
    jk, k = _both(_rand(rng, (b, s, kv, hd)))
    jv, v = _both(_rand(rng, (b, s, kv, hd)))
    for causal in (True, False):
        got = L.chunked_attention(q, k, v, causal=causal, q_chunk=8,
                                  kv_chunk=16)
        want = JL.chunked_attention(jq, jk, jv, causal=causal, q_chunk=8,
                                    kv_chunk=16)
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)
    for window in (0, 8):
        got = L.decode_attention(q[:, :1], k, v, 20, window=window)
        want = JL.decode_attention(jq[:, :1], jk, jv, jnp.int32(20),
                                   window=window)
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)


def test_norms_rope_and_mlps_match_reference():
    rng = np.random.default_rng(6)
    jx, x = _both(_rand(rng, (2, 5, 3, 16)))
    js, sc = _both(_rand(rng, (16,)) * 0.1)
    np.testing.assert_allclose(_np(L.rms_norm(x, sc)),
                               _np(JL.rms_norm(jx, js)), atol=1e-5)
    np.testing.assert_allclose(_np(L.nonparam_layer_norm(x)),
                               _np(JL.nonparam_layer_norm(jx)), atol=1e-5)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1)) * 7
    np.testing.assert_allclose(
        _np(L.apply_rope(x, torch.tensor(pos), 10000.0)),
        _np(JL.apply_rope(jx, jnp.asarray(pos), 10000.0)), atol=1e-5)
    jh, h = _both(_rand(rng, (4, 16)))
    (jw1, w1), (jw2, w2), (jw3, w3) = (_both(_rand(rng, sh) * 0.3)
                                       for sh in ((16, 24), (16, 24),
                                                  (24, 16)))
    np.testing.assert_allclose(_np(L.swiglu(h, w1, w2, w3)),
                               _np(JL.swiglu(jh, jw1, jw2, jw3)), atol=1e-5)
    np.testing.assert_allclose(_np(L.gelu_mlp(h, w1, w3)),
                               _np(JL.gelu_mlp(jh, jw1, jw3)), atol=1e-5)


# ---------------------------------------------------------------------------
# the model: forward, decode_step, generate on the four dense smoke configs
# ---------------------------------------------------------------------------

_REF_PARAMS = {}


def _params(arch):
    """The reference's init_params draws, and the same weights in the
    port."""
    if arch not in _REF_PARAMS:
        cfg = jax_smoke_config(arch)
        jp = JM.init_params(cfg, jax.random.PRNGKey(1))
        tp = M.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
        _REF_PARAMS[arch] = (jp, tp)
    return _REF_PARAMS[arch]


def _tokens(cfg, b, s, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _inputs(cfg, b, s, seed=2):
    """A forward batch of S positions: tokens; frames (B, S, d) for the
    audio frontend; patches and S - n_patches tokens for the VLM."""
    rng = np.random.default_rng(seed + 100)
    if cfg.frontend == "frames":
        return {"frames": _rand(rng, (b, s, cfg.d_model))}
    if cfg.frontend == "patches":
        return {"tokens": _tokens(cfg, b, s - cfg.n_patches, seed),
                "patches": _rand(rng, (b, cfg.n_patches, cfg.d_model))}
    return {"tokens": _tokens(cfg, b, s, seed)}


@pytest.mark.parametrize("arch", DENSE + FAMILIES + FRONTENDS)
@pytest.mark.parametrize("s", [64, 16])
def test_forward_matches_reference(arch, s, monkeypatch):
    """S = 64 takes the window path for h2o and mixtral (window 32 < 64)
    through ``ops.banded_attention`` once a layer, S = 16 the chunked path
    for every config (hubert's bidirectional); the MoE aux loss equals the
    reference's (0 for the other families)."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp, tp = _params(arch)
    inputs = _inputs(cfg, 2, s)
    want, jaux = JM.forward(jcfg, jp, {k: jnp.asarray(v)
                                       for k, v in inputs.items()},
                            remat=False)
    real, band = ops.banded_attention, []

    def counting(*a, **kw):
        band.append(kw["window"])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "banded_attention", counting)
    got, aux = M.forward(cfg, tp, {k: torch.from_numpy(v)
                                   for k, v in inputs.items()})
    windowed = bool(cfg.swa_window) and cfg.swa_window < s
    assert band == ([cfg.swa_window] * cfg.n_layers if windowed else [])
    assert got.shape == (2, s, cfg.vocab)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert (float(aux) == 0.0) == (not cfg.n_experts)
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", DENSE + FAMILIES + ["internvl2_2b"])
def test_decode_step_and_generate_match_reference(arch):
    """Logits of every step, then every cache the config has (k and v;
    the SSM layers' conv and ssm states), then greedy tokens exactly.
    internvl2-2b decodes on text tokens alone, as the reference's
    ``decode_step`` does (hubert-xlarge is encoder-only)."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jp, tp = _params(arch)
    tokens = _tokens(cfg, 2, 12, seed=3)
    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(jcfg, p, tok, c,
                                                         pos))
    jcache = JM.init_cache(jcfg, 2, 12)
    cache = M.init_cache(cfg, 2, 12, device="cpu")
    for t in range(12):
        want, jcache = jstep(jp, jnp.asarray(tokens[:, t]), jcache,
                             jnp.int32(t))
        got, cache = M.decode_step(cfg, tp, torch.from_numpy(tokens[:, t]),
                                   cache, t)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL)
    assert cache.keys() == jcache.keys()
    for key in cache:
        assert cache[key].dtype == (torch.float32 if key == "ssm"
                                    else cfg.torch_dtype)
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]),
                                   atol=F32_ATOL)
    prompts = _tokens(cfg, 2, 8, seed=4)
    want = jserve.generate(jcfg, jp, prompts, 6, 14)
    got = lm_serve.generate(cfg, tp, prompts, 6, 14)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_decode_matches_forward_beyond_the_window():
    """Port only: S = 64 > window = 32, so the forward pass takes the
    window path (the reference's TestDecodeConsistency stops at S = 16,
    below the window).  Same tolerance as that test."""
    cfg = get_smoke_config("h2o_danube3_4b")
    params = M.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    s = 64
    tokens = torch.from_numpy(_tokens(cfg, 2, s))
    full, _ = M.forward(cfg, params, {"tokens": tokens})
    cache = M.init_cache(cfg, 2, s, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = M.decode_step(cfg, params, tokens[:, t], cache, t)
        outs.append(lg)
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("arch", ["llama3_2_3b"] + FAMILIES + FRONTENDS)
def test_init_params_matches_reference_schema_and_scale(arch):
    """The reference's leaves (the hybrid's ``shared`` block and its
    (groups, attn_every) stacks too), and its distributions: norms, ``D``
    and ``A_log`` zero, ``dt_bias`` -2, the rest unit normal over
    sqrt(fan_in), fan_in the second-to-last axis."""
    cfg = get_smoke_config(arch)
    jp, _ = _params(arch)
    tp = M.init_params(cfg, device="cpu")
    flat_j = {jax.tree_util.keystr(p): np.asarray(x)
              for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {jax.tree_util.keystr(p): x
              for p, x in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert flat_j.keys() == flat_t.keys()
    for key, want in flat_j.items():
        got = flat_t[key]
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        name = key.split("'")[-2]
        if "norm" in name or name in ("D", "A_log"):
            assert not got.any() and not want.any()
        elif name == "dt_bias":
            assert (got == -2.0).all() and (want == -2.0).all()
        else:
            fan_in = want.shape[-2]
            assert abs(float(got.std()) * fan_in ** 0.5 - 1) < 0.1


def test_unported_families_raise_naming_the_roadmap():
    """Every family is ported now: both frontends load under both names,
    at the reference's full widths, and run forward on the CPU."""
    from repro.configs import get_config as jax_config
    for arch, alias in (("hubert_xlarge", "hubert-xlarge"),
                        ("internvl2_2b", "internvl2-2b")):
        cfg = get_config(alias)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jax_config(arch))
        smoke = get_smoke_config(arch)
        params = M.init_params(smoke, device="cpu")
        batch = {k: torch.from_numpy(v)
                 for k, v in _inputs(smoke, 1, 16).items()}
        logits, _ = M.forward(smoke, params, batch)
        assert logits.shape == (1, 16, smoke.vocab)
        assert torch.isfinite(logits).all()
    assert get_config("hubert_xlarge").causal is False
    assert get_config("internvl2_2b").n_patches == 256
    with pytest.raises(KeyError):
        get_config("no_such_arch")
    cfg = get_config("h2o-danube3-4b")
    assert (cfg.n_layers, cfg.d_model, cfg.hd, cfg.swa_window) == \
        (24, 3840, 120, 4096)
    assert cfg.torch_dtype == torch.bfloat16


def test_entry_points_default_to_the_card():
    """Without device='cpu' the LM's entry points ask for CUDA."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    cfg = get_smoke_config("h2o_danube3_4b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_cache(cfg, 1, 8)
    with pytest.raises(SystemExit, match="--device cpu"):
        lm_serve.main(["--arch", "h2o-danube3-4b", "--smoke"])


def test_init_params_refuses_a_generator_on_another_device():
    """The generator does not choose the device: a CPU generator for
    parameters on the card is refused, not followed to the CPU."""
    cfg = get_smoke_config("h2o_danube3_4b")
    with pytest.raises(ValueError, match="generator on cpu"):
        M.init_params(cfg, torch.Generator().manual_seed(0), device="cuda")


def test_lm_path_imports_neither_jax_nor_repro():
    """A CPU forward + generate on the h2o, mixtral, falcon-mamba and
    zamba2 smoke configs (``models/ssm.py`` among the modules) loads no jax
    and no ``repro`` module."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch import lm_serve
        from repro_torch.models import model as M
        for arch in ("h2o_danube3_4b", "mixtral_8x7b", "falcon_mamba_7b",
                     "zamba2_2_7b"):
            cfg = get_smoke_config(arch)
            params = M.init_params(cfg, device="cpu")
            tokens = torch.zeros((1, 64), dtype=torch.long)
            logits, _ = M.forward(cfg, params, {"tokens": tokens})
            assert torch.isfinite(logits).all()
            out = lm_serve.generate(cfg, params, np.zeros((2, 4), np.int32),
                                    3, 8)
            assert out.shape == (2, 3)
        assert "repro_torch.models.ssm" in sys.modules
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "jaxlib"))
               or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        print("clean")
    """)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
