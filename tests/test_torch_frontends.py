"""The audio (hubert-xlarge, frames) and VLM (internvl2-2b, patches)
frontends of the port against the reference's, on the CPU.

Both frontends are stubs in the reference: the batch carries precomputed
frame or patch embeddings.  The same numpy inputs and the reference's
``init_params`` draws go through ``repro`` (JAX) and ``repro_torch``: the
parameter schema, the forward logits, ``loss_fn`` and its gradients,
internvl2-2b's decode on text tokens, and both training drivers' batches.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as jtrain  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import lm_serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import lm_serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

FRONTENDS = ["hubert_xlarge", "internvl2_2b"]
#: logits of the smoke models after two layers of float32
#: (tests/test_torch_lm.py)
LOGIT_ATOL = 1e-4
#: per-leaf relative Frobenius error of the gradients
#: (tests/test_torch_train.py)
GRAD_RTOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want) -> float:
    want = _np(want)
    return float(np.linalg.norm(_np(got) - want) /
                 max(np.linalg.norm(want), 1e-30))


_REF = {}


def _params(arch):
    """The reference's draws, and the same weights in the port."""
    if arch not in _REF:
        _REF[arch] = JM.init_params(jax_smoke_config(arch),
                                    jax.random.PRNGKey(4))
    jp = _REF[arch]
    return jp, M.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")


def _batch(cfg, step=0, seq=32, batch=2) -> dict:
    """The port driver's batch, float32 and int32."""
    b = train.train_batch(cfg, SyntheticLM(cfg.vocab, seq, batch, seed=9),
                          step, batch, seq)
    return {k: v.astype(np.float32 if v.dtype.kind == "f" else np.int32)
            for k, v in b.items()}


@pytest.mark.parametrize("arch", FRONTENDS)
def test_param_shapes_and_weights_carry_across(arch):
    """The same schema as the reference, ``patch_proj`` (d, d) for the
    VLM; every leaf carries across bitwise."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    shapes = M.param_shapes(cfg)
    assert shapes == JM.param_shapes(jcfg)
    assert ("patch_proj" in shapes) == (cfg.frontend == "patches")
    if cfg.frontend == "patches":
        assert shapes["patch_proj"] == (cfg.d_model, cfg.d_model)
    jp, tp = _params(arch)
    jleaves = jax.tree_util.tree_leaves(jp)
    assert len(tree_leaves(tp)) == len(jleaves)
    for got, want in zip(tree_leaves(tp), jleaves):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_logits_loss_and_gradients_match_reference(arch, remat):
    """Logits over all S positions (patches first for the VLM), the loss
    over the text positions only, and the gradients a leaf (hubert's
    unread ``embed`` gets zeros, as under ``jax.grad``)."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jp, tp = _params(arch)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want, _ = JM.forward(jcfg, jp, jb, remat=False)
    with torch.no_grad():
        got, aux = M.forward(cfg, tp, tb)
    assert got.shape == (2, 32, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL)

    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb, remat=remat), has_aux=True)(jp)
    live = M.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    leaves = tree_leaves(live)
    for x in leaves:
        x.requires_grad_()
    loss, met = M.loss_fn(cfg, live, tb, remat=remat)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-6)
    np.testing.assert_allclose(float(met["nll"].detach()),
                               float(jmet["nll"]),
                               rtol=1e-6)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        assert g.shape == jg.shape
        assert _rel(g, jg) <= GRAD_RTOL
    if cfg.frontend == "frames":
        assert not grads[tree_leaves(live).index(live["embed"])].any()


def test_vlm_decodes_text_tokens_as_the_reference_does():
    """internvl2-2b's decode never sees the image, in the reference and in
    the port: every step's logits, the caches, then greedy tokens."""
    arch = "internvl2_2b"
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jp, tp = _params(arch)
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab, (3, 10)).astype(np.int32)
    jcache = JM.init_cache(jcfg, 3, 10)
    cache = M.init_cache(cfg, 3, 10, device="cpu")
    for t in range(10):
        want, jcache = JM.decode_step(jcfg, jp, jnp.asarray(tokens[:, t]),
                                      jcache, jnp.int32(t))
        got, cache = M.decode_step(cfg, tp, torch.from_numpy(tokens[:, t]),
                                   cache, t)
        np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL)
    for key in cache:
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]),
                                   atol=2e-5)
    want = jserve.generate(jcfg, jp, tokens[:, :5], 5, 10)
    np.testing.assert_array_equal(
        lm_serve.generate(cfg, tp, tokens[:, :5], 5, 10), want)


def test_audio_encoder_has_no_serving_path():
    """hubert-xlarge is encoder-only: both serving CLIs refuse it."""
    argv = ["--arch", "hubert-xlarge", "--smoke"]
    with pytest.raises(SystemExit, match="encoder-only"):
        lm_serve.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="encoder-only"):
        jserve.main(argv)


class _Runner:
    """Stands in for the drivers' TrainingRunner: keeps the batch
    function and returns a falling loss without running a step."""
    batch_fn = None

    def __init__(self, run_step, batch_fn, ckpt, **kw):
        type(self).batch_fn = staticmethod(batch_fn)

    def run(self, state, steps):
        return state, {"loss": [1.0, 0.5], "restarts": 0}


def _driver_batch_fns(monkeypatch, tmp_path, arch, batch, seq):
    """The batch functions of both drivers' ``main``."""
    argv = ["--arch", arch, "--smoke", "--batch", str(batch), "--seq",
            str(seq), "--steps", "2"]
    fns = []
    for mod, extra in ((jtrain, ["--ckpt-dir", str(tmp_path / "ref")]),
                       (train, ["--device", "cpu"])):
        monkeypatch.setattr(mod, "TrainingRunner", _Runner)
        assert mod.main(argv + extra) == 0
        fns.append(_Runner.batch_fn)
    return fns


@pytest.mark.parametrize("arch", FRONTENDS)
def test_driver_batches_equal_reference(monkeypatch, tmp_path, arch):
    """Frames and patches (and the VLM's text) of both drivers for a few
    steps: the arrays before the cast bitwise, then the batches each
    driver feeds its step bitwise (float32 and int32)."""
    cfg = get_smoke_config(arch)
    batch, seq = 3, 24
    jfn, tfn = _driver_batch_fns(monkeypatch, tmp_path, arch, batch, seq)
    data = SyntheticLM(cfg.vocab, seq, batch, seed=0)
    for step in range(3):
        raw = []

        def record(x, dtype=None):
            raw.append(np.asarray(x))
            return jnp.asarray(x, dtype)

        with monkeypatch.context() as m:
            m.setattr(jtrain, "jnp", type("jnp", (), {
                "asarray": staticmethod(record), "int32": jnp.int32}))
            want = jfn(step)
        got = train.train_batch(cfg, data, step, batch, seq)
        assert list(got) == list(want)
        for (k, v), r in zip(got.items(), raw):
            assert v.dtype == r.dtype and v.shape == r.shape, k
            np.testing.assert_array_equal(v, r)
        fed = tfn(step)
        assert fed.keys() == want.keys()
        for k, w in want.items():
            assert fed[k].dtype == {"float32": torch.float32,
                                    "int32": torch.int32}[str(w.dtype)]
            np.testing.assert_array_equal(fed[k].numpy(), np.asarray(w))
    s_text = seq - cfg.n_patches
    if cfg.frontend == "patches":
        assert got["tokens"].shape == got["targets"].shape == (batch, s_text)
        assert got["patches"].shape == (batch, cfg.n_patches, cfg.d_model)
    else:
        assert got["frames"].shape == (batch, seq, cfg.d_model)
