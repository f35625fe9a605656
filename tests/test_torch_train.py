"""The port's training path against the reference's, on the CPU.

The same numpy inputs and the reference's ``init_params`` draws go through
``repro`` (JAX) and ``repro_torch`` (the plain PyTorch versions of the
kernels, since the tensors lie on the CPU): the loss and its gradients,
the train step (clip, cosine schedule, AdamW), the synthetic data,
checkpoints both ways, the fault-tolerant runner and the training driver.
The backward kernel itself runs only on a GPU: its tests are in
``test_torch_cuda.py``.
"""
import pathlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hyp import given, settings, st  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch.sharding import TrainStep as JTrainStep  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.runtime import quantize_int8 as jquantize_int8  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint.store import latest_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticLM, make_batch_specs  # noqa: E402
from repro_torch.launch import sharding, train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               clip_by_global_norm, cosine_schedule)
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.runtime import (FaultInjector,  # noqa: E402
                                 HeartbeatMonitor, TrainingRunner,
                                 compressed_grad_tree, dequantize_int8,
                                 quantize_int8)
from repro_torch.runtime.fault import WorkerFailure  # noqa: E402

ARCH = "h2o_danube3_4b"
#: per-leaf relative Frobenius error of the port's gradients against the
#: reference's: float32 sums in other orders through two layers and a
#: 256-way softmax
GRAD_RTOL = 1e-4
#: per-leaf relative Frobenius error of the parameters after three steps
PARAM_RTOL = 1e-5
#: the train step's hyperparameters: the schedule's warmup ends at step 1,
#: so the three steps move the parameters by about 1e-2 each
STEP_KW = dict(peak_lr=1e-2, warmup=1, total_steps=10)
SHAPE = ShapeSpec("t", "train", 128, 2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want) -> float:
    want = _np(want)
    return float(np.linalg.norm(_np(got) - want) /
                 max(np.linalg.norm(want), 1e-30))


def _one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


_REF = {}


def _params(arch):
    """The reference's init_params draws, and the same weights in the
    port (a fresh copy: the port's step updates them in place)."""
    if arch not in _REF:
        _REF[arch] = JM.init_params(jax_smoke_config(arch),
                                    jax.random.PRNGKey(1))
    jp = _REF[arch]
    return jp, M.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")


def _batch(cfg, step=0, seq=128, batch=2):
    """The driver's batch (frames and patches for the frontends), float
    fields float32 and integer fields int32."""
    b = train.train_batch(cfg, SyntheticLM(cfg.vocab, seq, batch, seed=3),
                          step, batch, seq)
    return {k: v.astype(np.float32 if v.dtype.kind == "f" else np.int32)
            for k, v in b.items()}


def _port_loss_and_grads(cfg, tp, batch, remat=True):
    live = {k: ({n: w.detach().requires_grad_() for n, w in v.items()}
                if isinstance(v, dict) else v.detach().requires_grad_())
            for k, v in tp.items()}
    loss, _ = M.loss_fn(cfg, live, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(live),
                                materialize_grads=True)
    return float(loss.detach()), grads


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,overrides", [
    pytest.param(a, {}, id=a) for a in (ARCH, "llama3_2_3b", "phi3_5_moe",
                                        "mixtral_8x7b", "falcon_mamba_7b",
                                        "zamba2_2_7b", "hubert_xlarge",
                                        "internvl2_2b")] + [
    pytest.param("phi3_5_moe", {"moe_capacity_factor": 1.0},
                 id="phi3_5_moe-capacity_factor_1")])
def test_loss_and_gradients_match_reference(arch, overrides):
    """h2o and mixtral at S = 128 > window 32 take the band path (the
    backward of ``ops.banded_attention``); llama takes the chunked path
    (autograd of plain PyTorch).  The MoE configs add the aux loss and the
    router's gradients through the gates and the aux loss, at capacity
    factor 8 (the smoke configs') and at 1, where 25 and 34 of the 512
    (token, slot) pairs of the two layers are dropped; falcon-mamba and
    zamba2 run the chunked scans and zamba2's nested remat (each group,
    each mamba layer).  hubert-xlarge trains on frames through
    bidirectional attention (its unused ``embed`` gets zero gradients, as
    under ``jax.grad``), internvl2-2b on patches and text with the loss
    over the text positions."""
    cfg = get_smoke_config(arch).scaled(**overrides)
    jcfg = jax_smoke_config(arch).scaled(**overrides)
    jp, tp = _params(arch)
    batch = _batch(cfg)
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, grads = _port_loss_and_grads(cfg, tp, batch)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        assert g.shape == jg.shape
        assert _rel(g, jg) <= GRAD_RTOL


@pytest.mark.parametrize("arch", [ARCH, "mixtral_8x7b", "zamba2_2_7b"])
def test_remat_gives_the_same_gradients_bitwise(arch):
    """Remat changes no bit of the loss or the gradients: h2o's blocks,
    mixtral's, whose checkpointed block returns (x, aux), and zamba2's
    nested checkpoints (each group, each mamba layer in it)."""
    cfg = get_smoke_config(arch)
    _, tp = _params(arch)
    batch = _batch(cfg, step=1)
    l1, g1 = _port_loss_and_grads(cfg, tp, batch, remat=True)
    l0, g0 = _port_loss_and_grads(cfg, tp, batch, remat=False)
    assert l1 == l0
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


def test_banded_attention_cpu_gradient_matches_reference_autodiff():
    """``ops.banded_attention``'s CPU backward (through
    ``layers.windowed_attention``) against ``jax.vjp`` of the reference's
    ``layers.windowed_attention``, float32, k and v with fewer heads."""
    rng = np.random.default_rng(4)
    b, s, kv, g, hd = 2, 64, 2, 2, 16
    q = rng.standard_normal((b, s, kv, g, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, s, kv, g, hd)).astype(np.float32)
    for causal in (True, False):
        want = jax.jit(lambda q, k, v, do: jax.vjp(
            lambda q, k, v: JL.windowed_attention(
                q, k, v, window=16, causal=causal, block=16),
            q, k, v)[1](do))(q, k, v, do)
        tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        out = L.windowed_attention(tq, tk, tv, window=16, causal=causal,
                                   block=16)
        got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
        for a, w in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(w), atol=2e-5)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

_REF_STEPS = {}


def _ref_step_for(arch):
    """The reference's train step of an arch's smoke config on a one-device
    mesh, jitted once."""
    if arch not in _REF_STEPS:
        builder = JTrainStep(jax_smoke_config(arch), _one_device_mesh(),
                             **STEP_KW)
        _REF_STEPS[arch] = jax.jit(builder.step_fn(SHAPE))
    return _REF_STEPS[arch]


@pytest.fixture(scope="module")
def ref_step():
    """The reference's train step on a one-device mesh, jitted once."""
    return _ref_step_for(ARCH)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_train_step_matches_reference(ref_step):
    """Three steps of clip, cosine schedule and AdamW: parameters within
    PARAM_RTOL a leaf, the learning rate equal, the gradient norm and the
    loss within 1e-5."""
    cfg = get_smoke_config(ARCH)
    jp, tp = _params(ARCH)
    jopt, topt = jadamw_init(jp), adamw_init(tp)
    step = sharding.TrainStep(cfg, **STEP_KW).step_fn(SHAPE)
    data = SyntheticLM(cfg.vocab, SHAPE.seq_len, SHAPE.global_batch, seed=3)
    for i in range(3):
        b = data.batch_at(i)
        jp, jopt, jm = ref_step(jp, jopt, _jbatch(b))
        tp, topt, tm = step(tp, topt, _tbatch(b))
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert int(topt.step) == int(jopt.step) == 3
    for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert _rel(got, want) <= PARAM_RTOL
    for got, want in zip(tree_leaves(topt.m) + tree_leaves(topt.v),
                         jax.tree_util.tree_leaves((jopt.m, jopt.v))):
        assert got.dtype == torch.float32
        assert _rel(got, want) <= GRAD_RTOL


def test_microbatched_step_equals_the_reference_accumulation():
    """``microbatch=2`` splits the batch, sums float32 gradients and
    averages, as the reference's scan does."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jp, tp = _params(ARCH)
    shape = ShapeSpec("t", "train", 64, 4)
    b = SyntheticLM(cfg.vocab, 64, 4, seed=5).batch_at(0)
    jstep = jax.jit(JTrainStep(jcfg, _one_device_mesh(), microbatch=2,
                               **STEP_KW).step_fn(shape))
    builder = sharding.TrainStep(cfg, microbatch=2, **STEP_KW)
    assert builder.auto_microbatch(shape) == 2
    jp, _, jm = jstep(jp, jadamw_init(jp), _jbatch(b))
    tp, _, tm = builder.step_fn(shape)(tp, adamw_init(tp), _tbatch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)


def test_sharded_pieces_raise_naming_the_roadmap():
    """Every sharded piece runs now: ``ServeStep``, ``make_prefill_fn``
    and a ``TrainStep`` over a model axis build
    (tests/test_torch_tensor_parallel.py runs them on ranks), and the dry
    run's ``abstract_inputs`` return the rank's blocks as meta tensors
    (tests/test_torch_dryrun.py holds them against the reference's shard
    shapes).  The name is kept from when they raised.  The spec tables,
    batch specs and the data-parallel step run
    (tests/test_torch_sharding.py)."""
    cfg = get_smoke_config(ARCH)
    mesh = {"data": 1, "model": 2}
    assert sharding.TrainStep(cfg, mesh).n_model == 2
    assert sharding.make_prefill_fn(cfg, None).tp is None
    serve = sharding.ServeStep(cfg, mesh, SHAPE)
    assert set(serve.cache_shardings()) == {"k", "v"}
    params, token, cache, pos = serve.abstract_inputs()
    params2, opt, batch = sharding.TrainStep(cfg, mesh).abstract_inputs(SHAPE)
    leaves = [*tree_leaves(params), token, *cache.values(), pos,
              *tree_leaves(params2), opt.step, *tree_leaves(opt.m),
              *tree_leaves(opt.v), *batch.values()]
    assert all(t.device.type == "meta" for t in leaves)
    assert params["layers"]["wq"].shape[-1] * 2 == \
        M.param_shapes(cfg)["layers"]["wq"][-1]
    assert pos.shape == () and pos.dtype == torch.int32
    assert opt.step.shape == () and opt.step.dtype == torch.int32
    assert sharding.batch_axes(None) == ()
    assert sharding.TrainStep(cfg).auto_microbatch(SHAPE) == 1
    assert make_batch_specs(cfg, SHAPE, None, ("data",))["tokens"].spec == \
        ("data",)


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_shards", [(0, 1), (7, 2), (3, 4)])
def test_synthetic_batches_equal_reference_bitwise(seed, n_shards):
    kw = dict(vocab=1000, seq_len=96, global_batch=8, seed=seed,
              mean_doc_len=40.0)
    got, want = SyntheticLM(**kw), JSyntheticLM(**kw)
    for step in (0, 1, 5, 123):
        for shard in range(n_shards):
            a = got.batch_at(step, shard, n_shards)
            b = want.batch_at(step, shard, n_shards)
            for key in ("tokens", "targets"):
                assert a[key].dtype == b[key].dtype
                assert np.array_equal(a[key], b[key])


def _train_state_like(tp, topt):
    return (0, (tp, topt))


@pytest.mark.parametrize("arch,direction", [
    pytest.param(a, d, id=d if a == ARCH else f"{a}-{d}")
    for a in (ARCH, "phi3_5_moe", "zamba2_2_7b")
    for d in ("reference_to_port", "port_to_reference")])
def test_checkpoints_cross_and_training_continues(tmp_path, arch,
                                                   direction):
    """Two reference steps, a checkpoint of ``(step, (params, opt))`` in
    the runner's layout, a restore on the other side, then one step on
    each side from the same state: the same loss.  h2o's tree, an MoE
    tree (router and stacked experts) and the hybrid's (mamba2 leaves on
    two leading axes and the shared block)."""
    cfg = get_smoke_config(arch)
    ref_step = _ref_step_for(arch)
    jp, tp = _params(arch)
    jopt = jadamw_init(jp)
    data = SyntheticLM(cfg.vocab, SHAPE.seq_len, SHAPE.global_batch, seed=3)
    for i in range(2):
        jp, jopt, _ = ref_step(jp, jopt, _jbatch(data.batch_at(i)))
    like_t = _train_state_like(tp, adamw_init(tp))
    if direction == "reference_to_port":
        jckpt.save_checkpoint(tmp_path, 2, (2, (jp, jopt)))
        (step, (tp, topt)), n = ckpt.load_checkpoint(tmp_path, 2, like_t)
    else:
        tp = M.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
        topt = M.adamw_state_from_numpy(
            np.asarray(jopt.step), jax.tree_util.tree_map(np.asarray,
                                                          jopt.m),
            jax.tree_util.tree_map(np.asarray, jopt.v), device="cpu")
        ckpt.save_checkpoint(tmp_path, 2, (2, (tp, topt)))
        like_j = (0, (jp, jopt))
        (step, (jp, jopt)), n = jckpt.load_checkpoint(tmp_path, 2, like_j)
    assert int(np.asarray(step)) == n == 2
    assert int(topt.step) == int(jopt.step) == 2
    for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert got.dtype == torch.float32
        assert _rel(got, want) == 0.0
    b = data.batch_at(2)
    _, _, jm = ref_step(jp, jopt, _jbatch(b))
    _, _, tm = sharding.TrainStep(cfg, **STEP_KW).step_fn(SHAPE)(
        tp, topt, _tbatch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)


class TestCheckpoint:
    def _tree(self, seed=0):
        rng = np.random.default_rng(seed)
        return {"w": torch.tensor(rng.standard_normal((4, 4)),
                                  dtype=torch.float32),
                "b": {"x": torch.tensor(rng.standard_normal(3),
                                        dtype=torch.bfloat16)}}

    def test_roundtrip(self, tmp_path):
        tree = self._tree()
        ckpt.save_checkpoint(tmp_path, 5, tree)
        out, step = ckpt.load_checkpoint(tmp_path, 5, self._tree(1))
        assert step == 5
        for a, b in zip(tree_leaves(tree), tree_leaves(out)):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)

    def test_uncommitted_ignored(self, tmp_path):
        ckpt.save_checkpoint(tmp_path, 1, self._tree())
        (tmp_path / "step_00000002").mkdir()
        assert latest_step(tmp_path) == 1

    def test_manager_retention_and_restore(self, tmp_path):
        mgr = ckpt.CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, self._tree(s), blocking=True)
        mgr.wait()
        assert latest_step(tmp_path) == 4
        steps = sorted(int(p.stem.split("_")[1])
                       for p in pathlib.Path(tmp_path).glob(
                           "step_*.COMMITTED"))
        assert steps == [3, 4]
        out, step = mgr.restore_latest(self._tree())
        assert step == 4
        assert torch.equal(out["w"], self._tree(4)["w"])

    def test_async_save_snapshots_before_returning(self, tmp_path):
        """The tree is copied on the caller's thread: an in-place update
        right after ``save`` does not reach the checkpoint."""
        mgr = ckpt.CheckpointManager(tmp_path, keep=1)
        tree = self._tree(7)
        want = tree["w"].clone()
        mgr.save(7, tree, blocking=False)
        tree["w"].add_(1.0)
        mgr.wait()
        assert latest_step(tmp_path) == 7
        out, _ = mgr.restore_latest(self._tree())
        assert torch.equal(out["w"], want)


# ---------------------------------------------------------------------------
# the optimizer (ports of test_substrate.py::TestAdamW)
# ---------------------------------------------------------------------------

class TestAdamW:
    def test_converges_quadratic(self):
        target = torch.tensor([1.0, -2.0, 3.0])
        params = {"w": torch.zeros(3)}
        opt = adamw_init(params)
        for _ in range(300):
            g = {"w": 2 * (params["w"] - target)}
            params, opt = adamw_update(params, g, opt, lr=0.05,
                                       weight_decay=0.0)
        np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                                   atol=1e-2)

    def test_moments_are_f32_for_bf16_params(self):
        params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
        opt = adamw_init(params)
        assert opt.m["w"].dtype == torch.float32
        g = {"w": torch.ones(4, dtype=torch.bfloat16)}
        p2, opt2 = adamw_update(params, g, opt, lr=0.1)
        assert p2["w"].dtype == torch.bfloat16
        assert opt2.v["w"].dtype == torch.float32
        assert opt2.step.dtype == torch.int32 and int(opt2.step) == 1

    def test_weight_decay_pulls_to_zero(self):
        params = {"w": torch.ones(4) * 10}
        opt = adamw_init(params)
        g = {"w": torch.zeros(4)}
        for _ in range(50):
            params, opt = adamw_update(params, g, opt, lr=0.1,
                                       weight_decay=0.5)
        assert params["w"].abs().max() < 10

    def test_clip_global_norm(self):
        g = {"a": torch.ones(4) * 100, "b": torch.ones(2) * 100}
        clipped, gn = clip_by_global_norm(g, 1.0)
        total = np.sqrt(sum(float((x ** 2).sum())
                            for x in tree_leaves(clipped)))
        np.testing.assert_allclose(total, 1.0, rtol=1e-5)
        assert float(gn) > 1.0

    def test_cosine_schedule(self):
        def lr(s):
            return float(cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                         peak_lr=1.0, warmup=10, total=100))
        assert lr(0) == 0.0
        np.testing.assert_allclose(lr(10), 1.0, atol=0.01)
        np.testing.assert_allclose(lr(100), 0.1, atol=0.01)

    def test_update_of_a_large_leaf_works_in_slabs(self, monkeypatch):
        """Slabs change where the temporaries live, not the update (an
        elementwise step: bitwise equal); the clipping norm sums the slabs'
        float32 sums, so it moves by rounding only."""
        from repro_torch.optim import adamw as A
        rng = np.random.default_rng(0)
        p = torch.tensor(rng.standard_normal(1000), dtype=torch.bfloat16)
        g = torch.tensor(rng.standard_normal(1000), dtype=torch.bfloat16)
        outs = []
        for slab in (A.SLAB, 64):
            monkeypatch.setattr(A, "SLAB", slab)
            _, gn = clip_by_global_norm({"w": g.clone()}, 1.0)
            pc, opt = adamw_update({"w": p.clone()}, {"w": g}, adamw_init(
                {"w": p}), lr=0.1)
            outs.append((float(gn), pc["w"], opt.m["w"], opt.v["w"]))
        np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-6)
        for a, b in zip(outs[0][1:], outs[1][1:]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the runtime (ports of test_substrate.py::TestRuntime)
# ---------------------------------------------------------------------------

class TestRuntime:
    def test_heartbeat_failure_detection(self):
        mon = HeartbeatMonitor(n_workers=3, timeout=0.0)
        mon.beat(0)
        time.sleep(0.01)
        assert 1 in mon.failed_workers()
        assert 2 in mon.failed_workers()

    def test_straggler_detection(self):
        mon = HeartbeatMonitor(n_workers=4, straggler_factor=2.0)
        for w in range(4):
            for _ in range(5):
                mon.beat(w, step_time=1.0 if w != 3 else 5.0)
        assert mon.stragglers() == [3]

    def test_fault_injector(self):
        inj = FaultInjector({3: 1})
        inj.check(2)
        with pytest.raises(WorkerFailure):
            inj.check(3)
        inj.check(3)  # consumed

    def test_training_runner_restart_resumes(self, tmp_path):
        """Counter 'model': the state increments a step; a failure at step
        12 restores the step-10 checkpoint and finishes with the exact
        total."""
        def step_fn(state, batch):
            return state + 1, {"loss": float(100 - state)}

        runner = TrainingRunner(
            step_fn, lambda s: None, ckpt.CheckpointManager(tmp_path, keep=2),
            ckpt_every=5, injector=FaultInjector({12: 0}))
        state, hist = runner.run(torch.tensor(0, dtype=torch.int32), 20)
        assert int(state) == 20
        assert hist["restarts"] == 1 and hist["restored_from"] == [10]

    def test_training_runner_no_checkpoint_restarts_from_zero(self,
                                                              tmp_path):
        def step_fn(state, batch):
            return state + 1, {"loss": 0.0}

        runner = TrainingRunner(
            step_fn, lambda s: None, ckpt.CheckpointManager(tmp_path, keep=2),
            ckpt_every=100, injector=FaultInjector({3: 0}))
        state, hist = runner.run(torch.tensor(0, dtype=torch.int32), 10)
        assert int(state) == 10
        assert hist["restarts"] == 1

    def test_compression_error_bound(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal(1000).astype(np.float32)
        q, s = quantize_int8(torch.from_numpy(x))
        back = dequantize_int8(q, s)
        err = float((back - torch.from_numpy(x)).abs().max())
        assert err <= float(s) / 2 + 1e-7       # half-ULP of the grid
        assert q.dtype == torch.int8
        jq, js = jquantize_int8(jnp.asarray(x))
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)

    def test_compressed_tree_shapes_dtypes(self):
        tree = {"a": torch.ones((3, 3), dtype=torch.bfloat16),
                "b": torch.ones(5)}
        out = compressed_grad_tree(tree)
        assert out["a"].dtype == torch.bfloat16
        assert out["b"].shape == (5,)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10000), scale=st.floats(1e-3, 1e3))
def test_property_quantization_relative_error(seed, scale):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.standard_normal(256) * scale).astype(
        np.float32))
    q, s = quantize_int8(g)
    back = dequantize_int8(q, s)
    # max error bounded by half a quantization step
    assert float((back - g).abs().max()) <= float(s) * 0.5 + 1e-6


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mixtral_8x7b"])
def test_train_main_drill_restarts_once_and_loss_falls(tmp_path, capsys,
                                                       arch):
    rc = train.main(["--arch", arch, "--smoke", "--seq", "128",
                     "--batch", "2", "--steps", "30", "--drill-fail-step",
                     "12", "--ckpt-every", "5", "--ckpt-dir", str(tmp_path),
                     "--device", "cpu", "--compress-grads"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "restarts=1" in out and "steps=32" in out
    assert latest_step(tmp_path) == 30


def test_train_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "h2o-danube-3-4b", "--smoke", "--steps", "1"])
