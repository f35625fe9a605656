"""Tensor parallelism and ZeRO-1 of the port (``launch/sharding.py`` on a
model axis, ``ServeStep``, ``make_prefill_fn``), ``reshard_tree``,
``make_production_mesh`` and the sharded checkpoint restore.

Two kinds of check:

* **On gloo CPU ranks** (``tests/torch_dist_scenarios.py``, one spawn of 4
  ranks and one of 8 for the module): every smoke config (and phi3.5-moe
  scaled to 16 experts, the expert-parallel case) on (data 2, model 2) and
  (data 1, model 4), each rank holding the blocks of the spec tables and
  comparing itself with the one-device step, decode and forward on the
  whole batch.  The reference's own sharded step cannot run under this
  JAX (ROADMAP.md §3), but its one-device functions do: for one
  architecture of each family the ranks save their loss, gradient
  blocks, prefill and decode logits, and this process holds them against
  the reference's ``loss_fn``, ``forward`` and ``decode_step`` on the
  same weights (the port's package imports no JAX, on the ranks too).
* **Without ranks**: the cache and optimizer specs against the
  reference's on abstract meshes of the production layouts, the
  production mesh's layout, and blocks that rebuild every leaf.
"""
import atexit
import functools
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import mesh as JMesh  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.models.config import ALL_SHAPES as J_SHAPES  # noqa: E402
from repro.models.config import applicable_shapes as j_shapes  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, \
    save_checkpoint  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as PMesh  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ALL_SHAPES  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402
from repro_torch.runtime import reshard_tree  # noqa: E402
from test_torch_sharding import LAYOUTS, ROOT, SCRIPT, _meshes, \
    _ref_specs  # noqa: E402
from torch_dist_scenarios import TP_DECODE, TP_REF, tp_config  # noqa: E402

#: the one-device step's float32 tolerance (tests/test_torch_train.py)
RTOL = 1e-5
#: the port's gradients and logits against the reference's one-device
#: functions: tests/test_torch_train.py's GRAD_RTOL and
#: tests/test_torch_lm.py's LOGIT_ATOL
REF_GRAD_RTOL, REF_LOGIT_ATOL = 1e-4, 1e-4
#: the parameters after one step against the one-device step's, whole
#: tree: AdamW's first update is about lr * sign(g), which turns the
#: gradients' float32 rounding (up to 4.5e-6 here, zamba2) into up to
#: 1.3e-5 of the parameters; the update itself is held at RTOL
#: (``params_update``)
STEP_PARAMS_RTOL = 1e-4
TRAIN = ("llama3_2_3b", "stablelm_12b", "h2o_danube3_4b", "olmo_1b",
         "phi3_5_moe", "phi3_5_moe_e16", "mixtral_8x7b", "hubert_xlarge",
         "falcon_mamba_7b", "zamba2_2_7b", "internvl2_2b")
SERVE = ("h2o_danube3_4b", "h2o_danube3_4b_hd6", "mixtral_8x7b",
         "phi3_5_moe_e16",
         "falcon_mamba_7b", "zamba2_2_7b", "internvl2_2b")
TP = ("d2m2", "d1m4")


#: where the ranks of ``_tp`` save what the reference comparison reads
DUMP = pathlib.Path(tempfile.mkdtemp(prefix="tp_dump_"))
atexit.register(shutil.rmtree, DUMP, True)


def _spawn(p: int, scenario: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               TP_DUMP=str(DUMP))
    res = subprocess.run([sys.executable, str(SCRIPT), str(p), scenario],
                         capture_output=True, text=True, env=env,
                         timeout=240)
    assert res.returncode == 0, \
        f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}"
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])[scenario]


@functools.lru_cache(maxsize=None)
def _tp() -> dict:
    """Every rank's numbers of every case: one spawn of 4 ranks."""
    return _spawn(4, "tensor_parallel")


# ---------------------------------------------------------------------------
# on ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TRAIN)
@pytest.mark.parametrize("layout", TP)
def test_train_step_equals_the_one_device_step(layout, arch):
    """``TrainStep(cfg, mesh, zero1=True)`` on a rank's parameter blocks
    and batch rows: loss, metrics, gradient blocks, the gradient norm and
    the ZeRO-1 moment slices after one step within 1e-5 of the one-device
    step on the whole batch; the update equal to the one-device AdamW on
    the rank's blocks given its gradients; the parameters equal across
    the data ranks and the moments a 1/|data| slice; a run with the
    layers' second all-reduce skipped misses."""
    ranks = _tp()[f"train/{layout}/{arch}_by_rank"]
    assert len(ranks) == 4
    n_data = int(layout[1])
    for r in ranks:
        for key in ("loss", "metrics", "grads", "step_loss", "grad_norm",
                    "moments", "params_update"):
            assert r[key] <= RTOL, (key, r)
        assert r["params"] <= STEP_PARAMS_RTOL, r
        assert r["across_data_ranks"] == 0.0
        assert r["moment_elems"] * n_data == r["param_elems"]
        # ZeRO-1 reduce-scatters the gradients and all-gathers the
        # parameters: the bytes of the all-reduce step, plus the clip's
        # float32 sum of squares over the data ranks (a ring's 2 (p-1)/p)
        clip = 2 * (n_data - 1) * 4 // n_data
        assert r["comm_bytes"] == r["plain_comm_bytes"] + clip > 0, r
        assert r["control"] > 100 * RTOL, r


@pytest.mark.parametrize("arch", SERVE)
@pytest.mark.parametrize("layout", TP)
def test_serve_step_and_prefill_equal_one_device(layout, arch):
    """``ServeStep`` at batch 4, teacher-forced for 8 tokens: each step's
    logits of the rank's rows and its cache blocks against the one-device
    ``decode_step``; ``make_prefill_fn``'s logits against the one-device
    forward; a prefill that skips one all-reduce misses."""
    for r in _tp()[f"serve/{layout}/{arch}_by_rank"]:
        for key in ("decode", "cache", "prefill"):
            assert r[key] <= RTOL, (key, r)
        assert r["prefill_control"] > 100 * RTOL, r


@pytest.mark.parametrize("arch", SERVE)
def test_sequence_sharded_decode_equals_one_device(arch):
    """Batch 1 on (data 2, model 2): the cache sharded along the sequence
    over the data axis (``cache_shardings``' long-context case), the
    softmax combined across the data ranks, and the mamba states
    replicated there."""
    for r in _tp()[f"serve_b1/d2m2/{arch}_by_rank"]:
        assert r["decode"] <= RTOL and r["cache"] <= RTOL, r


@pytest.mark.parametrize("layout,arch,want", [
    ("d2m2", "h2o_danube3_4b", []),
    ("d2m2", "llama3_2_3b", []),
    ("d1m4", "llama3_2_3b", ["wk", "wv"]),
    ("d2m2", "falcon_mamba_7b", ["in_proj"]),
    ("d1m4", "zamba2_2_7b", ["conv", "in_proj"]),
])
def test_gathered_leaves_are_named(layout, arch, want):
    """Where the stored block is the layer's slice nothing is gathered;
    kv heads split inside hd (2 kv heads at model 4), mamba1's [x | z] and
    mamba2's [z | x | B | C | dt] in_proj and its conv are."""
    for r in _tp()[f"train/{layout}/{arch}_by_rank"]:
        assert r["gathered"] == want
    if arch in SERVE:
        for r in _tp()[f"serve/{layout}/{arch}_by_rank"]:
            assert r["prefill_gathered"] == want


@pytest.mark.parametrize("layout", TP)
def test_moe_reshard_axis_changes_how_partial_sums_reduce(layout):
    """``set_moe_reshard_axis("model")`` is the reference's layout hint
    to GSPMD; the port stores it, and the down-projection's partial sums
    are reduced as without it: the prefill of mixtral's ff-sharded and
    phi3.5-moe's expert-parallel layers moves the same bytes and equals
    the one-device forward."""
    for arch in ("mixtral_8x7b", "phi3_5_moe_e16"):
        for r in _tp()[f"serve/{layout}/{arch}_by_rank"]:
            assert r["prefill_reshard"] <= RTOL, r
            hinted, plain = r["reshard_bytes"]
            assert hinted == plain > 0, r


def _rank_dumps(kind: str, layout: str, arch: str) -> list:
    _tp()
    return [torch.load(DUMP / f"{kind}_{layout}_{arch}.r{r}.pt")
            for r in range(4)]


def _jnp(x: torch.Tensor):
    a = x.numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype.kind in "iu" else a)


@functools.lru_cache(maxsize=None)
def _reference(arch: str) -> dict:
    """The reference's one-device loss and gradients of the train case's
    batch, forward logits of the serve case's batch and the logits of
    each decode step, on the weights the ranks start from."""
    cfg = tp_config(arch)
    jcfg = jax_smoke_config("phi3_5_moe").scaled(n_experts=16) \
        if arch == "phi3_5_moe_e16" else jax_smoke_config(arch)
    full = M.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    jp = jax.tree_util.tree_map(_jnp, full)
    train = _rank_dumps("train", "d2m2", arch)[0]
    serve = _rank_dumps("serve", "d2m2", arch)[0]
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b), has_aux=True))(
            jp, {k: _jnp(v) for k, v in train["batch"].items()})
    logits, _ = JM.forward(jcfg, jp, {k: _jnp(v) for k, v in
                                      serve["batch"].items()}, remat=False)
    toks = serve["tokens"]
    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(jcfg, p, tok, c,
                                                         pos))
    cache, steps = JM.init_cache(jcfg, toks.shape[0], TP_DECODE), []
    for pos in range(TP_DECODE):
        out, cache = jstep(jp, _jnp(toks[:, pos]), cache, jnp.int32(pos))
        steps.append(np.asarray(out))
    return {"train_batch": train["batch"], "serve_batch": serve["batch"],
            "tokens": toks, "loss": float(loss),
            "grads": jax.tree_util.tree_map(
                lambda g: torch.from_numpy(np.array(g)), grads),
            "prefill": np.asarray(logits), "decode": np.stack(steps)}


@pytest.mark.parametrize("arch", TP_REF)
@pytest.mark.parametrize("layout", TP)
def test_sharded_functions_match_the_reference(layout, arch):
    """One architecture of each family (dense, moe, mamba1, hybrid, VLM):
    every rank's loss and gradient blocks of ``TrainStep.grads_fn``,
    its rows of ``make_prefill_fn``'s logits and of each ``ServeStep``
    decode step against the reference's one-device ``loss_fn``,
    ``forward`` and ``decode_step`` on the same weights and inputs,
    within the tolerances of the port's one-device comparisons."""
    ref = _reference(arch)
    cfg = tp_config(arch)
    mesh = SMALL[layout]
    specs = S.param_shardings(cfg, mesh)
    for r in _rank_dumps("train", layout, arch):
        for k, v in ref["train_batch"].items():
            assert torch.equal(r["batch"][k], v)
        np.testing.assert_allclose(float(r["loss"]), ref["loss"], rtol=RTOL)
        for path, want in M._leaves(ref["grads"]):
            got, spec = r["grads"], specs
            for p in path:
                got, spec = got[p], spec[p]
            want = S.take_block(want, spec, mesh, r["coords"])
            assert got.shape == want.shape, path
            assert float((got - want).norm()) <= REF_GRAD_RTOL * max(
                float(want.norm()), 1e-30), (path, r["coords"])
    for r in _rank_dumps("serve", layout, arch):
        assert torch.equal(r["tokens"], ref["tokens"])
        rows = slice(*r["rows"])
        np.testing.assert_allclose(r["prefill"].numpy(),
                                   ref["prefill"][rows], atol=REF_LOGIT_ATOL)
        np.testing.assert_allclose(r["decode"].numpy(),
                                   ref["decode"][:, rows],
                                   atol=REF_LOGIT_ATOL)


def test_reshard_tree_gathers_then_takes_the_new_blocks():
    """zamba2's blocks on (data 2, model 2) -> (data 1, model 4): each
    rank's new blocks equal the whole leaves' blocks exactly."""
    assert _tp()["reshard_by_rank"] == [0.0] * 4


def test_make_production_mesh_names_the_world_it_needs():
    assert "needs a world of 256 ranks, this one has 4" in \
        _tp()["production_mesh"]


def test_sharded_train_step_on_8_ranks():
    """The port of ``tests/test_launch.py::TestTrainStepOn8Devices``:
    llama3.2-3b's smoke config on (data 4, model 2), ZeRO-1, the
    reference's defaults and batch, 4 steps: the loss falls, every rank
    agrees, and each loss is within 1e-5 of the one-device port's."""
    out = _spawn(8, "train_step_tp8")
    ranks = out["losses_by_rank"]
    assert len(ranks) == 8 and all(r == ranks[0] for r in ranks)
    l0, l1 = ranks[0][0], ranks[0][-1]
    assert np.isfinite(l0) and np.isfinite(l1) and l1 < l0, ranks[0]
    np.testing.assert_allclose(ranks[0], out["one_device"], rtol=RTOL)


# ---------------------------------------------------------------------------
# specs against the reference, without ranks
# ---------------------------------------------------------------------------

def _cache_shapes(arch):
    """The decode shapes the reference runs the full config on."""
    return [s.name for s in j_shapes(jax_config(arch)) if s.kind == "decode"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_equal_reference(arch, layout):
    """``ServeStep.cache_shardings()`` for every decode shape of every
    full config, the batch-1 sequence-sharded case included."""
    jmesh, mesh, _ = _meshes(layout)
    names = _cache_shapes(arch)
    for shape, jshape in zip(ALL_SHAPES, J_SHAPES):
        if shape.name not in names:
            continue
        want = _ref_specs(JS.ServeStep(jax_config(arch), jmesh,
                                       jshape).cache_shardings())
        assert S.ServeStep(get_config(arch), mesh,
                           shape).cache_shardings() == want


@pytest.mark.parametrize("zero1", [True, False])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_opt_shardings_equal_reference(layout, zero1):
    """``AdamWState(step=(), m=v=zero1_shardings)`` (the parameter specs
    without ZeRO-1), the parameter and the batch specs of every full
    config."""
    jmesh, mesh, _ = _meshes(layout)
    for arch in ARCH_IDS:
        want = JS.TrainStep(jax_config(arch), jmesh,
                            zero1=zero1).opt_shardings()
        got = S.TrainStep(get_config(arch), mesh, zero1=zero1).opt_shardings()
        assert isinstance(got, AdamWState)
        assert got.step == tuple(want.step.spec) == ()
        assert got.m == _ref_specs(want.m) and got.v == _ref_specs(want.v)
        assert S.TrainStep(get_config(arch), mesh).param_shardings() == \
            _ref_specs(JS.param_shardings(jax_config(arch), jmesh))
        want_b = JS.TrainStep(jax_config(arch), jmesh).batch_shardings(
            J_SHAPES[0])
        got_b = S.TrainStep(get_config(arch), mesh).batch_shardings(
            ALL_SHAPES[0])
        assert got_b.keys() == want_b.keys()
        for k, w in want_b.items():
            assert got_b[k].shape == w.shape
            assert got_b[k].spec == tuple(w.sharding.spec), (arch, k)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_layout_equals_reference(monkeypatch, multi_pod):
    """The reference builds its mesh with ``jax.make_mesh(shape, axes)``;
    the port asks for the same shape and names of a world of that size,
    and a world of another size is refused naming the size."""
    monkeypatch.setattr(JMesh.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    want = JMesh.make_production_mesh(multi_pod=multi_pod)
    assert PMesh.production_layout(multi_pod) == want
    with pytest.raises(ValueError, match=f"world of {int(np.prod(want[0]))}"
                                         f" ranks, this one has 1"):
        PMesh.make_production_mesh(multi_pod=multi_pod)


def _coords(mesh: dict):
    """Every rank's coordinates of a mesh given as ``{axis: size}``."""
    names = list(mesh)
    for idx in np.ndindex(*mesh.values()):
        yield dict(zip(names, idx))


def _assemble(blocks: list, shape, spec, mesh: dict) -> torch.Tensor:
    """A whole leaf from every rank's block (replicas must agree)."""
    out = torch.full(shape, float("nan"))
    for coords, blk in zip(_coords(mesh), blocks):
        cut = tuple(slice(a, a + n) for a, n in
                    S.block_slices(shape, spec, mesh, coords))
        seen = out[cut]
        assert torch.isnan(seen).all() or torch.equal(seen, blk.float())
        out[cut] = blk.float()
    return out


SMALL = {"d2m2": {"data": 2, "model": 2}, "d1m4": {"data": 1, "model": 4},
         "p2d2m2": {"pod": 2, "data": 2, "model": 2}}


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "phi3_5_moe",
                                  "falcon_mamba_7b", "zamba2_2_7b",
                                  "internvl2_2b"])
def test_blocks_and_reshard_tree_rebuild_every_leaf(arch):
    """Whole leaves -> every rank's blocks by ``reshard_tree`` on each
    layout: together they rebuild each leaf exactly, and each block is
    the one its coordinates name."""
    cfg = get_smoke_config(arch)
    full = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    for mesh in SMALL.values():
        specs = S.param_shardings(cfg, mesh)
        per_rank = [reshard_tree(full, cfg, mesh, coords=c)
                    for c in _coords(mesh)]

        def walk(node, spec, path):
            for k, leaf in node.items():
                if isinstance(leaf, dict):
                    walk(leaf, spec[k], path + (k,))
                    continue
                blocks = [r for r in per_rank]
                for p in path + (k,):
                    blocks = [b[p] for b in blocks]
                assert torch.equal(_assemble(blocks, leaf.shape, spec[k],
                                             mesh), leaf.float()), k
        walk(full, specs, ())


def test_checkpoint_saved_on_one_layout_restores_onto_another(tmp_path):
    """zamba2's parameters and ZeRO-1 moments held as (data 2, model 2)
    blocks, assembled whole and saved; restored with ``shardings=`` onto
    (data 1, model 4) and (pod 2, data 2, model 2): every rank's blocks
    rebuild every leaf exactly."""
    cfg = get_smoke_config("zamba2_2_7b")
    full = M.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    src = SMALL["d2m2"]
    specs = S.param_shardings(cfg, src)
    blocks = [S.tree_blocks(full, specs, src, c) for c in _coords(src)]
    saved = _unblock(cfg, blocks, src)      # what a save gathers
    state = AdamWState(step=torch.tensor(3, dtype=torch.int32), m=saved,
                       v=saved)
    save_checkpoint(tmp_path, 7, {"params": saved, "opt": state})
    for name in ("d1m4", "p2d2m2"):
        dst = SMALL[name]
        pspec = S.param_shardings(cfg, dst)
        zspec = S.TrainStep(cfg, dst).opt_shardings()
        restored = []
        for c in _coords(dst):
            tree, step = load_checkpoint(
                tmp_path, 7, {"params": full, "opt": state},
                shardings={"params": pspec, "opt": zspec}, mesh=dst,
                coords=c)
            assert step == 7 and int(tree["opt"].step) == 3
            restored.append(tree)
        for key, spec_tree in (("params", pspec), ("m", zspec.m)):
            for path, leaf in M._leaves(full):
                spec = spec_tree
                for p in path:
                    spec = spec[p]
                got = []
                for tree in restored:
                    node = tree["params"] if key == "params" \
                        else tree["opt"].m
                    for p in path:
                        node = node[p]
                    got.append(node)
                assert torch.equal(_assemble(got, leaf.shape, spec, dst),
                                   leaf.float()), (name, key, path)


def _unblock(cfg, blocks: list, mesh: dict) -> dict:
    """The whole tree from every rank's blocks."""
    specs = S.param_shardings(cfg, mesh)
    out: dict = {}
    for path, shape in M._leaves(M.param_shapes(cfg)):
        spec, parts = specs, list(blocks)
        for p in path:
            spec = spec[p]
            parts = [b[p] for b in parts]
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _assemble(parts, shape, spec, mesh)
    return out


# ---------------------------------------------------------------------------
# what used to raise
# ---------------------------------------------------------------------------

def test_sharded_entry_points_build_on_a_model_axis():
    """A model axis larger than 1 builds (its groups wait for the first
    step); ``abstract_inputs``, the dry run's inputs, gives the rank's
    meta blocks without a process group (tests/test_torch_dryrun.py holds
    them against the reference's shard shapes)."""
    cfg = get_smoke_config("llama3_2_3b")
    ts = S.TrainStep(cfg, {"data": 2, "model": 2})
    assert (ts.n_data, ts.n_model, ts.zero1) == (2, 2, True)
    params, opt, batch = ts.abstract_inputs(ALL_SHAPES[0])
    assert batch["tokens"].device.type == "meta"
    assert batch["tokens"].shape == (ALL_SHAPES[0].global_batch // 2,
                                     ALL_SHAPES[0].seq_len)
    assert opt.m["embed"].dtype == torch.float32
    assert S.make_prefill_fn(cfg, None).tp is None
    assert S.make_prefill_fn(cfg, {"data": 4, "model": 1}).tp is None
