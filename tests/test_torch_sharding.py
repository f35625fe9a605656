"""The port's sharding rules, batch specs, elastic planning and the
data-parallel train step, against the reference on the CPU.

The spec tables are held equal to the reference's ``PartitionSpec``s on
abstract meshes of the production layouts (16x16 and 2x16x16; the port
takes the same layouts as ``{axis: size}`` dicts).  The data-parallel
``TrainStep`` (ZeRO-1) runs on 4 gloo CPU ranks in one subprocess
(``tests/torch_dist_scenarios.py train_step_dp``), each rank comparing
its step with the one-device step on the whole batch itself.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import make_batch_specs as j_make_batch_specs  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import ALL_SHAPES as J_SHAPES  # noqa: E402
from repro.models.config import input_specs as j_input_specs  # noqa: E402
from repro.runtime.elastic import \
    elastic_remesh_plan as j_elastic_remesh_plan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_batch_specs  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ALL_SHAPES, input_specs  # noqa: E402
from repro_torch.runtime import RemeshPlan, elastic_remesh_plan  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "tests" / "torch_dist_scenarios.py"

#: (shape, names, data axes) of the reference's production layouts
LAYOUTS = {
    "16x16": ((16, 16), ("data", "model"), ("data",)),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model"), ("pod", "data")),
}
_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16}


def _meshes(layout):
    shape, names, data_axes = LAYOUTS[layout]
    return AbstractMesh(shape, names), dict(zip(names, shape)), data_axes


def _ref_specs(tree):
    """A NamedSharding tree as nested dicts of spec tuples."""
    if isinstance(tree, dict):
        return {k: _ref_specs(v) for k, v in tree.items()}
    return tuple(tree.spec)


# ---------------------------------------------------------------------------
# spec tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_tables_equal_reference(arch, layout):
    """param_spec (with and without a mesh), param_shardings and
    zero1_shardings of the full config, leaf for leaf."""
    jmesh, mesh, data_axes = _meshes(layout)
    cfg, jcfg = get_config(arch), jax_config(arch)
    shapes = M.param_shapes(cfg)
    assert shapes == JM.param_shapes(jcfg)
    want = _ref_specs(JS.param_shardings(jcfg, jmesh))
    assert S.param_shardings(cfg, mesh) == want
    want_z = _ref_specs(JS.zero1_shardings(jcfg, jmesh, data_axes))
    assert S.zero1_shardings(cfg, mesh, data_axes) == want_z

    def walk(d, path=()):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                assert S.param_spec(cfg, path + (k,), v) == \
                    tuple(JS.param_spec(jcfg, path + (k,), v))
    walk(shapes)


def test_spec_tables_known_entries():
    """The divisibility fix-ups the tables must make: internvl2-2b's vocab
    (92553) does not divide 16, so embed moves to its d dim; llama3.2-3b's
    28 layers do not divide 32, so ZeRO-1 puts the data axes on wq's d."""
    mesh = {"pod": 2, "data": 16, "model": 16}
    specs = S.param_shardings(get_config("internvl2_2b"), mesh)
    assert specs["embed"] == (None, "model")
    assert specs["patch_proj"] == (None, None)
    z = S.zero1_shardings(get_config("llama3_2_3b"), mesh, ("pod", "data"))
    assert z["layers"]["wq"] == (None, ("pod", "data"), "model")


@pytest.mark.parametrize("shape,spec,want", [
    # kv=8 not divisible by 16 -> moved to hd=128 (trailing preference)
    ((28, 128, 32768, 8, 128), [None, None, None, "model", None],
     [None, None, None, None, "model"]),
    # nothing fits -> replicated
    ((3, 5), ["model", None], [None, None]),
])
def test_fix_spec_cases_of_the_reference(shape, spec, want):
    class FakeMesh:
        shape = {"model": 16}

    assert S._fix_spec({"model": 16}, shape, spec) == want
    assert JS._fix_spec(FakeMesh(), shape, spec) == want


def test_trailing_rules_cover_all_param_names():
    for arch in ARCH_IDS:
        cfg = get_config(arch)

        def walk(d):
            for k, v in d.items():
                if isinstance(v, dict):
                    walk(v)
                else:
                    rule = S._trailing_rule(cfg, k, v)
                    assert len(rule) <= len(v), (arch, k, v, rule)
                    assert rule == JS._trailing_rule(jax_config(arch), k, v)
        walk(M.param_shapes(cfg))


def test_mesh_sizes_and_batch_axes():
    assert S.mesh_sizes(None) == {} and S.batch_axes(None) == ()
    assert S.batch_axes({"data": 4, "model": 1}) == ("data",)
    assert S.batch_axes({"pod": 2, "data": 2, "model": 1}) == ("pod", "data")
    assert S.batch_axes({"model": 2}) == ()


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def _same_inputs(got: dict, want: dict, spec) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape
        assert got[k].dtype == _DTYPES[str(w.dtype)]
        if spec is None:
            assert w.sharding is None and got[k].spec is None
        else:
            assert got[k].spec == tuple(w.sharding.spec) == spec


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch):
    """Every shape of every config: frames and patches bf16 whatever the
    config's type, token fields int32, no targets outside training."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape, jshape in zip(ALL_SHAPES, J_SHAPES):
        assert shape.name == jshape.name
        _same_inputs(input_specs(cfg, shape), j_input_specs(jcfg, jshape),
                     None)
    smoke = cfg.scaled(dtype="float32")
    if cfg.frontend != "tokens":
        assert input_specs(smoke, ALL_SHAPES[0])[cfg.frontend].dtype == \
            torch.bfloat16


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ["llama3_2_3b", "hubert_xlarge",
                                  "internvl2_2b"])
def test_make_batch_specs_equals_reference(arch, layout):
    jmesh, mesh, data_axes = _meshes(layout)
    cfg, jcfg = get_config(arch), jax_config(arch)
    entry = data_axes if len(data_axes) > 1 else data_axes[0]
    for shape, jshape in zip(ALL_SHAPES, J_SHAPES):
        _same_inputs(make_batch_specs(cfg, shape, mesh, data_axes),
                     j_make_batch_specs(jcfg, jshape, jmesh, data_axes),
                     (entry,))


# ---------------------------------------------------------------------------
# elastic planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("layout,names", [
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
    ((4, 2), ("data", "model")),
    ((8,), ("data",)),
])
def test_elastic_remesh_plan_equals_reference(layout, names, keep):
    """Every failure count up to the whole mesh: the same plan, or the
    same RuntimeError once no healthy data row is left."""
    for n_failed in range(0, 2 + int(torch.tensor(layout).prod())):
        try:
            want = j_elastic_remesh_plan(layout, names, n_failed,
                                         keep_global_batch=keep)
        except RuntimeError:
            with pytest.raises(RuntimeError, match="healthy rows"):
                elastic_remesh_plan(layout, names, n_failed,
                                    keep_global_batch=keep)
            continue
        got = elastic_remesh_plan(layout, names, n_failed,
                                  keep_global_batch=keep)
        assert isinstance(got, RemeshPlan)
        assert (got.old_shape, got.new_shape, got.axis_names,
                got.lost_devices, got.microbatch_scale,
                got.new_device_count) == \
            (want.old_shape, want.new_shape, want.axis_names,
             want.lost_devices, want.microbatch_scale, want.new_device_count)


def test_elastic_plan_cases_of_the_reference():
    plan = elastic_remesh_plan((16, 16), ("data", "model"), n_failed=5)
    assert plan.new_shape == (15, 16) and plan.microbatch_scale == 2
    with pytest.raises(RuntimeError):
        elastic_remesh_plan((2, 2), ("data", "model"), n_failed=4)


# ---------------------------------------------------------------------------
# the data-parallel train step on gloo CPU ranks
# ---------------------------------------------------------------------------

#: the one-device step's float32 tolerance (tests/test_torch_train.py)
DP_RTOL = 1e-5
DP_CASES = [f"{mesh}/{arch}/micro{micro}"
            for mesh in ("data", "pod_data")
            for arch, micro in (("llama3_2_3b", 0), ("mixtral_8x7b", 0),
                                ("hubert_xlarge", 0), ("llama3_2_3b", 2))]


@functools.lru_cache(maxsize=None)
def _dp_results() -> dict:
    """Every rank's numbers of every case: one spawn of 4 ranks."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(SCRIPT), "4", "train_step_dp"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, \
        f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}"
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])["train_step_dp"]


@pytest.mark.parametrize("case", DP_CASES)
def test_data_parallel_step_equals_the_one_device_step(case):
    """(data 4, model 1) and (pod 2, data 2, model 1), ZeRO-1 (the
    default): the averaged loss, metrics and gradients, then the gradient
    norm and parameters after one step, within 1e-5 of the one-device step
    on the whole batch on every rank, and the moments within 1e-5 of the
    rank's slice of the one-device moments, a quarter of them; every
    rank's parameters equal rank 0's exactly; a rank that skipped the
    all-reduce would miss."""
    ranks = _dp_results()[case + "_by_rank"]
    assert len(ranks) == 4
    for r in ranks:
        for key in ("loss", "metrics", "grads", "step_loss", "grad_norm",
                    "params", "moments"):
            assert r[key] <= DP_RTOL, (key, r)
        assert r["moment_share"] == 0.25
        assert r["across_ranks"] == 0.0
        assert r["comm_bytes"] > 0
        assert r["no_allreduce"] > 100 * DP_RTOL


@pytest.mark.parametrize("mesh,layout", [
    ("data", ((4, 1), ("data", "model"))),
    ("pod_data", ((2, 2, 1), ("pod", "data", "model"))),
    (None, ((1, 1), ("data", "model")))])
def test_auto_microbatch_divides_the_batch_by_the_data_group(mesh, layout):
    """train_4k of every full config: the same accumulation as the
    reference's on the same layout (its global batch over the data
    group)."""
    jmesh = AbstractMesh(*layout)
    for arch in ARCH_IDS:
        want = JS.TrainStep(jax_config(arch), jmesh).auto_microbatch(
            J_SHAPES[0])
        if mesh is None:
            got = S.TrainStep(get_config(arch),
                              dict(zip(layout[1], layout[0])))
            assert got.n_data == 1
            assert got.auto_microbatch(ALL_SHAPES[0]) == want
            assert S.TrainStep(get_config(arch)).auto_microbatch(
                ALL_SHAPES[0]) == want
        else:
            assert _dp_results()[f"{mesh}/auto_microbatch"][arch] == want


def test_train_step_refuses_a_model_axis():
    """A model axis no longer refuses: ``TrainStep`` builds over it with
    the reference's ``zero1=True`` default (its process groups wait for
    the first step), and its parameter specs are the tables'
    (tests/test_torch_tensor_parallel.py runs it on ranks)."""
    cfg = get_config("llama3_2_3b")
    for mesh in ({"data": 2, "model": 2}, {"pod": 1, "data": 1, "model": 16}):
        ts = S.TrainStep(cfg, mesh)
        assert ts.zero1 and ts.n_model == mesh["model"]
        assert ts.param_shardings() == S.param_shardings(cfg, mesh)
