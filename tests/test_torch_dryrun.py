"""The port's dry run (``repro_torch.launch.dryrun``) against the reference.

The reference's dry run compiles each cell with XLA and reads its memory,
cost and collectives; the port plays one rank on torch's ``fake``
process-group backend and counts its real step on meta tensors.  Held
here:

* ``model_flops`` equal to the reference's for every cell;
* ``abstract_inputs``' meta blocks equal to the reference's shard shapes
  on both production meshes (shape only, no compile);
* argument bytes equal to XLA's ``argument_size_in_bytes`` of the
  reference's ``lower_cell`` on an 8-device (data 2, model 4) mesh, in one
  subprocess (the reference's production mesh cannot lower under this
  JAX, ROADMAP.md §3, so the subprocess builds an ``AxisType.Auto`` mesh);
* collective bytes and calls equal to what 4 real gloo ranks' CommStats
  count (``tests/torch_dist_scenarios.py dryrun_comm``, one spawn);
* costs exactly linear in depth; the kernels' meta dispatch; one
  full-width cell per family; the report's tables; the CLI.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
import time
import types

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import report as JReport  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.models.config import SHAPES_BY_NAME as J_SHAPES  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, \
    get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import report as PReport  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.models.config import ShapeSpec, \
    applicable_shapes  # noqa: E402
from test_torch_sharding import LAYOUTS, ROOT, SCRIPT  # noqa: E402
from torch_dist_scenarios import DRYRUN_ARCHS, DRYRUN_BATCH, DRYRUN_SEQ, \
    dryrun_shapes, tp_config  # noqa: E402

#: the smoke cells held against XLA: one architecture a family, each at
#: ``dryrun_shapes`` on the 8-device (data 2, model 4) mesh
XLA_ARCHS = ("olmo_1b", "mixtral_8x7b", "falcon_mamba_7b", "zamba2_2_7b",
             "hubert_xlarge", "internvl2_2b")
XLA_MESH = {"data": 2, "model": 4}
#: one full-width train_4k cell a family, and the seconds each may take
FAMILY_CELLS = ("olmo_1b", "mixtral_8x7b", "falcon_mamba_7b", "zamba2_2_7b",
                "hubert_xlarge", "internvl2_2b")
CELL_SECONDS = 240.0


def _ref_model_flops():
    """The reference dry run's ``model_flops`` (its module sets XLA_FLAGS
    at import; restored, so that a later JAX start in this process is not
    changed)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import model_flops
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return model_flops


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    want = _ref_model_flops()
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape in applicable_shapes(cfg):
        assert D.model_flops(cfg, shape) == \
            want(jcfg, J_SHAPES[shape.name]), shape.name


# ---------------------------------------------------------------------------
# abstract inputs against the reference's shard shapes
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    """The leaves of nested dicts (sorted keys) and tuples (in order: the
    step's arguments, an ``AdamWState``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _ref_blocks(args) -> list:
    return [(tuple(x.sharding.shard_shape(x.shape)) if x.sharding is not None
             else tuple(x.shape), str(x.dtype)) for x in _leaves(args)]


def _port_blocks(args) -> list:
    for x in _leaves(args):
        assert x.device.type == "meta"
    return [(tuple(x.shape), str(x.dtype).split(".")[1])
            for x in _leaves(args)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_inputs_equal_reference_shard_shapes(arch, layout):
    """Every leaf of ``TrainStep.abstract_inputs`` (train and prefill
    shapes) and ``ServeStep.abstract_inputs`` (decode shapes) is a meta
    tensor of the reference's shard shape and type, at the origin and at
    the last coordinate of every axis."""
    shape_, names, _ = LAYOUTS[layout]
    jmesh = AbstractMesh(shape_, names)
    sizes = dict(zip(names, shape_))
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape in applicable_shapes(cfg):
        jshape = J_SHAPES[shape.name]
        if shape.kind == "decode":
            jargs = JS.ServeStep(jcfg, jmesh, jshape).abstract_inputs()
        else:
            jargs = JS.TrainStep(jcfg, jmesh).abstract_inputs(jshape)
        want = _ref_blocks(jargs)
        for coords in ({a: 0 for a in names},
                       {a: n - 1 for a, n in sizes.items()}):
            if shape.kind == "decode":
                got = S.ServeStep(cfg, sizes, shape).abstract_inputs(coords)
            else:
                got = S.TrainStep(cfg, sizes).abstract_inputs(shape, coords)
            assert _port_blocks(got) == want, (shape.name, coords)


def test_abstract_inputs_default_to_the_ranks_coordinates():
    """On a DeviceMesh the coordinates default to the calling rank's (a
    fake world's rank 5 of (data 2, model 4) is at data 1, model 1), on a
    dict to the origin; the blocks are cut at those coordinates."""
    cfg = get_smoke_config("olmo_1b")
    shape = ShapeSpec("t", "train", 64, 8)
    with D.fake_world(XLA_MESH, {"data": 1, "model": 1}) as dm:
        assert S.mesh_coords(dm) == {"data": 1, "model": 1}
        on_mesh = S.TrainStep(cfg, dm).abstract_inputs(shape)
    assert S._coords(XLA_MESH, None) == {"data": 0, "model": 0}
    on_dict = S.TrainStep(cfg, XLA_MESH).abstract_inputs(
        shape, {"data": 1, "model": 1})
    assert _port_blocks(on_mesh) == _port_blocks(on_dict)
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# argument bytes against XLA
# ---------------------------------------------------------------------------

_XLA_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    import jax
    jax.devices()      # 8 host devices, before the module below sets 512
    from jax.sharding import AxisType
    from repro.configs import get_smoke_config
    from repro.launch.dryrun import lower_cell
    from repro.models.config import ShapeSpec
    archs, seq, batch = sys.argv[1].split(","), int(sys.argv[2]), \\
        int(sys.argv[3])
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        kinds = ("train", "prefill") + (() if cfg.is_encoder_only
                                        else ("decode",))
        for kind in kinds:
            shape = ShapeSpec(kind, kind, seq, batch)
            mem = lower_cell(cfg, shape, mesh).compile().memory_analysis()
            ca = lower_cell(dataclasses.replace(cfg, cost_mode=True), shape,
                            mesh).compile().cost_analysis()
            if isinstance(ca, (list, tuple)):
                ca = ca[0]
            out[f"{arch}/{kind}"] = {
                "argument_bytes": mem.argument_size_in_bytes,
                "flops": float(ca.get("flops", 0.0))}
    print("RESULT " + json.dumps(out))
""")


@functools.lru_cache(maxsize=None)
def _xla() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run(
        [sys.executable, "-c", _XLA_SCRIPT, ",".join(XLA_ARCHS),
         str(DRYRUN_SEQ), str(DRYRUN_BATCH)],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("arch", XLA_ARCHS)
def test_argument_bytes_equal_xla(arch):
    """The count's ``argument_bytes`` equals XLA's
    ``argument_size_in_bytes`` of the reference's compile of the same cell
    on the same mesh, to the byte: the blocks of every input the step
    reads (XLA prunes an unused argument, as olmo's non-parametric norms
    in its prefill and decode).  The ratio of the port's FLOPs to XLA's
    ``cost_analysis`` (cost_mode on both) is printed, not held: XLA counts
    elementwise work and a scan's body once."""
    cfg = get_smoke_config(arch)
    xla = _xla()
    for shape in dryrun_shapes(cfg):
        want = xla[f"{arch}/{shape.kind}"]
        got = D.count_cell(cfg, shape, XLA_MESH)
        assert got["mem"]["argument_bytes"] == want["argument_bytes"], \
            (shape.kind, got["mem"], want)
        cost = D.count_cell(dataclasses.replace(cfg, cost_mode=True),
                            shape, XLA_MESH)
        print(f"{arch} {shape.kind}: port/XLA flops "
              f"{cost['flops'] / max(want['flops'], 1):.3f} "
              f"({cost['flops']} / {want['flops']:.0f})")


def test_olmo_argument_bytes_are_the_known_ones():
    """olmo-1b's smoke cells: 201220 (train), 99328 (prefill), 163860
    (decode) bytes a device, as XLA counts them."""
    cfg = get_smoke_config("olmo_1b")
    got = [D.count_cell(cfg, s, XLA_MESH)["mem"]["argument_bytes"]
           for s in dryrun_shapes(cfg)]
    assert got == [201220, 99328, 163860]


# ---------------------------------------------------------------------------
# collectives against real ranks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ranks() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(SCRIPT), "4", "dryrun_comm"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, \
        f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}"
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])["dryrun_comm"]


@pytest.mark.parametrize("arch", DRYRUN_ARCHS)
def test_collectives_equal_real_ranks(arch):
    """On (data 2, model 2), each rank's counted collective bytes, by kind
    and in all, and its calls by kind equal what CommStats counted on a
    real gloo rank at the same coordinates (train step with ZeRO-1,
    prefill, decode); its argument bytes equal the bytes of the real
    rank's blocks where the step reads every input (always a train step,
    which updates every parameter)."""
    cfg = tp_config(arch)
    for shape in dryrun_shapes(cfg):
        for real in _ranks()[f"{arch}/{shape.kind}_by_rank"]:
            got = D.count_cell(cfg, shape, {"data": 2, "model": 2},
                               real["coords"])
            assert got["coll"] == real["bytes"] > 0, (shape.kind, real)
            assert got["coll_per_op"] == real["per_op"], (shape.kind, real)
            assert got["coll_counts"] == real["counts"], (shape.kind, real)
            if shape.kind == "train" or arch == "h2o_danube3_4b":
                assert got["mem"]["argument_bytes"] == real["arg_bytes"]
            else:
                assert got["mem"]["argument_bytes"] <= real["arg_bytes"]


# ---------------------------------------------------------------------------
# depth, the kernels on meta, the counting mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [("h2o_danube3_4b", "train"),
                                       ("zamba2_2_7b", "train"),
                                       ("mixtral_8x7b", "prefill"),
                                       ("falcon_mamba_7b", "decode")])
def test_costs_are_exactly_linear_in_depth(arch, kind):
    """``flops``, ``hbm`` and ``coll`` at 1, 2 and 3 layer groups are
    a + b L exactly, b > 0: every layer is counted, none extrapolated.
    On (data 1, model 2): with a data axis of 2, ZeRO-1 slices the moments
    along the layer stack at an even depth and along another dim at an odd
    one (the spec tables' rule), which changes the update's ops."""
    base = get_smoke_config(arch)
    unit = base.attn_every if base.family == "hybrid" else 1
    shape = ShapeSpec(kind, kind, 64, 4)
    pts = [D.count_cell(base.scaled(n_layers=unit * g), shape,
                        {"data": 1, "model": 2}) for g in (1, 2, 3)]
    for key in ("flops", "hbm", "coll"):
        a, b, c = (p[key] for p in pts)
        assert c - b == b - a > 0, (key, a, b, c)


class _Sink:
    def __init__(self):
        self.calls = []

    def __call__(self, name, flops, nbytes):
        self.calls.append((name, flops, nbytes))


def _attention_inputs(device, h=4, h_kv=2, s=256, d=16):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((h, s, d), generator=g)
    k, v = (torch.randn((h_kv, s, d), generator=g) for _ in range(2))
    return [t.to(device).requires_grad_() for t in (q, k, v)]


def test_banded_attention_on_meta_counts_its_kernels():
    """Forward and backward on meta return their results' shapes and
    report ``kernel_work``'s FLOPs and bytes, one call each."""
    sink = _Sink()
    ops.META_COUNTS.append(sink)
    try:
        q, k, v = _attention_inputs("meta")
        out = ops.banded_attention(q, k, v, window=128)
        assert out.device.type == "meta" and out.shape == q.shape
        out.sum().backward()
    finally:
        ops.META_COUNTS.remove(sink)
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    shape = dict(heads=4, kv_heads=2, seq=256, head_dim=16, window=128,
                 causal=True, itemsize=4)
    fwd = RL.kernel_work("block_attention", **shape)
    bwd = RL.kernel_work("block_attention_bwd", **shape)
    assert sink.calls == [("block_attention", *fwd),
                          ("block_attention_bwd", *bwd)]
    pairs = RL.band_pairs(256, 128, True)
    assert fwd == (4.0 * 16 * pairs * 4, (2 * 4 + 2 * 2) * 256 * 16 * 4)
    assert bwd == (10.0 * 16 * pairs * 4, (3 * 4 + 4 * 2) * 256 * 16 * 4)


def test_multiply_kernels_on_meta_count_their_work():
    sink = _Sink()
    ops.META_COUNTS.append(sink)
    try:
        a = torch.empty((6, 16, 16), device="meta")
        b = torch.empty((5, 16, 16), device="meta")
        idx = torch.empty(9, dtype=torch.int32, device="meta")
        c = ops.bsmm_pairs(a, b, idx, idx, idx, cap_c=7)
        g = ops.batched_gemm(a, a)
    finally:
        ops.META_COUNTS.remove(sink)
    assert c.shape == (7, 16, 16) and c.device.type == "meta"
    assert g.shape == a.shape and g.device.type == "meta"
    assert sink.calls == [
        ("bsmm_pairs", 2.0 * 16 ** 3 * 9, (6 + 5 + 7) * 256 * 4 + 12 * 9),
        ("batched_gemm", 2.0 * 16 ** 3 * 6, 3 * 6 * 256 * 4)]


def test_cpu_results_unchanged_and_other_devices_refused():
    """The CPU path is still the plain version, bit for bit, and a tensor
    on a device with neither a kernel nor a plain version is refused."""
    q, k, v = _attention_inputs("cpu")
    got = ops.banded_attention(q, k, v, window=128)
    want = ref.banded_attention_ref(q, k, v, 128, causal=True)
    assert torch.equal(got, want)
    a = torch.randn((3, 8, 8))
    assert torch.equal(ops.batched_gemm(a, a), ref.batched_gemm_ref(a, a))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops._route(types.SimpleNamespace(device=torch.device("xla")))


def test_kernel_work_keeps_the_smoke_bounds():
    """``kernel_work`` at the smoke's shapes gives the numbers of the
    formulas the smoke held before they moved: each kernel's FLOPs and
    bytes, hence every ``bound_ms`` it prints."""
    pairs = RL.band_pairs(8192, 4096, True)
    assert pairs == 4096 * 4097 // 2 + 4096 * 4096
    assert RL.kernel_work(
        "block_attention", heads=32, kv_heads=8, seq=8192, head_dim=120,
        window=4096, causal=True, itemsize=2) == (
        4.0 * 120 * pairs * 32, (2 * 32 + 2 * 8) * 8192 * 120 * 2)
    assert RL.kernel_work(
        "block_attention_bwd", heads=32, kv_heads=8, seq=8192, head_dim=120,
        window=4096, causal=True, itemsize=2) == (
        5 * 2.0 * 120 * pairs * 32, (3 * 32 + 4 * 8) * 8192 * 120 * 2)
    assert RL.kernel_work("bsmm_pairs", a_blocks=100, b_blocks=90,
                          c_blocks=80, bs=16, pairs=1000, valid_pairs=900,
                          itemsize=4) == (
        2.0 * 16 ** 3 * 900, (100 + 90 + 80) * 256 * 4 + 3 * 4 * 1000)
    assert RL.kernel_work("batched_gemm", products=512, bs=64,
                          itemsize=2) == (2.0 * 64 ** 3 * 512,
                                          3 * 512 * 64 * 64 * 2)
    with pytest.raises(ValueError, match="unknown kernel"):
        RL.kernel_work("gemm")


def test_count_tracks_live_storages_and_reads():
    """The mode's peak is the most bytes of storages made under it alive
    at once; views and in-place results add nothing, also of an argument;
    an argument is read only by an op that is no view."""
    x = torch.empty((256, 256), device="meta")
    unused = torch.empty(1000, device="meta")
    count = D.Count()
    with count:
        a = x * 2                          # 256 KiB
        b = a.t()                          # a view: no new storage
        c = b @ b                          # 256 KiB more
        del a, b
        d = c + 1                          # c (alive) + d
        x.mul_(2)                          # in place: no new storage
        unused.view(10, 100)               # a view reads nothing
    assert count.peak == 2 * 256 * 256 * 4
    assert count.live == 2 * 256 * 256 * 4
    assert count.flops == 2 * 256 ** 3
    assert x.untyped_storage()._cdata in count.read
    assert unused.untyped_storage()._cdata not in count.read
    del c, d
    assert count.live == 0


def test_fake_world_refuses_a_second_world_and_cleans_up():
    with D.fake_world({"data": 2, "model": 2}, {"data": 1, "model": 0}):
        assert torch.distributed.get_rank() == 2
        assert torch.distributed.get_world_size() == 4
        with pytest.raises(ValueError, match="already has a process group"):
            with D.fake_world({"data": 2}):
                pass
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# full-width cells, the report, the CLI
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cell(arch: str) -> tuple:
    t0 = time.perf_counter()
    row = D.run_cell(arch, "train_4k", False, verbose=False)
    return row, time.perf_counter() - t0


@pytest.mark.parametrize("arch", FAMILY_CELLS)
def test_full_width_train_cell_per_family(arch):
    """``run_cell`` of train_4k on 16x16 at full width, within
    CELL_SECONDS of host time: the reference's row schema, a useful
    fraction and an MFU bound in (0, 1], and memory counted."""
    row, seconds = _cell(arch)
    assert seconds < CELL_SECONDS, seconds
    assert (row["arch"], row["shape"], row["mesh"], row["n_chips"]) == \
        (arch, "train_4k", "16x16", 256)
    rf = row["roofline"]
    assert 0 < rf["useful_fraction"] <= 1, rf
    assert 0 < rf["mfu_bound"] <= 1, rf
    m = row["mem"]
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert m["argument_bytes"] > 0 and m["temp_bytes"] > 0
    assert row["collectives"] and row["collective_counts"]
    assert set(row["collectives"]) <= {"all-reduce", "all-gather",
                                       "reduce-scatter"}


def test_report_tables_equal_reference(tmp_path):
    """``dryrun_table`` and ``roofline_table`` of a directory of the
    port's rows (a multi-pod row with memory only among them) equal the
    reference report's on the same rows."""
    for arch in FAMILY_CELLS[:2]:
        (tmp_path / f"{arch}_train_4k_sp.json").write_text(
            json.dumps(_cell(arch)[0]))
    mp = D.run_cell("olmo_1b", "decode_32k", True, verbose=False,
                    skip_costs=True)
    assert "roofline" not in mp and mp["mesh"] == "2x16x16"
    (tmp_path / "olmo_1b_decode_32k_mp.json").write_text(json.dumps(mp))
    rows = PReport.load(tmp_path)
    assert len(rows) == 3
    assert PReport.dryrun_table(rows) == JReport.dryrun_table(rows)
    assert PReport.roofline_table(rows) == JReport.roofline_table(rows)
    assert PReport.roofline_table(rows).count("\n") == 1 + 2


def test_cli_writes_one_row_without_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch olmo_1b --shape
    train_4k`` writes one row and loads neither jax nor repro."""
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.argv = ["dryrun", "--arch", "olmo_1b", "--shape", "train_4k",
                    "--out", {str(tmp_path)!r}]
        try:
            runpy.run_module("repro_torch.launch.dryrun",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "jaxlib"))
               or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        print("clean")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("clean")
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == ["olmo_1b_train_4k_sp.json"]
    row = json.loads(files[0].read_text())
    assert row["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert "(HBM 80 GB)" in res.stdout
