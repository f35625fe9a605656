"""The port's launch reports and roofline against the reference's.

``repro_torch.launch.report`` must print exactly the reference's tables
for every committed ``BENCH_*.json`` it recognises, for a ``MetricSet``
document and a ``Plan.profile()`` document, and for a directory of
dry-run rows; ``python -m repro_torch.launch.report <file>`` must print
what ``python -m repro.launch.report <file>`` prints.
``repro_torch.launch.roofline`` keeps the reference's ``Roofline`` terms
under an H100 ``Hardware`` that carries no TPU figure, and
``chip_smoke.py`` takes its peaks from it.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import report as ref_report  # noqa: E402
from repro_torch.launch import report, roofline as RL  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_FILES = sorted(p.name for p in ROOT.glob("BENCH_*.json"))
RECOGNISED = ("BENCH_serve.json", "BENCH_fault.json", "BENCH_solvers.json",
              "BENCH_mesh_comm.json")
TABLES = {"serve": "serve_table", "fault": "fault_table",
          "solvers": "solvers_table", "mesh_comm": "mesh_comm_table"}


def _dryrun_row(arch="olmo_1b", mesh="16x16"):
    """The row of ``tests/test_launch.py::TestReport``."""
    return {
        "arch": arch, "shape": "train_4k", "mesh": mesh,
        "n_chips": 256, "t_lower_s": 1, "t_compile_s": 8,
        "mem": {"argument_bytes": 1 << 28, "output_bytes": 0,
                "temp_bytes": 1 << 30,
                "peak_bytes": (1 << 28) + (1 << 30)},
        "collective_counts": {"all-reduce": 3},
        "roofline": {"t_compute_s": 0.1, "t_memory_s": 0.2,
                     "t_collective_s": 0.05, "bottleneck": "memory",
                     "dev_gflops": 1.0, "dev_hbm_gb": 1.0,
                     "dev_coll_gb": 0.1, "model_gflops": 100.0,
                     "useful_fraction": 0.5, "mfu_bound": 0.1},
    }


def _main_output(module, target, monkeypatch, capsys):
    """What ``module.main()`` prints for ``target``, or its exit message."""
    monkeypatch.setattr(sys, "argv", ["report", str(target)])
    try:
        module.main()
    except SystemExit as e:
        return capsys.readouterr().out, str(e.code)
    return capsys.readouterr().out, None


class TestReport:
    @pytest.mark.parametrize("name", RECOGNISED)
    def test_bench_tables_equal_reference(self, name):
        doc = json.loads((ROOT / name).read_text())
        fn = TABLES[doc["bench"]]
        assert getattr(report, fn)(doc) == getattr(ref_report, fn)(doc)

    @pytest.mark.parametrize("name", BENCH_FILES)
    def test_main_prints_what_the_reference_prints(self, name, monkeypatch,
                                                   capsys):
        """Every committed artifact: the same table, or the same refusal
        for the ones neither report recognises."""
        got = _main_output(report, ROOT / name, monkeypatch, capsys)
        want = _main_output(ref_report, ROOT / name, monkeypatch, capsys)
        assert got == want
        assert (got[1] is None) == (name in RECOGNISED)

    def test_metric_documents_equal_reference(self, tmp_path, monkeypatch,
                                              capsys):
        """A ``MetricSet.to_dict()`` document and a ``Plan.profile()``
        document of the port's own session."""
        from repro_torch import Session
        from repro_torch.core.engine import TorchEngine
        sess = Session(engine=TorchEngine(device="cpu"), lazy=True,
                       leaf_n=16, bs=4)
        x = sess.from_dense(np.eye(32) + np.eye(32, k=1), name="X")
        plan = sess.compile(x @ x)
        plan.run()
        docs = {"metrics.json": sess.metrics()[0].to_dict(),
                "profile.json": plan.profile()}
        assert "counters" in docs["metrics.json"]
        for fname, doc in docs.items():
            path = tmp_path / fname
            path.write_text(json.dumps(doc, default=str))
            got = _main_output(report, path, monkeypatch, capsys)
            want = _main_output(ref_report, path, monkeypatch, capsys)
            assert got == want and got[1] is None and "| source |" in got[0]
        assert report.metrics_table(sess.metrics()) == \
            ref_report.metrics_table(sess.metrics())

    def test_dryrun_directory_equals_reference(self, tmp_path, monkeypatch,
                                               capsys):
        """Dry-run rows: both tables, with the reference's 16x16 filter."""
        for arch, mesh in (("olmo_1b", "16x16"), ("llama3_2_3b", "2x4")):
            (tmp_path / f"{arch}.json").write_text(
                json.dumps(_dryrun_row(arch, mesh)))
        rows = report.load(tmp_path)
        assert report.dryrun_table(rows) == ref_report.dryrun_table(rows)
        t2 = report.roofline_table(rows)
        assert t2 == ref_report.roofline_table(rows)
        assert "olmo_1b" in t2 and "llama3_2_3b" not in t2
        got = _main_output(report, tmp_path, monkeypatch, capsys)
        assert got == _main_output(ref_report, tmp_path, monkeypatch, capsys)

    def test_module_entry_point(self):
        """``python -m repro_torch.launch.report BENCH_serve.json`` prints
        the reference's output, and loads neither jax nor ``repro``."""
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        runs = {}
        for pkg in ("repro_torch", "repro"):
            code = (f"import runpy, sys; sys.argv = ['report', "
                    f"{str(ROOT / 'BENCH_serve.json')!r}]; "
                    f"runpy.run_module('{pkg}.launch.report', "
                    f"run_name='__main__'); "
                    f"bad = [m for m in sys.modules if m == 'jax' or "
                    f"m.startswith(('jax.', 'repro.')) or m == 'repro']; "
                    f"print('loaded', sorted(bad))")
            out = subprocess.run([sys.executable, "-c", code], env=env,
                                 capture_output=True, text=True, timeout=120)
            assert out.returncode == 0, out.stderr
            runs[pkg] = out.stdout
        table, loaded = runs["repro_torch"].rsplit("loaded", 1)
        assert loaded.strip() == "[]"
        assert table == runs["repro"].rsplit("loaded", 1)[0]
        assert "## Plan serving (BENCH_serve.json)" in table


class TestRoofline:
    def test_roofline_terms(self):
        hw = RL.Hardware()
        rf = RL.Roofline(flops=989e12, hbm_bytes=3.35e12, coll_bytes=450e9,
                         n_chips=4, hw=hw, model_flops=4e15)
        assert abs(rf.t_compute - 1.0) < 1e-9
        assert abs(rf.t_memory - 1.0) < 1e-9
        assert abs(rf.t_collective - 1.0) < 1e-9
        assert rf.useful_fraction == pytest.approx(4e15 / (989e12 * 4))
        assert rf.mfu_bound == pytest.approx(4e15 / (4 * 989e12 * 1.0))

    def test_bottleneck_selection(self):
        rf = RL.Roofline(flops=1, hbm_bytes=1e12, coll_bytes=1,
                         n_chips=1, hw=RL.Hardware())
        assert rf.bottleneck == "memory"
        rf = RL.Roofline(flops=1, hbm_bytes=1, coll_bytes=1e12,
                         n_chips=1, hw=RL.Hardware())
        assert rf.bottleneck == "collective"

    def test_row_matches_reference(self):
        from repro.launch import roofline as ref_rl
        kw = dict(flops=3e12, hbm_bytes=2e11, coll_bytes=5e9, n_chips=2,
                  model_flops=5e12)
        hw = RL.Hardware(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
        got = RL.Roofline(hw=hw, **kw).row()
        want = ref_rl.Roofline(hw=ref_rl.Hardware(), **kw).row()
        assert got == want

    def test_hardware_is_the_h100_only(self):
        hw = RL.Hardware()
        assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == \
            (989e12, 3.35e12, 450e9)
        tpu = {197e12, 819e9, 50e9}
        consts = [v for k, v in vars(RL).items()
                  if k.isupper() and isinstance(v, float)]
        assert not tpu & set(consts) and not tpu & set(vars(hw).values())
        assert RL.FP32_3XTF32_FLOPS == RL.TF32_FLOPS / 3
        for name in ("collective_bytes", "from_compiled"):
            assert not hasattr(RL, name)

    def test_from_counted_and_the_h100_capacity(self):
        """``from_counted`` takes the per-device terms of a counted step
        (``launch/dryrun.py``), the counterpart of the reference's
        ``from_compiled``; the card's 80 GB of HBM3 is ``Hardware``'s
        capacity, no TPU's 16 GiB."""
        hw = RL.Hardware()
        assert hw.hbm_bytes == RL.HBM_BYTES == 80e9
        costs = {"flops": 989e12, "hbm": 2 * 3.35e12, "coll": 450e9,
                 "coll_per_op": {"all-reduce": 450e9}}
        rf = RL.from_counted(costs, 256, model_flops=128 * 989e12)
        assert (rf.t_compute, rf.t_memory, rf.t_collective) == \
            pytest.approx((1.0, 2.0, 1.0))
        assert rf.bottleneck == "memory" and rf.hw == hw
        assert rf.useful_fraction == pytest.approx(0.5)
        assert rf.mfu_bound == pytest.approx(0.25)
        assert rf.row() == RL.Roofline(
            flops=989e12, hbm_bytes=2 * 3.35e12, coll_bytes=450e9,
            n_chips=256, hw=hw, model_flops=128 * 989e12).row()
        slow = RL.Hardware(peak_flops=494.5e12)
        assert RL.from_counted(costs, 1, slow).t_compute == \
            pytest.approx(2.0)

    def test_chip_smoke_bounds_read_the_roofline_peaks(self):
        """The smoke keeps no peak of its own, and every bound it prints
        is what it was with its former constants."""
        sys.path.insert(0, str(ROOT))
        try:
            import chip_smoke as cs
        finally:
            sys.path.remove(str(ROOT))
        for name in ("HBM_BPS", "FP32_FLOPS", "TF32_FLOPS", "BF16_FLOPS",
                     "FP32_3XTF32_FLOPS"):
            assert not hasattr(cs, name), name
        n_bytes, flops = 3.0e8, 1.1e11
        for dtype, peak in ((torch.float32, 495e12 / 3),
                            (torch.bfloat16, 989e12)):
            assert cs.multiply_peak(torch, dtype) == peak
            b = cs.bound_ms(n_bytes, flops, cs.multiply_peak(torch, dtype))
            tb, tf = n_bytes / 3.35e12 * 1e3, flops / peak * 1e3
            assert (b["bound_bytes_ms"], b["bound_ops_ms"]) == (tb, tf)
            assert b["bound_ms"] == max(tb, tf)
