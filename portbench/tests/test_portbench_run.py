"""Whole runs on the host (the kernels' plain versions): the last-line
contract, the discovery of new files, the import guard."""
import io
import json
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from pbench import guard, main


def run_line(root, cell, seed=7, seconds=0.5, trace=False, **kw):
    out = main.run(root, cell, seed, seconds, trace, time.time(),
                   device="cpu", **kw)
    so, se = io.StringIO(), io.StringIO()
    with redirect_stdout(so), redirect_stderr(se):
        assert main.finish(out) == 0
    return so.getvalue(), se.getvalue()


@pytest.mark.parametrize("cell", ["banded.eager", "overlap_s2.eager",
                                  "overlap_s2.replay"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_contract(tiny_root, cell, trace):
    so, se = run_line(tiny_root, cell, seed=2 ** 31 + 11, trace=trace)
    line = json.loads(so.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in b[kind]
            if cell in m.get("workloads", [cell])}
    got = set(line["metrics"])
    if trace:   # the host has no device trace: those metrics stay silent
        want -= {"idle_share", "bsmm_pairs_roofline"}
    assert got == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"]["c_blocks_wrong"] == {"value": 0, "limit": 0}
    tail = se.strip().splitlines()[-2:]
    assert tail[0].startswith("check c_blocks_wrong: 0 (limit 0)")
    assert tail[1].startswith("check max_rel_err: ")


def test_same_seed_same_inputs_and_numbers(tiny_root):
    a = json.loads(run_line(tiny_root, "banded.eager", seed=3)[0])
    b = json.loads(run_line(tiny_root, "banded.eager", seed=3)[0])
    c = json.loads(run_line(tiny_root, "banded.eager", seed=4)[0])
    err = [x["checks"]["max_rel_err"]["value"] for x in (a, b, c)]
    assert err[0] == err[1] != err[2]


def test_mesh_cell_on_two_gloo_ranks(tiny_root):
    so, _ = run_line(tiny_root, "banded_p4.eager", trace=True,
                     backend="gloo")
    line = json.loads(so)
    assert line["correct"] is True and line["device"]["count"] == 2
    assert line["metrics"]["comm_mb"]["value"] > 0


def test_new_config_mix_and_metric_are_found_as_new_files(tiny_root):
    """A configuration (with its pattern and a new operator), a mix of a
    new kind (with its driver: a fresh build of the operand before every
    product) and a per-layer metric, added as new files and entries, no
    existing file edited."""
    bench = tiny_root / "portbench"
    (bench / "patterns" / "diagonal_test.py").write_text(
        "import numpy as np\n"
        "from pbench.inputs import Pattern, hash01\n"
        "def make(cfg):\n"
        "    n = cfg['n']\n"
        "    r = np.arange(n)\n"
        "    return Pattern(n=n, rows=r, cols=r, upper=False,\n"
        "                   values=lambda s, k: lambda a, b: 1 + hash01(a, b, s, k))\n")
    (bench / "operators" / "square_test.py").write_text(
        "OPERANDS = ('A',)\n"
        "def call(m):\n"
        "    return m['A'] @ m['A']\n"
        "def reference_operands(blocks):\n"
        "    return blocks['A'], blocks['A']\n")
    (bench / "drivers" / "rebuild_test.py").write_text(
        "LAZY = False\n"
        "REUSES_OUTPUT = False\n"
        "def start(ctx):\n"
        "    return Rebuild(ctx)\n"
        "class Rebuild:\n"
        "    def __init__(self, ctx):\n"
        "        self.ctx = ctx\n"
        "        self.sets = int(ctx.mix['value_sets'])\n"
        "    def product(self, k):\n"
        "        with self.ctx.rec.span('rebuild'):\n"
        "            self.a = self.ctx.build(k, name='A')\n"
        "        with self.ctx.rec.span('register'):\n"
        "            return self.ctx.op.call({'A': self.a})\n"
        "    def warm(self):\n"
        "        out = self.product(0)\n"
        "        self.ctx.sess.flush()\n"
        "        self.release(out)\n"
        "    def issue(self, n):\n"
        "        k = n % self.sets\n"
        "        return self.product(k), {'A': k}\n"
        "    def release(self, out):\n"
        "        self.ctx.sess.free(out)\n"
        "        self.ctx.sess.free(self.a)\n")
    cfg = {"pattern": "diagonal_test", "n": 256, "leaf_n": 128, "bs": 16,
           "dtype": "float32", "product": "square_test", "engine": "torch",
           "kernel": "pairs", "ranks": 1,
           "limits": {"c_blocks_wrong": 0, "max_rel_err": 1e-5}}
    (bench / "configs" / "diagonal_test.json").write_text(json.dumps(cfg))
    (bench / "mixes" / "rebuild_three.json").write_text(json.dumps(
        {"driver": "rebuild_test", "value_sets": 3}))
    (bench / "metrics" / "rebuild_ms_test.py").write_text(
        "from pbench import spans\n"
        "def read(run):\n"
        "    return spans.total(run.spans, 'rebuild') / run.products * 1e3\n")
    # a metric that reads the program's records: microseconds of scatter
    # self time per block pair the engine built
    (bench / "metrics" / "scatter_us_per_pair_test.py").write_text(
        "from pbench import spans\n"
        "def read(run):\n"
        "    t = spans.program_self(run, 'engine.scatter')\n"
        "    n = spans.program_counter(run, 'engine.pairs')\n"
        "    if t is None or not n:\n"
        "        return None\n"
        "    return t * run.products / n * 1e6\n")
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "diagonal_test", "source": "a test",
                         "file": "portbench/configs/diagonal_test.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "diagonal_test.rebuild_three",
                           "config": "diagonal_test",
                           "traffic": "rebuild_three", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "rebuild_ms_test", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "test", "moves": "product_s",
                           "workloads": ["diagonal_test.rebuild_three"]})
    b["per_layer"].append({"name": "scatter_us_per_pair_test", "unit": "us",
                           "better": "lower", "source": "program_span",
                           "layer": "test", "moves": "product_s",
                           "workloads": ["diagonal_test.rebuild_three"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    before = {p: p.read_bytes() for p in tiny_root.rglob("*") if p.is_file()}
    out = in_copy(tiny_root, "import json\n"
                  "from pbench import bench, cell\n"
                  "out = main.run(pathlib.Path('.'), "
                  "'diagonal_test.rebuild_three', 5, 0.6, True, time.time(),"
                  " device='cpu')\n"
                  "print(json.dumps({k: out[k] for k in ('correct', "
                  "'attempted', 'metrics', 'checks')}))\n"
                  "b = bench.load_benchmark(pathlib.Path('.'))\n"
                  "spec = {'cfg': bench.load_config(pathlib.Path('.'), b, "
                  "'diagonal_test'), 'mix': bench.load_mix(bench.HERE, "
                  "'rebuild_three'), 'seed': 5, 'seconds': 0.3, 'trace': "
                  "False, 'device': 'cpu', 'backend': 'gloo', 'plant': None}\n"
                  "run_ = main.record([cell.rank_main(0, 1, spec)])\n"
                  "print(json.dumps(bench.load_metric(bench.HERE, "
                  "'scatter_us_per_pair_test').read(run_)))\n")
    line = json.loads(out.splitlines()[-2])
    assert line["correct"] is True and line["attempted"] >= 2
    assert line["checks"]["max_rel_err"]["value"] > 0
    assert line["metrics"]["rebuild_ms_test"]["value"] > 0
    # with --trace 1 the program's records give a number; without, None
    assert line["metrics"]["scatter_us_per_pair_test"]["value"] > 0
    assert json.loads(out.splitlines()[-1]) is None
    assert "register_ms" not in line["metrics"]   # listed for other cells
    assert "pack_ms" in line["metrics"]     # a metric of every cell
    assert {p: p.read_bytes() for p in tiny_root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts} == \
        {p: v for p, v in before.items() if "__pycache__" not in p.parts}


def test_guard_compares_top_level_names_whole():
    assert guard.forbidden_loaded(["repro_torch", "repro_torch.core",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["repro", "repro.core.engine", "jax.numpy",
                                   "jaxlib", "flax.linen", "repro_torch"]) \
        == ["flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.engine"]


def test_a_run_with_a_forbidden_module_loaded_prints_no_result(
        tiny_root, monkeypatch):
    out = main.run(tiny_root, "banded.eager", 1, 0.1, False, time.time(),
                   device="cpu")
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    so, se = io.StringIO(), io.StringIO()
    with redirect_stdout(so), redirect_stderr(se):
        rc = main.finish(out)
    assert rc != 0 and so.getvalue() == ""
    assert "jax" in se.getvalue()


def test_no_card_means_no_result(tiny_root, monkeypatch, capsys):
    import torch
    monkeypatch.chdir(tiny_root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main.main(["--workload", "banded.eager", "--seed", "1",
                    "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_nothing_of_jax_or_the_jax_package_is_imported_by_a_run(tiny_root):
    """A whole run in a fresh interpreter loads no forbidden module."""
    out = in_copy(tiny_root, "main.run(pathlib.Path('.'), "
                  "'overlap_s2.replay', 1, 0.2, True, time.time(), "
                  "device='cpu')\nprint(guard.forbidden_loaded())\n")
    assert out.splitlines()[-1] == "[]"


def in_copy(root, body: str) -> str:
    """Run ``body`` in a fresh interpreter on the copy of the benchmark at
    ``root`` (its own files, not this checkout's); returns its stdout."""
    import subprocess
    from conftest import ROOT
    code = ("import sys, time, pathlib\n"
            f"sys.path[:0] = [{str(root / 'portbench')!r}, "
            f"{str(ROOT / 'src')!r}]\n"
            "from pbench import main, guard\n" + body)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["banded.eager", "overlap_s2.replay"])
def test_tiny_cells_on_the_card(tiny_root, cuda, cell):
    """The card's path at a tiny size: the CUDA kernel, the profiler's
    trace and its metrics (run: ``python -m pytest -q -m cuda
    portbench/tests`` on a machine with a card)."""
    out = main.run(tiny_root, cell, 9, 1.0, True, time.time())
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
    m = out["metrics"]
    assert 0 < m["bsmm_pairs_roofline"]["value"] <= 105
    assert 0 < m["idle_share"]["value"] < 100
    assert out["breakdown"]["device_ops"]
