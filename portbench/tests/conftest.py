"""CPU tests of the benchmark harness (run: ``python -m pytest -q
portbench/tests`` from the root of the repository).  Tests that need the
card are marked ``cuda`` and decide inside a fixture."""
import json
import pathlib
import shutil
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: tiny sizes of each configuration for the host
TINY = {"banded": {"n": 512, "half_bandwidth": 16, "leaf_n": 128, "bs": 16},
        "overlap": {"particles_per_axis": 8, "leaf_n": 128, "bs": 16}}


#: the mesh cell's entries: its files are in the benchmark's folder, and
#: its cell is out of ``BENCHMARK.json`` (PERF.md: its runs spread wider
#: than any bound the contract allows); the tests hold its path
MESH = {
    "config": {"name": "banded_p4", "source": "a test",
               "file": "portbench/configs/banded_p4.json", "reduced": ["n"],
               "why": "a test"},
    "workload": {"name": "banded_p4.eager", "config": "banded_p4",
                 "traffic": "eager", "chips": 4, "why": "a test"},
    "per_layer": [
        {"name": "batched_gemm_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels", "moves": "product_s",
         "workloads": ["banded_p4.eager"]},
        {"name": "comm_mb", "unit": "MB", "better": "lower",
         "source": "program_counter", "layer": "mesh", "moves": "product_s",
         "workloads": ["banded_p4.eager"]}]}


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout of ``BENCHMARK.json`` (with the mesh cell's entries
    added) and the benchmark's folder, every configuration cut to a tiny
    size and at most 2 ranks."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"].append(MESH["config"])
    b["workloads"].append(MESH["workload"])
    b["per_layer"] += MESH["per_layer"]
    for m in b["per_layer"]:
        if m["name"] == "register_ms":
            m["workloads"].append("banded_p4.eager")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    for c in b["configs"]:
        path = tmp_path / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY[cfg["pattern"]])
        cfg["ranks"] = min(cfg["ranks"], 2)
        path.write_text(json.dumps(cfg))
    return tmp_path


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch
