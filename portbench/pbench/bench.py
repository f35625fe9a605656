"""Where a cell's parts live, found by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  Each part is a file of
its own, so that a later change adds a configuration, a mix or a
per-layer metric by adding files and entries, never by editing one:

* ``configs/<config>.json``  -- the sizes, the engine and the limits of
  the correctness check; its ``pattern`` names
* ``patterns/<pattern>.py``  -- the generator of the nonzero pattern and
  of the values drawn from the seed (``make(cfg) -> Pattern``), and its
  ``product`` names
* ``operators/<product>.py`` -- the operator each product calls:
  ``OPERANDS`` (the operands' names), ``call(mats) -> Matrix`` and
  ``reference_operands(blocks) -> (left, right)``, the reference's
  factors.  Where the product leaves out some of the factors' block
  pairs (a truncated multiply), it also defines ``reference_pairs(blocks,
  cfg, ia, ib) -> keep``: a boolean mask over the structural pairs
  (indices into the left and right factors' blocks) of those the
  product multiplies.  The reference then multiplies those alone; C's
  structure, |A| |B| and the work counted (``mfu``, the rooflines) are
  those of the pairs kept.  Without it every structural pair counts;
* ``mixes/<traffic>.json``   -- the traffic's parameters; its ``driver``
  names
* ``drivers/<driver>.py``    -- the code that issues products:
  ``LAZY`` (the Session it needs), ``REUSES_OUTPUT`` (whether every
  product writes one result) and ``start(ctx)``, which builds what
  set-up needs through ``ctx.build`` and returns an object with
  ``warm()``, ``issue(n) -> (result, value sets)`` and
  ``release(result)`` (see :class:`pbench.cell.Context`);
* ``metrics/<metric>.py``    -- one per-layer metric: ``read(run)``
  returns its number, or None where the run holds nothing to read
  (:class:`pbench.main.Run`; with ``--trace 1`` ``run.program`` holds
  the program's spans and counters, read through
  :func:`pbench.spans.program_self` and
  :func:`~pbench.spans.program_counter`).

Every path is under the benchmark's folder (this file's parent's parent).
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]


def load_benchmark(root: pathlib.Path) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[c['name'] for c in bench['workloads']]}")


def config_entry(bench: dict, name: str) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return cfg
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_config(root: pathlib.Path, bench: dict, name: str) -> dict:
    """The configuration's file, as the ``file`` of its entry names it."""
    entry = config_entry(bench, name)
    cfg = json.loads((root / entry["file"]).read_text())
    cfg["name"] = name
    return cfg


def load_mix(base: pathlib.Path, traffic: str) -> dict:
    mix = json.loads((base / "mixes" / f"{traffic}.json").read_text())
    mix["name"] = traffic
    return mix


def load_module(path: pathlib.Path, label: str):
    """Import one file of the benchmark by its path."""
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_pattern(base: pathlib.Path, cfg: dict):
    """The pattern generator module the configuration names."""
    return load_module(base / "patterns" / f"{cfg['pattern']}.py",
                       f"portbench_pattern_{cfg['pattern']}")


def load_operator(base: pathlib.Path, cfg: dict):
    """The operator module the configuration's ``product`` names."""
    return load_module(base / "operators" / f"{cfg['product']}.py",
                       f"portbench_operator_{cfg['product']}")


def load_driver(base: pathlib.Path, mix: dict):
    """The driver module the mix names."""
    return load_module(base / "drivers" / f"{mix['driver']}.py",
                       f"portbench_driver_{mix['driver']}")


def metrics_of(bench: dict, cell: dict, kind: str) -> list[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that this
    cell reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def load_metric(base: pathlib.Path, name: str):
    """The reader of per-layer metric ``name``."""
    return load_module(base / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))
