"""With the timed path broken underneath, a run's check reads
``correct`` false: the control (the kernels' operands in TF32) and one
fault at a time, on each cell where it can occur."""
import json
import time

import pytest

from pbench import main

ONE_CHIP = ["banded.eager", "overlap_s2.eager", "overlap_s2.replay"]
CONTROL = "tf32_operands"
FAULTS = ["altered_answer", "state_unchanged", "half_the_batch"]
#: the control's window on the card at each cell's committed size: long
#: enough for the 4 or more products a run of 51 s checks 3 of
CONTROL_SECONDS = {"banded.eager": 5.0, "overlap_s2.eager": 18.0,
                   "overlap_s2.replay": 8.0}


def run(root, cell, fault, seed=11, seconds=0.2, device="cpu", **kw):
    out = main.run(root, cell, seed, seconds, False, time.time(),
                   device=device, plant=f"portbench_faults:{fault}", **kw)
    return json.loads(json.dumps({k: out[k] for k in ("correct", "failed",
                                                      "checks")}))


@pytest.fixture
def kernels_restored():
    from repro_torch.kernels import ops
    saved = {k: getattr(ops, k) for k in ("bsmm_pairs", "batched_gemm")}
    yield
    for k, v in saved.items():
        setattr(ops, k, v)


@pytest.mark.parametrize("fault", [CONTROL] + FAULTS)
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_fault_reads_incorrect(tiny_root, kernels_restored, cell, fault):
    got = run(tiny_root, cell, fault)
    assert got["correct"] is False and got["failed"] >= 1, got


@pytest.mark.parametrize("fault", [CONTROL] + FAULTS + ["no_exchange"])
def test_fault_reads_incorrect_on_the_mesh(tiny_root, fault):
    got = run(tiny_root, "banded_p4.eager", fault, backend="gloo")
    assert got["correct"] is False and got["failed"] >= 1, got


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3000000201, 3000000202, 3000000203])
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_control_reads_incorrect_at_the_cells_size(cuda, kernels_restored,
                                                   cell, seed):
    """The control through the harness's own check, at the committed
    sizes (run: ``python -m pytest -q -s -m cuda portbench/tests`` on a
    machine with a card; prints each reading)."""
    from conftest import ROOT
    got = run(ROOT, cell, CONTROL, seed=seed,
              seconds=CONTROL_SECONDS[cell], device="cuda")
    print(f"control {cell} seed {seed}: {json.dumps(got['checks'])}")
    assert got["correct"] is False and got["failed"] >= 1, got
