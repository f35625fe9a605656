"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (see ``pbench/main.py``).  The program under
test is ``repro_torch`` under ``src/``.
"""
import time

T_START = time.time()

if __name__ == "__main__":
    import os
    import pathlib
    import sys
    # one process, few threads: the program's host path is one Python
    # thread, and idle pool threads only take cores from it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    here = pathlib.Path(__file__).resolve().parent
    sys.path[:0] = [str(here), str(here.parent / "src")]
    from pbench.main import main
    sys.exit(main(t_start=T_START))
