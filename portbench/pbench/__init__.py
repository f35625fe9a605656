"""The port's benchmark harness: the yardstick that ``portbench/run.py``
drives (inputs, reference, arithmetic, traces), independent of the
program it measures."""
