"""Launchers and reports of the port: ``lm_serve`` (the LM decode loop),
``report`` (markdown tables of the ``BENCH_*.json`` artifacts and dry-run
rows) and ``roofline`` (roofline terms under the H100's peaks)."""
