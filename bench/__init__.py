"""The port's benchmark: one cell of ``BENCHMARK.json`` a run (``run.py``)."""
