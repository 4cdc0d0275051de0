"""idle_cpu_frac (device): the share of the traced window in which the
card runs nothing, no ``plan`` or ``settle`` span is open and a CPU
unit's package computes (``harness/idle.py``)."""
from bench.harness import idle


def read(run):
    return idle.idle_frac(run, "cpu")
