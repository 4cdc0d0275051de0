"""idle_usm_frac (device): the share of the traced window in which the
card runs nothing and a ``plan`` or ``settle`` span of any launch is
open (``harness/idle.py``)."""
from bench.harness import idle


def read(run):
    return idle.idle_frac(run, "usm")
