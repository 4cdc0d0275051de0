"""idle_unattributed_frac (device): the share of the traced window in
which the card runs nothing and no span of the program is open
(``harness/idle.py``)."""
from bench.harness import idle


def read(run):
    return idle.idle_frac(run, "unattributed")
