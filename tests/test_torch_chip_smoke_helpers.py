"""``chip_smoke.py``'s choice of the launch phase 13 holds the DES to.

Phase 13 holds the DES's prediction for each USM hguided pair against
the launch of median ``total_s`` among ``DES_LAUNCHES`` fresh launches
(``median_run``), not against one launch, since a pair's time still
spreads between launches.
"""
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("totals,want", [([0.3, 0.1, 0.5, 0.2, 0.4], 0.3),
                                         ([0.0324, 0.0081, 0.0129, 0.0093,
                                           0.0101], 0.0101)])
def test_median_run_is_the_middle_launch(totals, want):
    """The whole run of the middle launch comes back (its packages too),
    not a median of each field."""
    runs = [SimpleNamespace(total_s=t, packages=[i]) for i, t in
            enumerate(totals)]
    got = chip_smoke.median_run(runs)
    assert got.total_s == want == float(np.median(totals))
    assert got.packages == [totals.index(want)]
