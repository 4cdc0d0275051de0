"""``chip_smoke.py``'s choice of the launch phase 13 holds the DES to.

Phase 13 holds the DES's prediction for each USM hguided pair against
the launch of median ``total_s`` among ``DES_LAUNCHES`` fresh launches
(``median_run``), not against one launch, since a pair's time still
spreads between launches.

Its planted kernel faults (``broken_kernel``) stand in at every call site
of the LM kernels, with the keywords those sites pass.
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


def test_broken_kernel_stands_in_for_a_zamba2_prefill():
    """The planted faults take what the published Zamba2 layout's prefill
    passes (flash's caller's scale, linear attention's final state), so a
    whole served batch runs through them, and its logits move."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("zamba2-7b-instruct").reduced(),
                              attn_impl="flash", mixer_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0),
                        device=torch.device("cpu"))
    g = torch.Generator().manual_seed(1)
    prompts, forced = (torch.randint(0, cfg.vocab_size, (2, n), generator=g)
                       for n in (70, 3))
    good, _ = serve_batch(model, params, prompts, forced)
    with chip_smoke.kernel_sites(chip_smoke.broken_kernel):
        bad, _ = serve_batch(model, params, prompts, forced)
    assert bad.shape == good.shape
    assert float((bad - good).abs().max()) > 1e-3
