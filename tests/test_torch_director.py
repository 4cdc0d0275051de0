"""The Director facade in both packages: one blocking launch, same result.

For a regular and an irregular kernel under static and dynamic, on both
planes, the reference's ``Director`` (JAX, two units over one CPU device)
and the port's (two ``cpu`` units) compute the same output within the
kernel's tolerance, over the same sorted package cover, and a second
launch on the same Director reuses its engine.
"""
import numpy as np
import pytest
import torch

import jax

from repro.api import build_kernel as ref_build_kernel
from repro.api import build_scheduler as ref_build_scheduler
from repro.api import kernel_demo_inputs as ref_demo_inputs
from repro.core import MemoryModel as RefMemory
from repro.core import counits_from_devices as ref_counits
from repro.core.director import Director as RefDirector
from repro_torch.api import build_kernel, build_scheduler, kernel_demo_inputs
from repro_torch.core import MemoryModel, counits_from_devices
from repro_torch.core.director import Director

N = 300
TOL = {"taylor": (1e-5, 1e-6), "rap": (1e-5, 1e-6 * 48)}


def cover(packages):
    return sorted((p.offset, p.size) for p in packages)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("policy", ["static", "dyn8"])
@pytest.mark.parametrize("memory", ["usm", "buffers"])
@pytest.mark.parametrize("name", ["taylor", "rap"])
def test_director_matches_reference(name, memory, policy):
    kw = {"speeds": [0.4, 0.6]} if policy == "static" else {}
    ref_units = ref_counits(jax.local_devices()[:1] * 2, kinds=["cpu"] * 2)
    units = counits_from_devices(["cpu", "cpu"])
    results = []
    for director, build, demo, sched in (
            (RefDirector(ref_units, memory=RefMemory(memory)),
             ref_build_kernel, ref_demo_inputs, ref_build_scheduler),
            (Director(units, memory=MemoryModel(memory)), build_kernel,
             kernel_demo_inputs, build_scheduler)):
        with director:
            kernel = build(name)
            runs = []
            for seed in (1, 2):        # the second launch reuses the engine
                x = demo(name, N, seed=seed)
                out = kernel.alloc_out(N, x)
                pkgs = director.launch(sched(policy, N, 2, **kw), kernel, x,
                                       out)
                runs.append((out, cover(pkgs)))
            assert director.memory.value == memory
        results.append(runs)
    rtol, atol = TOL[name]
    for (want, want_cover), (got, got_cover) in zip(*results):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        assert got_cover == want_cover
        assert got_cover[-1][0] + got_cover[-1][1] == N


def test_director_surfaces_a_package_error():
    def broken(offset, chunk):
        raise RuntimeError("boom")

    with Director(counits_from_devices(["cpu", "cpu"])) as director:
        with pytest.raises(RuntimeError, match="boom"):
            director.launch(build_scheduler("dyn4", 64, 2), broken,
                            [np.zeros(64, np.float32)],
                            np.zeros(64, np.float32))


def test_director_units_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Director()
