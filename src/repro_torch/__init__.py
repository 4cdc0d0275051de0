"""PyTorch/CUDA port of the Coexecutor Runtime.

A second package beside the JAX reference ``repro``: the same layout module
for module, with every Pallas kernel on the co-execution path rewritten by
hand in CUDA C++ for Hopper (``repro_torch/kernels/csrc``). It imports
neither JAX nor ``repro``. Entry points run on the card unless the caller
asks for the CPU: :func:`repro_torch.core.counits_from_devices` with no
argument returns the [``cuda:0``, ``cpu``] pair.
"""
