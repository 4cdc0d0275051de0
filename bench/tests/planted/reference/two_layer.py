"""The planted two-layer model's plain reference: gelu(x W1) W2 in f32
with TF32 off, on the device the check runs on. ``precision`` ``bf16``
is the control of the f32 test size."""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "bf16")
CONTROL = "bf16"
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def reference(inputs: dict, device: str, precision: str = "f32"
              ) -> torch.Tensor:
    """The logits of one client's batch, f32, on ``device``."""
    if precision not in _DTYPES:
        raise ValueError(f"unknown precision {precision!r}; choose from "
                         f"{PRECISIONS}")
    dtype = _DTYPES[precision]
    w = inputs["weights"]
    x, w1, w2 = (t.to(device, dtype) for t in (inputs["x"], w["w1"], w["w2"]))
    with _no_tf32():
        return (torch.nn.functional.gelu(x @ w1) @ w2).float()


def compare(out, ref: torch.Tensor) -> dict:
    """The largest gap of any logit from the reference, over its RMS;
    infinite where a gap is not a number."""
    got = torch.as_tensor(out).to(ref.device, torch.float32)
    diff = got - ref
    rms = float(ref.double().pow(2).mean().sqrt())
    if bool(torch.isnan(diff).any()):
        return {"max_err_over_rms": float("inf")}
    return {"max_err_over_rms": float(diff.abs().max()) / rms}
