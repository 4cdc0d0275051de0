"""The LM stack on PyTorch: layers, attention, MoE, Mamba-2, xLSTM and the
model builder."""
from .convert import params_from_numpy, params_to_numpy
from .model import Model, build_model, count_params, param_bytes

__all__ = ["Model", "build_model", "count_params", "param_bytes",
           "params_from_numpy", "params_to_numpy"]
