"""The LM stack on PyTorch: layers, attention, MoE, Mamba-2, xLSTM, the
model builder and the sharding rules."""
from .convert import (params_from_numpy, params_from_zamba2_state_dict,
                      params_to_numpy, reference_layout)
from .model import Model, build_model, count_params, param_bytes
from .sharding import batch_spec, cache_specs, param_specs, shard

__all__ = ["Model", "batch_spec", "build_model", "cache_specs",
           "count_params", "param_bytes", "param_specs", "params_from_numpy",
           "params_from_zamba2_state_dict", "params_to_numpy",
           "reference_layout", "shard"]
