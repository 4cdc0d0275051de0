"""Config registry: one module per assigned architecture (plain data,
the port's own copy of the reference's)."""
import importlib

_MODULES = [
    "minicpm_2b", "qwen3_0_6b", "qwen1_5_110b", "h2o_danube3_4b",
    "qwen3_moe_235b_a22b", "phi3_5_moe", "whisper_medium",
    "xlstm_1_3b", "zamba2_7b", "internvl2_1b", "zamba2_7b_instruct",
]

_loaded = False


def _load_all() -> None:
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"{__name__}.{m}")
    _loaded = True


from .base import (ModelConfig, ShapeConfig, SHAPES,  # noqa: E402
                   Zamba2Config, all_configs, get_config, register)

# the assigned architectures, each held against the reference package's;
# zamba2-7b-instruct (the published Zamba2 layout) is registered beside
# them and the reference package has no such model
ARCH_IDS = [
    "minicpm-2b", "qwen3-0.6b", "qwen1.5-110b", "h2o-danube3-4b",
    "qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b", "whisper-medium",
    "xlstm-1.3b", "zamba2-7b", "internvl2-1b",
]

__all__ = ["ARCH_IDS", "ModelConfig", "SHAPES", "ShapeConfig",
           "Zamba2Config", "all_configs", "get_config", "register"]
