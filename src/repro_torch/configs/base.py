"""Model/shape/run configuration schema + registry (the port's own copy).

Plain data, copied from the reference package so that a config means the
same thing in both: one `ModelConfig` per assigned architecture lives in
configs/<id>.py with the exact published dimensions; `reduced()` derives
the CPU-smoke variant (same family/features, tiny dims). `SHAPES` defines
the four assigned input-shape cells.

`attn_impl` and `mixer_impl` keep the reference's values: "flash" and
"pallas" select the hand kernels' wrappers (the CUDA kernel on CUDA
tensors, the plain version on CPU tensors), "xla" and "ref" select the
plain versions, and "chunked" the differentiable chunk-parallel forms in
plain PyTorch (``models.attention.chunked_attention``,
``kernels.chunked_linear_attention``), which the dry run traces full
configs with.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | encdec | ssm | hybrid | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention features
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None          # sliding-window attention
    rope_theta: float = 10000.0
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM / xLSTM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    attn_every: int = 0                   # zamba2: shared attn every N
    slstm_every: int = 0                  # xlstm: sLSTM every N
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                  # stub frame count
    # vlm
    vision_tokens: int = 0
    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    schedule: str = "cosine"              # "wsd" for minicpm
    # runtime impls
    attn_impl: str = "xla"                # xla | flash | chunked
    mixer_impl: str = "ref"               # ref | pallas | chunked
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def subquadratic(self) -> bool:
        """Can this arch run the long_500k decode shape?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window is not None    # SWA bounds the KV cache

    @property
    def has_decoder(self) -> bool:
        return True   # every assigned arch decodes (whisper is enc-dec)

    def n_params(self) -> int:
        """Analytic parameter count (approximate for ssm/hybrid families;
        the model builder reports the exact tree size — see
        models.model.count_params, which roofline uses when available)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * hd * d
        if self.family == "moe":
            ffn = 3 * d * self.moe_d_ff * self.num_experts + \
                d * self.num_experts
        elif self.family == "ssm":
            attn, ffn = 8 * d * d, 0          # mLSTM up/down + qkv approx
        elif self.family == "hybrid":
            attn, ffn = 6 * d * d, 3 * d * self.d_ff / self.num_layers
        else:
            ffn = 3 * d * self.d_ff
        layers = self.num_layers * (attn + ffn) + \
            self.encoder_layers * (attn + ffn)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(layers + emb)

    def n_active_params(self) -> int:
        """Active (per-token) params — differs from n_params for MoE."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        hd = self.resolved_head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * hd * d
        ffn = 3 * d * self.moe_d_ff * self.top_k + d * self.num_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(self.num_layers * (attn + ffn) + emb)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale = {
            "num_layers": min(self.num_layers, 4),
            "d_model": 64,
            "num_heads": 4,
            "num_kv_heads": min(4, max(1, self.num_kv_heads *
                                       4 // self.num_heads)),
            "d_ff": 128 if self.d_ff else 0,
            "vocab_size": 256,
            "head_dim": 16 if self.head_dim else None,
            "window": 32 if self.window else None,
            "num_experts": min(self.num_experts, 4),
            "top_k": min(self.top_k, 2),
            "moe_d_ff": 64 if self.moe_d_ff else 0,
            "ssm_state": 16 if self.ssm_state else 0,
            "ssm_head_dim": 16 if self.ssm_state else 64,
            "attn_every": min(self.attn_every, 2),
            "slstm_every": min(self.slstm_every, 2),
            "encoder_layers": min(self.encoder_layers, 2),
            "encoder_seq": 16 if self.encoder_seq else 0,
            "vision_tokens": 8 if self.vision_tokens else 0,
            "remat": False,
        }
        return dataclasses.replace(self, **scale)


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """The published Zamba2 layout (``models.model`` builds it), where the
    port's ``zamba2-7b`` is a Zamba-like stand-in on :class:`ModelConfig`.

    Mamba-2 layers throughout (expand 2), B and C shared within
    ``mamba_ngroups`` groups of heads and the gate taken before the
    output norm; before the Mamba layer at each of ``hybrid_layer_ids``
    one of ``num_mem_blocks`` shared attention + MLP blocks runs, the
    blocks in turn, over [residual ; embedding] (2 d_model wide, heads of
    ``head_dim`` with RoPE, scores scaled by (head_dim / 2)^-1/2), with a
    rank ``adapter_rank`` LoRA on its MLP's gate and up projections and a
    linear into the Mamba layer's input, both one per application. A
    subclass rather than new fields of :class:`ModelConfig`, whose fields
    are held equal to the reference package's config.
    """

    hybrid_layer_ids: tuple = ()
    num_mem_blocks: int = 2
    adapter_rank: int = 128
    mamba_ngroups: int = 2

    def reduced(self) -> "Zamba2Config":
        """A tiny config of the same layout for CPU tests: 8 layers, 3
        hybrid applications (both blocks, one of them twice), 2 groups."""
        return dataclasses.replace(
            self, num_layers=8, d_model=64, num_heads=4, num_kv_heads=4,
            head_dim=32, d_ff=96, vocab_size=256, ssm_state=16,
            ssm_head_dim=16, hybrid_layer_ids=(1, 4, 6), adapter_rank=8,
            remat=False)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import _load_all  # late import triggers config registration
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    from . import _load_all
    _load_all()
    return dict(_REGISTRY)
