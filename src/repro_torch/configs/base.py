"""Architecture + shape configuration system (``--arch <id>``).

Every assigned architecture is a frozen :class:`ArchConfig`; every input
shape is a :class:`ShapeSpec`.  The dry-run iterates the cross product.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "smoke_variant"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // num_heads

    # attention details
    qk_norm: bool = False
    rope_theta: float = 1e6
    attn_logit_dtype: str = "float32"

    # MLP
    mlp: str = "swiglu"            # swiglu | squared_relu | gelu

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert: bool = False
    moe_capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    shared_attn_every: int = 0     # zamba2: shared attn block period (0 = off)
    shared_attn_lora_rank: int = 0

    # frontends (stubbed modalities)
    frontend: str | None = None    # patch_embed | audio_frames | None
    num_frontend_tokens: int = 0

    # encoder-decoder
    encoder_layers: int = 0

    # training policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    grad_dtype: str = "float32"    # "bfloat16" = compressed grad all-reduce
    optimizer: str = "adamw"       # adamw | adafactor
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots (save matmul outputs)
    microbatches: Mapping[str, int] = dataclasses.field(default_factory=dict)
    # attention kv-block for the flash-style scan
    attn_chunk: int = 1024
    ssm_chunk: int = 256

    # which shapes apply (e.g. full-attention archs skip long_500k)
    skip_shapes: tuple[str, ...] = ()

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding: embedding/unembedding tables are
        padded to a multiple of 256 so they shard evenly over the tensor
        axis; logits at padded positions are masked to −inf."""
        return -(-self.vocab_size // 256) * 256

    def grad_accum(self, shape_name: str) -> int:
        return self.microbatches.get(shape_name, 1)

    def param_count(self) -> int:
        """Approximate total parameters (reported in the roofline table)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.family in ("ssm",):
            d_in = self.ssm_expand * d
            mix = d * d_in * 2 + d_in * d + d * (2 * self.ssm_state)
            per_layer = mix + 2 * d * ff  # channel-mix style
        elif self.family == "moe":
            dense_mlp = 3 * d * ff * self.num_experts
            if self.moe_shared_expert:
                dense_mlp += 3 * d * ff
            per_layer = attn + dense_mlp + d * self.num_experts
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            per_layer = (d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim)
                         + d_in * d)
        else:
            mlp = (3 if self.mlp == "swiglu" else 2) * d * ff
            per_layer = attn + mlp
        layers = self.num_layers + self.encoder_layers
        total = layers * per_layer + 2 * v * d
        if self.family == "hybrid" and self.shared_attn_every:
            mlp = 3 * d * ff
            total += attn + mlp  # one shared block
        return int(total)

    def active_param_count(self) -> int:
        """Active (per-token) parameters — MoE uses top-k of the experts."""
        if self.family != "moe" or self.num_experts == 0:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        k = self.experts_per_token + (1 if self.moe_shared_expert else 0)
        per_layer = attn + 3 * d * ff * k + d * self.num_experts
        return int(self.num_layers * per_layer + 2 * self.vocab_size * d)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
    return dataclasses.replace(
        cfg,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        shared_attn_lora_rank=4 if cfg.shared_attn_lora_rank else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        num_frontend_tokens=8 if cfg.frontend else 0,
        attn_chunk=32,
        ssm_chunk=16,
        microbatches={},
    )
