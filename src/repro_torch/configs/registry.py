"""Registry of the 10 assigned architectures (``--arch <id>``).

Sources are recorded per entry; verified-tier tags from the assignment.
Microbatch (grad-accum) counts are sized so per-chip activations fit HBM on
the (16, 16) v5e pod — see EXPERIMENTS.md §Dry-run for measured bytes.
"""

from __future__ import annotations

from .base import ArchConfig

__all__ = ["ARCHS", "get_config"]


ARCHS: dict[str, ArchConfig] = {}


def _register(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# --- [ssm] RWKV6 "Finch" 1.6B — data-dependent decay [arXiv:2404.05892] -----
RWKV6_1P6B = _register(ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536,
    ssm_state=64, ssm_head_dim=64,
    microbatches={"train_4k": 2},
))

# --- [dense] Qwen3-32B — qk_norm + GQA [hf:Qwen/Qwen3-8B family] -------------
QWEN3_32B = _register(ArchConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936, qk_norm=True, mlp="swiglu",
    microbatches={"train_4k": 4, "prefill_32k": 1},
))

# --- [dense] Qwen3-4B ---------------------------------------------------------
QWEN3_4B = _register(ArchConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936, qk_norm=True, mlp="swiglu",
    microbatches={"train_4k": 2},
))

# --- [dense] Nemotron-4 340B — squared-ReLU MLP [arXiv:2402.16819] ------------
NEMOTRON_340B = _register(ArchConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000, mlp="squared_relu",
    optimizer="adafactor", grad_dtype="bfloat16",
    microbatches={"train_4k": 16, "prefill_32k": 2},
))

# --- [dense] DeepSeek 67B — llama-arch [arXiv:2401.02954] ---------------------
DEEPSEEK_67B = _register(ArchConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400, mlp="swiglu",
    microbatches={"train_4k": 8, "prefill_32k": 1},
))

# --- [vlm] InternVL2 26B — InternViT (stub) + InternLM2 [arXiv:2404.16821] ----
INTERNVL2_26B = _register(ArchConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553, mlp="swiglu",
    frontend="patch_embed", num_frontend_tokens=256,
    microbatches={"train_4k": 4, "prefill_32k": 1},
))

# --- [hybrid] Zamba2 7B — Mamba2 + shared attn [arXiv:2411.15242] -------------
ZAMBA2_7B = _register(ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64,
    shared_attn_every=6, shared_attn_lora_rank=64,
    microbatches={"train_4k": 4},
))

# --- [moe] Qwen3-MoE 30B-A3B — 128e top-8 [hf:Qwen/Qwen3-30B-A3B] -------------
QWEN3_MOE_30B = _register(ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936, qk_norm=True,
    num_experts=128, experts_per_token=8,
    microbatches={"train_4k": 2},
))

# --- [moe] Llama4 Maverick 400B-A17B — 128e top-1 + shared expert -------------
LLAMA4_MAVERICK = _register(ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_shared_expert=True,
    optimizer="adafactor", grad_dtype="bfloat16",
    microbatches={"train_4k": 8, "prefill_32k": 1},
))

# --- [audio] Whisper-tiny — enc-dec, conv frontend stub [arXiv:2212.04356] ----
WHISPER_TINY = _register(ArchConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, encoder_layers=4,
    d_model=384, num_heads=6, num_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865, mlp="gelu",
    frontend="audio_frames",
    microbatches={"train_4k": 8},
))


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(ARCHS)}")
    return ARCHS[name]
