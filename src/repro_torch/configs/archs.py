"""The ten architectures at their published dimensions, one ModelConfig
each, with the source of its dimensions beside it (the reference package's
``repro/configs/archs.py``, copied).  ``LM`` builds, trains and serves
every one of them.
"""
from __future__ import annotations

from repro_torch.models.moe import MoESpec
from repro_torch.models.ssm import SSMSpec

from .base import ModelConfig

ARCTIC_480B = ModelConfig(
    # [hf:Snowflake/snowflake-arctic-base] — 128 experts top-2 + dense residual
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000, tie_embeddings=False,
    moe=MoESpec(n_experts=128, top_k=2, d_ff=4864, dense_residual=True),
    rope_theta=10_000.0,
)

LLAMA4_MAVERICK = ModelConfig(
    # [hf:meta-llama/Llama-4-*] — MoE every 2nd layer (matches 400B total /
    # 17B active with the given 48L/128e/top-1 numbers), shared expert branch.
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048, tie_embeddings=False,
    moe=MoESpec(n_experts=128, top_k=1, d_ff=8192, dense_residual=True),
    moe_period=2, rope_theta=500_000.0,
)

INTERNVL2_26B = ModelConfig(
    # [arXiv:2404.16821] — InternViT frontend (stub patch embeddings) +
    # InternLM2 backbone.
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553, tie_embeddings=False,
    n_frontend_positions=256, rope_theta=1_000_000.0,
)

ZAMBA2_1_2B = ModelConfig(
    # [arXiv:2411.15242] — Mamba-2 backbone + shared attention block every 6
    # layers (6 applications over 38 layers), MHA 32 heads.
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000, tie_embeddings=True,
    ssm=SSMSpec(d_inner=4096, state_dim=64, head_dim=64, n_groups=1),
    hybrid_period=6, sub_quadratic=True,
)

MAMBA2_780M = ModelConfig(
    # [arXiv:2405.21060] — SSD, attention-free.
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, d_ff=0, vocab=50280, tie_embeddings=True,
    ssm=SSMSpec(d_inner=3072, state_dim=128, head_dim=64, n_groups=1),
    sub_quadratic=True,
)

GEMMA2_9B = ModelConfig(
    # [arXiv:2408.00118] — local(4096)/global alternating, softcaps,
    # sandwich norms, embed scaling, head_dim 256.
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000, tie_embeddings=True,
    local_global_period=2, sliding_window=4096,
    attn_softcap=50.0, logit_softcap=30.0, post_norms=True, embed_scale=True,
)

CODEQWEN15_7B = ModelConfig(
    # [hf:Qwen/CodeQwen1.5-7B] — qwen1.5 arch: MHA + QKV bias.
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab=92416, qkv_bias=True, tie_embeddings=False,
    rope_theta=1_000_000.0,
)

COMMAND_R_35B = ModelConfig(
    # [hf:CohereForAI/c4ai-command-r-v01] — parallel attn∥mlp blocks,
    # LayerNorm, no bias, tied embeddings.
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab=256000, tie_embeddings=True,
    norm="layer", parallel_block=True, rope_theta=8_000_000.0,
)

QWEN2_0_5B = ModelConfig(
    # [arXiv:2407.10671] — GQA kv=2, QKV bias, tied embeddings.
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
)

WHISPER_SMALL = ModelConfig(
    # [arXiv:2212.04356] — enc-dec, conv frontend stubbed as precomputed
    # frame embeddings (1500 positions), learned positions, GELU MLP.
    # max_positions extended to cover the assigned decode_32k shape.
    name="whisper-small", family="audio",
    n_layers=12, n_enc_layers=12, enc_dec=True,
    d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51865, tie_embeddings=True,
    norm="layer", learned_pos=True, max_positions=32_768,
    n_frontend_positions=1500,
)

ARCHS = {c.name: c for c in [
    ARCTIC_480B, LLAMA4_MAVERICK, INTERNVL2_26B, ZAMBA2_1_2B, MAMBA2_780M,
    GEMMA2_9B, CODEQWEN15_7B, COMMAND_R_35B, QWEN2_0_5B, WHISPER_SMALL,
]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
