"""Config schema: architectures (exact published dims) × input shapes."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

from repro_torch.models.moe import MoESpec
from repro_torch.models.ssm import SSMSpec


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    tie_embeddings: bool = True
    norm: str = "rms"                # rms | layer
    post_norms: bool = False         # gemma-2 sandwich norms
    parallel_block: bool = False     # command-r: attn ∥ mlp off one norm
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_period: int = 0     # gemma-2: alternate local/global
    rope_theta: float = 10000.0
    embed_scale: bool = False        # gemma: embeddings * sqrt(D)
    # MoE
    moe: Optional[MoESpec] = None
    moe_period: int = 1              # llama-4: every Nth layer is MoE
    # SSM / hybrid
    ssm: Optional[SSMSpec] = None
    hybrid_period: int = 0           # zamba-2: shared attn block cadence
    # enc-dec / modality frontends (stub embeddings via input_specs)
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_frontend_positions: int = 0    # vlm patches / audio frames
    learned_pos: bool = False        # whisper
    max_positions: int = 0
    # capability flags
    sub_quadratic: bool = False      # may run long_500k
    remat: bool = True
    remat_policy: str = "full"       # full | dots_nb | none
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if not self.hybrid_period else 7),
            d_model=64, d_ff=128 if self.d_ff else 0, vocab=512,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else None,
            sliding_window=8 if self.sliding_window else None,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frontend_positions=8 if self.n_frontend_positions else 0,
            max_positions=128 if self.max_positions else 0,
            name=self.name + "-smoke",
        )
        if self.moe is not None:
            kw["moe"] = MoESpec(n_experts=4, top_k=self.moe.top_k, d_ff=128,
                                capacity_factor=2.0,
                                dense_residual=self.moe.dense_residual)
        if self.ssm is not None:
            kw["ssm"] = SSMSpec(d_inner=128, state_dim=16, head_dim=16,
                                n_groups=1, chunk=16)
        if self.hybrid_period:
            kw["hybrid_period"] = 3
        if self.n_kv_heads and self.n_heads and self.n_kv_heads == self.n_heads:
            kw["n_kv_heads"] = 4  # keep MHA archs MHA
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode is quadratic — skipped per spec"
    return True, ""
