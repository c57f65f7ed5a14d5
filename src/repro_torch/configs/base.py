"""Model / input-shape configuration for the HydraInfer reproduction.

Every assigned architecture gets a ``ModelConfig`` with the exact numbers
from the assignment table, plus a ``reduced()`` variant used by CPU smoke
tests (2 layers, d_model<=512, <=4 experts).  The JAX package's
``input_specs`` (dry-run ShapeDtypeStruct stand-ins) has no counterpart
here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional

# ---------------------------------------------------------------------------
# Layer kinds
# ---------------------------------------------------------------------------
ATTN_MLP = "attn_mlp"          # dense attention + (gated) MLP
ATTN_MOE = "attn_moe"          # dense attention + MoE FFN
MLA_MLP = "mla_mlp"            # multi-head latent attention + dense MLP
MLA_MOE = "mla_moe"            # multi-head latent attention + MoE FFN
MAMBA1 = "mamba1"              # Mamba-1 selective-scan block
MAMBA2 = "mamba2"              # Mamba-2 (SSD) block
SHARED_ATTN = "shared_attn"    # Zamba-style shared attention+MLP block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    act: str = "silu"           # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim (0 -> d_ff)
    first_dense_layers: int = 0  # leading layers with dense FFN (deepseek)
    moe_capacity_factor: float = 1.25  # train/prefill token-drop capacity

    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- SSM ---
    ssm_state: int = 0
    d_inner: int = 0            # 0 -> 2 * d_model
    conv_kernel: int = 4
    dt_rank: int = 0            # 0 -> d_model // 16
    mamba2_head_dim: int = 64

    # --- hybrid (zamba) ---
    attn_every: int = 0         # every Nth layer is a SHARED_ATTN block

    # --- sliding window (gemma3) ---
    sliding_window: int = 0
    global_every: int = 0       # 1 global attention layer per N (others local)

    # --- modality frontend (stub per assignment carve-out) ---
    frontend: str = "none"      # none | vision | audio
    media_tokens: int = 0       # tokens contributed by one media item
    encoder_layers: int = 0     # whisper encoder depth (enc-dec only)
    cross_attention: bool = False
    # analytical vision-tower profile (cost model only; the tower is a stub)
    vision_layers: int = 0
    vision_d_model: int = 0

    source: str = ""            # citation from the assignment table

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family in ("ssm", "hybrid"):
            if self.d_inner == 0:
                object.__setattr__(self, "d_inner", 2 * self.d_model)
            if self.dt_rank == 0:
                object.__setattr__(self, "dt_rank", max(1, self.d_model // 16))

    # ------------------------------------------------------------------
    def layer_kinds(self) -> list[str]:
        """Per-layer block kind, index 0 .. num_layers-1."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append(MAMBA1)
            elif self.family == "hybrid":
                if self.attn_every and (i % self.attn_every) == (self.attn_every - 1):
                    kinds.append(SHARED_ATTN)
                else:
                    kinds.append(MAMBA2)
            elif self.num_experts > 0:
                if self.kv_lora_rank > 0:
                    kinds.append(MLA_MLP if i < self.first_dense_layers else MLA_MOE)
                else:
                    kinds.append(ATTN_MOE)
            else:
                kinds.append(ATTN_MLP)
        return kinds

    def is_local_layer(self, i: int) -> bool:
        """Sliding-window (local) attention layer?  gemma3: 5 local : 1 global."""
        if not self.sliding_window or not self.global_every:
            return False
        return (i % self.global_every) != (self.global_every - 1)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k decode shape."""
        if self.family in ("ssm", "hybrid"):
            return True
        # Sliding-window dense archs qualify: only the sparse global layers
        # hold full-length KV.
        return bool(self.sliding_window and self.global_every)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decoder (whisper is enc-dec)

    @property
    def kv_dim(self) -> int:
        """Flattened per-token KV width for one of K or V."""
        if self.kv_lora_rank:  # MLA compressed cache: latent + shared rope key
            return self.kv_lora_rank + self.qk_rope_head_dim
        return self.num_kv_heads * self.head_dim

    @property
    def n_media(self) -> int:
        return self.media_tokens

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        n_kv = max(1, min(self.num_kv_heads, n_heads))
        upd = dict(
            name=self.name + "-reduced",
            num_layers=2 if self.attn_every == 0 else 2 * self.attn_every,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=64,
            d_ff=max(64, min(self.d_ff, 512)),
            vocab_size=min(self.vocab_size, 512),
            d_inner=0,
            dt_rank=0,
        )
        if self.num_experts:
            upd.update(num_experts=4, experts_per_token=min(2, self.experts_per_token),
                       num_shared_experts=min(1, self.num_shared_experts),
                       moe_d_ff=128, first_dense_layers=min(1, self.first_dense_layers))
        if self.kv_lora_rank:
            upd.update(kv_lora_rank=64, q_lora_rank=64,
                       qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
        if self.sliding_window:
            upd.update(sliding_window=16, global_every=2)
        if self.media_tokens:
            upd.update(media_tokens=16)
        if self.encoder_layers:
            upd.update(encoder_layers=2)
        if self.attn_every:
            # keep hybrid structure: 2*attn_every layers -> 2 shared-attn uses
            upd.update(attn_every=min(self.attn_every, 3),
                       num_layers=2 * min(self.attn_every, 3))
        cfg = replace(self, **upd)
        return cfg


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k":   InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) must be lowered; (ok, reason-if-skip)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch; long_500k needs sub-quadratic attention"
    return True, ""
