"""Architecture configuration schema (a copy of ``repro.models.config``,
pure Python, so the port imports nothing of the JAX package).

One ``ModelConfig`` describes every assigned architecture via a repeating
*block pattern* (the unit that ``lax.scan`` iterates), e.g.:

  dense llama-style      : ("attn",)
  gemma2 local/global    : ("attn_local", "attn_global")
  recurrentgemma 2:1     : ("rglru", "rglru", "attn_local")
  xlstm m/s alternation  : ("mlstm", "slstm")

Each block is (sequence-mixer + MLP/MoE) with pre-norms; mixer-specific
fields live in the config.  ``[audio]``/``[vlm]`` archs set ``frontend`` and
receive precomputed frame/patch embeddings from ``input_specs()`` (stub per
the assignment).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 1.25
    router_softcap: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    # attention
    rope_theta: float = 10000.0
    window: Optional[int] = None            # sliding window for *_local blocks
    attn_softcap: Optional[float] = None    # gemma2 attention logit cap
    final_softcap: Optional[float] = None   # gemma2 final logit cap
    attn_bias: bool = False
    # mlp
    mlp: str = "swiglu"                     # swiglu | geglu | gelu
    moe: Optional[MoEConfig] = None
    # norms / embeddings
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    post_block_norm: bool = False           # gemma2 post-norms
    rms_scale_plus_one: bool = False        # gemma-style (1+w)
    tie_embeddings: bool = True
    embed_scale: bool = False               # gemma: x * sqrt(d_model)
    # recurrent blocks
    lru_width: Optional[int] = None         # RG-LRU state width
    conv_width: int = 4                     # temporal conv in recurrent block
    mlstm_proj_factor: float = 2.0
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500                  # whisper audio frames (stubbed)
    # modality frontend stub: none | audio_stub | vision_stub
    frontend: str = "none"
    n_patches: int = 2880                   # llava anyres patch count (stub)
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # attention sub-quadratic? (drives long_500k applicability)
    family: str = "dense"                   # dense | moe | ssm | hybrid | audio | vlm

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.pattern_period:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {self.pattern_period}"
            )
        return self.n_layers // self.pattern_period

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends over unbounded context (long_500k rule)."""
        return all(b in ("rglru", "mlstm", "slstm", "attn_local")
                   for b in self.block_pattern)

    def n_params(self) -> int:
        """Approximate parameter count (for 6ND model-flops accounting)."""
        d, hd = self.d_model, self.head_dim_
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
        if self.moe is not None:
            ff_dense = 0
            moe = self.moe.n_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
            moe += self.moe.n_shared * 3 * d * self.moe.d_ff_expert
        else:
            ff_dense = 3 * d * self.d_ff if self.mlp in ("swiglu", "geglu") else 2 * d * self.d_ff
            moe = 0
        per_block = {}
        for b in set(self.block_pattern):
            if b.startswith("attn"):
                mix = attn
            elif b == "rglru":
                w = self.lru_width or d
                mix = 2 * d * w + w * d + 3 * w + w * self.conv_width
            elif b == "mlstm":
                di = int(d * self.mlstm_proj_factor)
                mix = 2 * d * di + 3 * di * di // max(self.n_heads, 1) + di * d
            elif b == "slstm":
                mix = 8 * d * d // max(self.n_heads, 1) + d * d
            else:
                raise ValueError(b)
            per_block[b] = mix + ff_dense + moe + 2 * d
        body = self.n_groups * sum(per_block[b] for b in self.block_pattern)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.enc_dec:
            enc = self.n_enc_layers * (attn + ff_dense + 2 * d) + body // self.n_layers * 0
            body += self.n_layers * (self.n_heads * hd * d + d * (self.n_heads + 2 * self.n_kv_heads) * hd)  # cross-attn
        return int(body + emb + enc)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        moe_all = self.n_layers * self.moe.n_experts * 3 * self.d_model * self.moe.d_ff_expert
        moe_act = self.n_layers * (self.moe.top_k + self.moe.n_shared) * 3 * self.d_model * self.moe.d_ff_expert
        return int(full - moe_all + moe_act)
