"""Whisper-style encoder-decoder backbone, audio frontend stubbed (port of
``repro.models.encdec``).

Encoder: bidirectional attention over precomputed frame embeddings
((B, 1500, D) from the caller: the conv frontend is a stub, as in the
reference), sinusoidal positions, LayerNorm + GELU MLP + biases.
Decoder: causal self-attention (+ KV cache) and cross-attention whose K/V
are computed once from the encoder output and cached for decode.  Every
attention runs through ``flash_attention``: K4 on the card.

As in ``transformer.py`` the layers are lists of per-layer dicts
(``params["encoder"]``, ``params["decoder"]``), where the reference stacks
them and scans; ``interop.encdec_params_from_numpy`` unstacks its tree.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from . import attention as attn_mod
from . import mlp as mlp_mod
from .common import ParamBuilder, sinusoidal_positions
from .config import ModelConfig
from .transformer import _init_norm, _norm, refuse_tf32


def _init_enc_block(pb: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "norm1": _init_norm(pb, cfg),
        "attn": attn_mod.init_attention(pb, cfg),
        "norm2": _init_norm(pb, cfg),
        "mlp": mlp_mod.init_mlp(pb, cfg),
    }


def _init_dec_block(pb: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "norm1": _init_norm(pb, cfg),
        "self_attn": attn_mod.init_attention(pb, cfg),
        "norm_x": _init_norm(pb, cfg),
        "cross_attn": attn_mod.init_cross_attention(pb, cfg),
        "norm2": _init_norm(pb, cfg),
        "mlp": mlp_mod.init_mlp(pb, cfg),
    }


def init_encdec(generator: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Full init on the generator's device, in the reference's draw order
    (its extra draw of one encoder and one decoder block for the axes tree
    has no counterpart: the port's numbers differ from the reference's
    anyway)."""
    pb = ParamBuilder(generator, param_dtype=getattr(torch, cfg.param_dtype))
    return {
        "embed": pb.normal((cfg.vocab, cfg.d_model), stddev=0.02),
        "enc_final_norm": _init_norm(pb, cfg),
        "final_norm": _init_norm(pb, cfg),
        "encoder": [_init_enc_block(pb, cfg) for _ in range(cfg.n_enc_layers)],
        "decoder": [_init_dec_block(pb, cfg) for _ in range(cfg.n_layers)],
    }


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *,
           use_kernel: Optional[bool] = None) -> torch.Tensor:
    """frames: (B, T_enc, D) stub embeddings -> encoder states."""
    cdt = getattr(torch, cfg.compute_dtype)
    refuse_tf32(cdt, params["embed"])
    pos = sinusoidal_positions(frames.shape[1], cfg.d_model, device=frames.device)
    x = frames.to(cdt) + pos.to(cdt)
    for p in params["encoder"]:
        h = _norm(cfg, p["norm1"], x)
        y, _ = attn_mod.attention(p["attn"], h, cfg, causal=False, use_rope=False,
                                  use_kernel=use_kernel)
        x = x + y
        h = _norm(cfg, p["norm2"], x)
        x = x + mlp_mod.mlp(p["mlp"], h, cfg)
    return _norm(cfg, params["enc_final_norm"], x)


def decode(
    params, tokens: torch.Tensor, enc_out: Optional[torch.Tensor], cfg: ModelConfig,
    caches: Optional[List[Dict[str, Any]]] = None, *,
    use_kernel: Optional[bool] = None, last_only: bool = False,
    cross_kv: Optional[List[Dict[str, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, Optional[List[Dict[str, Any]]]]:
    """``cross_kv``: one {"k","v"} (B, Hkv, T_enc, hd) a layer, the
    cross-attention's projections of the encoder output, computed once at
    prefill (:func:`compute_cross_kv`).  Without it every call re-projects
    ``enc_out`` through every layer's wk/wv."""
    cdt = getattr(torch, cfg.compute_dtype)
    refuse_tf32(cdt, params["embed"])
    x = params["embed"][tokens.long()].to(cdt)
    new_caches = None if caches is None else []
    for i, p in enumerate(params["decoder"]):
        h = _norm(cfg, p["norm1"], x)
        y, c = attn_mod.attention(p["self_attn"], h, cfg,
                                  cache=None if caches is None else caches[i],
                                  use_kernel=use_kernel)
        x = x + y
        h = _norm(cfg, p["norm_x"], x)
        x = x + attn_mod.cross_attention(p["cross_attn"], h, enc_out, cfg, use_kernel=use_kernel,
                                         kv=None if cross_kv is None else cross_kv[i])
        h = _norm(cfg, p["norm2"], x)
        x = x + mlp_mod.mlp(p["mlp"], h, cfg)
        if new_caches is not None:
            new_caches.append(c)
    x = _norm(cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:]  # prefill fast path: head on the final position only
    logits = x @ params["embed"].to(cdt).t()
    return logits.float(), new_caches


def init_dec_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device=None) -> List[Dict[str, Any]]:
    return [attn_mod.init_cache(cfg, batch, max_len, dtype, device) for _ in range(cfg.n_layers)]


def compute_cross_kv(params, enc_out: torch.Tensor,
                     cfg: ModelConfig) -> List[Dict[str, torch.Tensor]]:
    """Each decoder layer's cross-attention K/V of the encoder output:
    a list of {"k","v"} (B, Hkv, T_enc, hd)."""
    return [attn_mod.cross_kv(p["cross_attn"], enc_out) for p in params["decoder"]]
