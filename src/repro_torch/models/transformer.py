"""Decoder-only transformer assembly over a repeating block pattern (port of
``repro.models.transformer``).

The reference stacks each pattern position's parameters over a leading
``n_groups`` axis and ``lax.scan``s over groups (HLO size O(1) in depth).
PyTorch runs eagerly, so the port keeps one parameter dict per layer in
``params["blocks"]`` (layer ``i`` has kind ``block_pattern[i % period]``)
and loops over them; ``interop.lm_params_from_numpy`` unstacks the
reference's tree into this form.  Caches are a list of per-layer dicts.

Every mixer of the reference is here: attention (``attn``,
``attn_local``, ``attn_global``), recurrentgemma's RG-LRU (``rglru``) and
xLSTM's cells (``mlstm``, ``slstm``), whose per-layer cache is their
recurrent state; the MLP is dense or MoE (``cfg.moe``).

``remat`` (training, no cache) recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant): ``remat_policy="full"`` keeps
only the layer's input, ``"dots"`` also keeps the matrix products' outputs
(selective checkpointing, the counterpart of
``jax.checkpoint_policies.checkpoint_dots``).  The reference checkpoints each
group of ``block_pattern``; the port each layer.  Either way every
attention's forward runs twice in a training step.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from . import attention as attn_mod
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import xlstm as xlstm_mod
from .common import ParamBuilder, layer_norm, rms_norm, softcap
from .config import ModelConfig

ATTN_KINDS = ("attn", "attn_local", "attn_global")

MIXER_INIT = {
    "attn": attn_mod.init_attention,
    "attn_local": attn_mod.init_attention,
    "attn_global": attn_mod.init_attention,
    "rglru": rglru_mod.init_rglru_block,
    "mlstm": xlstm_mod.init_mlstm,
    "slstm": xlstm_mod.init_slstm,
}


def refuse_tf32(cdt: torch.dtype, weight: torch.Tensor) -> None:
    """An fp32 model on the card must not run its products in TF32."""
    if cdt == torch.float32 and torch.backends.cuda.matmul.allow_tf32 and weight.is_cuda:
        raise RuntimeError("an fp32 model on the card needs full-fp32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False "
                           "(_device.full_fp32_matmuls)")


def block_kinds(cfg: ModelConfig) -> List[str]:
    """The kind of every layer, in order."""
    return [cfg.block_pattern[i % cfg.pattern_period] for i in range(cfg.n_layers)]


def _norm(cfg: ModelConfig, params, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, params["scale"], params.get("bias"))
    return rms_norm(x, params["scale"], scale_plus_one=cfg.rms_scale_plus_one)


def _init_norm(pb: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": pb.ones((d,)), "bias": pb.zeros((d,))}
    init = pb.zeros if cfg.rms_scale_plus_one else pb.ones
    return {"scale": init((d,))}


def init_block(pb: ParamBuilder, cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "norm1": _init_norm(pb, cfg),
        "mixer": MIXER_INIT[kind](pb, cfg),
    }
    has_mlp = cfg.d_ff > 0 or cfg.moe is not None
    if has_mlp:
        p["norm2"] = _init_norm(pb, cfg)
        p["mlp"] = (moe_mod.init_moe(pb, cfg) if cfg.moe is not None
                    else mlp_mod.init_mlp(pb, cfg))
    if cfg.post_block_norm:
        p["post_norm1"] = _init_norm(pb, cfg)
        if has_mlp:
            p["post_norm2"] = _init_norm(pb, cfg)
    return p


def apply_block(
    params: Dict[str, Any],
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: str,
    cache: Optional[Dict[str, Any]] = None,
    *,
    use_kernel: Optional[bool] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """Returns (x', cache', aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _norm(cfg, params["norm1"], x)
    if kind in ATTN_KINDS:
        y, cache = attn_mod.attention(params["mixer"], h, cfg, local=kind == "attn_local",
                                      cache=cache, use_kernel=use_kernel)
    elif kind == "rglru":
        y, cache = rglru_mod.rglru_block(params["mixer"], h, cfg, cache)
    elif kind == "mlstm":
        y, cache = xlstm_mod.mlstm(params["mixer"], h, cfg, cache)
    elif kind == "slstm":
        y, cache = xlstm_mod.slstm(params["mixer"], h, cfg, cache)
    else:
        raise ValueError(kind)
    if cfg.post_block_norm:
        y = _norm(cfg, params["post_norm1"], y)
    x = x + y
    if "mlp" in params:
        h = _norm(cfg, params["norm2"], x)
        if cfg.moe is not None:
            y, aux = moe_mod.moe_block(params["mlp"], h, cfg)
        else:
            y = mlp_mod.mlp(params["mlp"], h, cfg)
        if cfg.post_block_norm:
            y = _norm(cfg, params["post_norm2"], y)
        x = x + y
    return x, cache, aux


# ---------------------------------------------------------------------------
# Full decoder stack
# ---------------------------------------------------------------------------

def init_decoder(pb: ParamBuilder, cfg: ModelConfig) -> List[Dict[str, Any]]:
    """One parameter dict per layer, in the reference's draw order (group by
    group, pattern position by position)."""
    return [init_block(pb, cfg, kind) for kind in block_kinds(cfg)]


# The matrix products whose outputs remat_policy="dots" keeps.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(params, x, cfg, kind, use_kernel, policy):
    """``apply_block`` without a cache under ``torch.utils.checkpoint``."""
    def run(x):
        y, _, a = apply_block(params, x, cfg, kind, use_kernel=use_kernel)
        return y, a

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _save_dots)
    y, a = ckpt.checkpoint(run, x, use_reentrant=False, **kw)
    return y, None, a


def decoder_stack(
    blocks: List[Dict[str, Any]],
    x: torch.Tensor,
    cfg: ModelConfig,
    caches: Optional[List[Dict[str, Any]]] = None,
    *,
    use_kernel: Optional[bool] = None,
    remat: bool = False,
    remat_policy: str = "full",
) -> Tuple[torch.Tensor, Optional[List[Dict[str, Any]]], torch.Tensor]:
    """Apply every layer in order; ``caches`` is a list of per-layer caches.
    ``remat`` (no caches): recompute each layer in the backward, keeping
    its input (``remat_policy="full"``) or also its matrix products
    (``"dots"``; any other value is ``"full"``, as in the reference)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = None if caches is None else []
    for i, kind in enumerate(block_kinds(cfg)):
        c = None if caches is None else caches[i]
        if remat and caches is None:
            x, c, a = _remat_block(blocks[i], x, cfg, kind, use_kernel, remat_policy)
        else:
            x, c, a = apply_block(blocks[i], x, cfg, kind, c, use_kernel=use_kernel)
        aux = aux + a
        if new_caches is not None:
            new_caches.append(c)
    return x, new_caches, aux


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Full LM init on the generator's device (the reference's distributions,
    not its numbers)."""
    pb = ParamBuilder(generator, param_dtype=getattr(torch, cfg.param_dtype))
    params: Dict[str, Any] = {"embed": pb.normal((cfg.vocab, cfg.d_model), stddev=0.02)}
    params["blocks"] = init_decoder(pb, cfg)
    params["final_norm"] = _init_norm(pb, cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = pb.fan_in((cfg.d_model, cfg.vocab), fan_axis=0)
    return params


def lm_forward(
    params: Dict[str, Any],
    tokens: Optional[torch.Tensor],
    cfg: ModelConfig,
    *,
    embeds: Optional[torch.Tensor] = None,
    caches: Optional[List[Dict[str, Any]]] = None,
    use_kernel: Optional[bool] = None,
    remat: bool = False,
    remat_policy: str = "full",
    last_only: bool = False,
) -> Tuple[torch.Tensor, Optional[List[Dict[str, Any]]], torch.Tensor]:
    """tokens (B, T) and/or precomputed ``embeds`` (B, P, D) prefix (vlm/audio
    stubs).  Returns (logits fp32, caches', aux).

    ``last_only``: project only the final position through the LM head (the
    prefill fast path: at phi4-mini's vocab of 200064 a (4, 1023) prompt's
    full logits would be 3.3 GB of fp32)."""
    cdt = getattr(torch, cfg.compute_dtype)
    refuse_tf32(cdt, params["embed"])
    parts = []
    if embeds is not None:
        parts.append(embeds.to(cdt))
    if tokens is not None:
        parts.append(params["embed"][tokens.long()].to(cdt))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt)
    x, caches, aux = decoder_stack(params["blocks"], x, cfg, caches, use_kernel=use_kernel,
                                   remat=remat, remat_policy=remat_policy)
    x = _norm(cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    head = params.get("lm_head")
    if head is None:
        logits = x @ params["embed"].to(cdt).t()
    else:
        logits = x @ head.to(cdt)
    logits = softcap(logits.float(), cfg.final_softcap)
    return logits, caches, aux


def init_lm_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   ring_local: bool = False, device=None) -> List[Dict[str, Any]]:
    """One cache per layer: a KV cache for attention, the recurrent state
    (fp32, O(1) in ``max_len``) for ``rglru``, ``mlstm`` and ``slstm``.
    ``ring_local``: local (sliding-window) layers get a bounded ring buffer
    of exactly ``window`` slots instead of a full-context buffer (decode
    only; see attention.py)."""
    caches = []
    for kind in block_kinds(cfg):
        if kind == "rglru":
            c = rglru_mod.init_rglru_state(cfg, batch, device)
        elif kind == "mlstm":
            c = xlstm_mod.init_mlstm_state(cfg, batch, device)
        elif kind == "slstm":
            c = xlstm_mod.init_slstm_state(cfg, batch, device)
        elif kind not in ATTN_KINDS:
            raise ValueError(kind)
        elif (ring_local and kind == "attn_local" and cfg.window is not None
                and cfg.window < max_len):
            c = attn_mod.init_cache(cfg, batch, cfg.window, dtype, device)
            c["ring"] = True
        else:
            c = attn_mod.init_cache(cfg, batch, max_len, dtype, device)
        caches.append(c)
    return caches
