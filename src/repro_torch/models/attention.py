"""GQA attention block: full/local (sliding-window), softcap, RoPE, KV cache
(port of ``repro.models.attention``).

Every attention here goes through :func:`..kernels.flash_attention.flash_attention`:
the CUDA kernel (K4) for tensors on the card, the plain version on the CPU.
The reference sends the cached paths to its jnp oracles because its Pallas
kernel takes the query offset and valid length as static arguments; K4 takes
them at run time, so on the card the no-cache forward, prefill, decode and
the ring cache all run on it, computing what the reference computes there.

``cross_attention`` (whisper's decoder) is non-causal over the encoder's
keys and values, which ``cross_kv`` projects once at prefill.

The cache of one layer is ``{"k": (B, Hkv, Tmax, hd), "v": ..., "pos": int}``
(``"ring": True`` for a bounded sliding-window buffer).  The reference's
cache is immutable and its ``pos`` a traced scalar; here the buffers are
written in place and ``pos`` is a Python int, so prefill and decode make no
host sync per layer.  The returned cache shares the buffers.

Parameters laid out over a ``(data, model)`` mesh (DTensors,
``parallel.tensor``) run tensor parallel without a cache: with the heads
split over the model axis each rank projects its own q heads (and its kv
heads, or the whole kv projection when the rules keep the kv heads whole),
K4 runs on its local heads (``flash_attention`` takes the DTensors), and
the output projection's partial sums are added over the axis; otherwise
the ranks gather the weights and compute the block alike.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import flash_attention
from ..parallel import tensor as tp
from .common import ParamBuilder, rope_tables, rotate
from .config import ModelConfig


def init_attention(pb: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": pb.fan_in((d, hq, hd), ("embed", "heads", "head_dim"), fan_axis=0),
        "wk": pb.fan_in((d, hkv, hd), ("embed", "kv_heads", "head_dim"), fan_axis=0),
        "wv": pb.fan_in((d, hkv, hd), ("embed", "kv_heads", "head_dim"), fan_axis=0),
        "wo": pb.fan_in((hq, hd, d), ("heads", "head_dim", "embed"), fan_axis=(0, 1)),
    }
    if cfg.attn_bias:
        p["bq"] = pb.zeros((hq, hd), ("heads", "head_dim"))
        p["bk"] = pb.zeros((hkv, hd), ("kv_heads", "head_dim"))
        p["bv"] = pb.zeros((hkv, hd), ("kv_heads", "head_dim"))
        p["bo"] = pb.zeros((d,), ("embed",))
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dhk->bhtk"): (B, T, d) x (d, H, hd) -> a (B, H, T, hd) view."""
    B, T, _ = x.shape
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).view(B, T, h, k).transpose(1, 2)


def _project(params, x, use_rope, positions, cfg):
    """x: (B, T, D) -> q (B,Hq,T,hd), k/v (B,Hkv,T,hd)."""
    q, k, v = _heads(x, params["wq"]), _heads(x, params["wk"]), _heads(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)[None, :, None, :]
        k = k + params["bk"].to(x.dtype)[None, :, None, :]
        v = v + params["bv"].to(x.dtype)[None, :, None, :]
    if use_rope:
        cos, sin = rope_tables(positions, q.shape[-1], cfg.rope_theta)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    return q, k, v


def _out(params, o):
    """(B, Hq, T, hd) -> (B, T, D): einsum("bhtk,hkd->btd")."""
    B, H, T, hd = o.shape
    w = params["wo"].to(o.dtype)
    y = o.transpose(1, 2).reshape(B, T, H * hd) @ w.reshape(H * hd, w.shape[-1])
    if "bo" in params:
        y = y + params["bo"].to(o.dtype)
    return y


def _write(buf: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """``buf[:, :, pos:pos+T] = new`` in place.  The reference's
    ``dynamic_update_slice`` clamps the start so the write fits, silently
    overwriting earlier entries past ``Tmax``; the port refuses instead."""
    T, t_max = new.shape[2], buf.shape[2]
    if not 0 <= pos <= pos + T <= t_max:
        raise ValueError(f"cache write of {T} tokens at pos {pos} overruns max_len {t_max}")
    buf[:, :, pos:pos + T] = new


def attention(
    params: Dict[str, Any],
    x: torch.Tensor,                      # (B, T, D)
    cfg: ModelConfig,
    *,
    local: bool = False,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, Any]] = None,
    use_rope: bool = True,
    use_kernel: Optional[bool] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Self-attention with optional KV cache.

    cache: {"k": (B,Hkv,Tmax,hd), "v": ..., "pos": int} — appends at ``pos``
    (in place) and attends over the valid prefix.  Returns (y, cache')."""
    B, T, _ = x.shape
    window = cfg.window if local else None
    if tp.is_dtensor(params["wq"]):
        if cache is not None:
            raise NotImplementedError("a KV cache of a tensor-parallel model: the port trains "
                                      "over a model axis and serves on one card")
        return _attention_tp(params, x, cfg, window, causal, positions, use_rope,
                             use_kernel), None
    if positions is None:
        base = 0 if cache is None else cache["pos"]
        positions = (base + torch.arange(T, device=x.device))[None, :].expand(B, T)
    q, k, v = _project(params, x, use_rope, positions, cfg)

    if cache is not None and cache.get("ring"):
        # Bounded ring buffer for local (sliding-window) layers: it holds
        # exactly the last `window` tokens, and every stored token is within
        # the window of the current query and in its past.
        if T != 1:
            raise ValueError("ring caches support decode (T=1) only")
        pos, wbuf = cache["pos"], cache["k"].shape[2]
        slot = pos % wbuf
        _write(cache["k"], k, slot)
        _write(cache["v"], v, slot)
        o = flash_attention(q, cache["k"], cache["v"], causal=False, window=None,
                            softcap=cfg.attn_softcap, q_offset=0,
                            tk_valid=min(pos + 1, wbuf), use_kernel=use_kernel)
        return _out(params, o), dict(cache, pos=pos + 1)

    if cache is not None:
        pos = cache["pos"]
        _write(cache["k"], k, pos)
        _write(cache["v"], v, pos)
        # On the card K4 reads only the valid prefix; on the CPU the plain
        # version masks the rest of the buffer, as the reference does.
        o = flash_attention(q, cache["k"], cache["v"], causal=causal, window=window,
                            softcap=cfg.attn_softcap, q_offset=pos, tk_valid=pos + T,
                            use_kernel=use_kernel)
        return _out(params, o), dict(cache, pos=pos + T)

    o = flash_attention(q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap,
                        use_kernel=use_kernel)
    return _out(params, o), None


def _attention_tp(params, x, cfg, window, causal, positions, use_rope, use_kernel):
    """The no-cache attention of DTensor parameters (see the module's
    docstring): K4 on each rank's heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    B, T, _ = x.shape
    (wq, wo), group = tp.split((params["wq"], 1), (params["wo"], 0))
    local = {"wq": wq}
    kv_split = False
    if group is None:  # heads whole on every rank: the block computed alike
        local.update(wk=tp.whole(params["wk"]), wv=tp.whole(params["wv"]))
    else:
        (wk, wv), kv_group = tp.split((params["wk"], 1), (params["wv"], 1))
        kv_split = kv_group is not None
        if not kv_split:  # kv heads whole: their gradient is summed over the axis
            wk, wv = tp.copy_to(wk, group), tp.copy_to(wv, group)
        local.update(wk=wk, wv=wv)
        x = tp.copy_to(x, group)
    if "bq" in params:
        local["bq"] = tp.local(params["bq"]) if group is not None else tp.whole(params["bq"])
        for b in ("bk", "bv"):
            bias = tp.local(params[b]) if kv_split else tp.whole(params[b])
            local[b] = tp.copy_to(bias, group) if group is not None and not kv_split else bias
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    q, k, v = _project(local, x, use_rope, positions, cfg)
    mesh = tp.model_mesh(params["wq"])

    def wrap(t, split_heads, heads):
        shape = (B, heads, *t.shape[2:])
        return DTensor.from_local(t, mesh, [Shard(1) if split_heads else Replicate()],
                                  run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    o = flash_attention(wrap(q, group is not None, cfg.n_heads),
                        wrap(k, kv_split, cfg.n_kv_heads), wrap(v, kv_split, cfg.n_kv_heads),
                        causal=causal, window=window, softcap=cfg.attn_softcap,
                        use_kernel=use_kernel).to_local()
    y = tp.reduce_from(_out({"wo": wo}, o), group)
    if "bo" in params:
        y = y + tp.whole(params["bo"]).to(y.dtype)
    return y


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device=None) -> Dict[str, Any]:
    """Zeroed buffers: the plain route weighs masked slots by 0, which a
    stale NaN would turn into NaN; K4 never reads them."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
        "pos": 0,
    }


def init_cross_attention(pb: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    return init_attention(pb, cfg)


def cross_kv(params, enc: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The cross-attention's keys and values of the encoder output ``enc``
    (B, Tk, D): {"k", "v"} (B, Hkv, Tk, hd)."""
    k, v = _heads(enc, params["wk"]), _heads(enc, params["wv"])
    if "bk" in params:
        k = k + params["bk"].to(k.dtype)[None, :, None, :]
        v = v + params["bv"].to(v.dtype)[None, :, None, :]
    return {"k": k, "v": v}


def cross_attention(
    params: Dict[str, Any],
    x: torch.Tensor,                      # (B, Tq, D) decoder states
    enc: Optional[torch.Tensor],          # (B, Tk, D) encoder output
    cfg: ModelConfig,
    *,
    use_kernel: Optional[bool] = None,
    kv: Optional[Dict[str, torch.Tensor]] = None,  # precomputed {"k","v"}
) -> torch.Tensor:
    """Non-causal attention of the decoder states over the encoder output,
    no RoPE; ``kv`` (from :func:`cross_kv`) spares the projection of
    ``enc``."""
    q = _heads(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)[None, :, None, :]
    if kv is None:
        kv = cross_kv(params, enc)
    o = flash_attention(q, kv["k"].to(x.dtype), kv["v"].to(x.dtype), causal=False,
                        use_kernel=use_kernel)
    return _out(params, o)
