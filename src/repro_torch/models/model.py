"""Public model API: build_model(cfg) -> Model with init/loss/prefill/decode
(port of ``repro.models.model``): decoder-only models over
``transformer.py`` and whisper's encoder-decoder over ``encdec.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from .. import _device
from ..parallel import tensor as tp
from . import encdec as encdec_mod
from . import transformer as tf_mod
from .config import ModelConfig


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE in fp32. logits (B,T,V) fp32, labels (B,T) int.
    Logits split over the vocabulary on a model axis (a DTensor, the
    tensor-parallel LM) take the vocab-parallel loss
    (``parallel.tensor.cross_entropy``): no rank gathers them whole."""
    if tp.is_dtensor(logits):
        return tp.cross_entropy(logits, labels)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def _generator(seed: Union[int, torch.Generator, None], device) -> Optional[torch.Generator]:
    if seed is None or isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=_device.resolve(device)).manual_seed(int(seed))


@dataclasses.dataclass
class Model:
    """Bundle of functions for one architecture.  ``init(seed, device=None)``
    returns the params drawn on the device; ``init(seed, device,
    with_axes=True)`` returns ``(params, axes)`` as the reference's
    ``init(key)`` does (its logical axes in the port's per-layer layout:
    ``parallel.sharding`` maps them to a mesh); ``init(None,
    with_axes=True)`` builds ``meta`` tensors, the shapes and axes alone."""

    cfg: ModelConfig
    init: Callable[..., Any]                 # (seed | generator | None, device, with_axes)
    loss_fn: Callable[..., torch.Tensor]     # (params, batch) -> loss
    forward: Callable[..., torch.Tensor]     # logits
    prefill: Callable[..., Any]              # (params, tokens, cache) -> (logits (B,V), cache')
    decode_step: Callable[..., Any]          # (params, tokens (B,1), cache) -> (logits, cache')
    init_cache: Callable[..., Any]           # (batch, max_len, dtype, device) -> caches


def build_model(cfg: ModelConfig, *, use_kernel: Optional[bool] = None,
                ring_local: bool = False, remat: bool = False,
                remat_policy: str = "full") -> Model:
    """``use_kernel`` is the reference's ``use_pallas``: None takes the
    tensors' device (K4 on the card, the plain version on the CPU).
    ``remat``/``remat_policy`` apply to ``loss_fn``, as in the reference
    (``transformer.decoder_stack``; the encoder-decoder, like the
    reference's, takes neither)."""
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.enc_dec:
        return _build_encdec(cfg, use_kernel)

    def init(seed: Union[int, torch.Generator, None] = 0, device=None, with_axes: bool = False):
        return tf_mod.init_lm(_generator(seed, device), cfg, with_axes)

    def forward(params, tokens, embeds=None):
        logits, _, _ = tf_mod.lm_forward(params, tokens, cfg, embeds=embeds,
                                         use_kernel=use_kernel)
        return logits

    def loss_fn(params, batch):
        """batch: {"tokens": (B,T), "labels": (B,T), optional "embeds"}."""
        logits, _, aux = tf_mod.lm_forward(params, batch["tokens"], cfg,
                                           embeds=batch.get("embeds"), use_kernel=use_kernel,
                                           remat=remat, remat_policy=remat_policy)
        labels = batch["labels"]
        if batch.get("embeds") is not None:
            # loss only over the token suffix (stub prefix carries no labels)
            logits = logits[:, -labels.shape[1]:]
        return cross_entropy(logits, labels) + 0.01 * aux

    def prefill(params, tokens, cache, embeds=None):
        logits, cache, _ = tf_mod.lm_forward(params, tokens, cfg, embeds=embeds,
                                             caches=cache, use_kernel=use_kernel,
                                             last_only=True)
        return logits[:, -1], cache

    def decode_step(params, tokens, cache):
        """tokens: (B, 1) -> (logits (B, V), cache')."""
        logits, cache, _ = tf_mod.lm_forward(params, tokens, cfg, caches=cache,
                                             use_kernel=use_kernel)
        return logits[:, -1], cache

    def init_cache(batch, max_len, dtype=None, device=None):
        return tf_mod.init_lm_caches(cfg, batch, max_len, dtype or cdt,
                                     ring_local=ring_local, device=_device.resolve(device))

    return Model(cfg, init, loss_fn, forward, prefill, decode_step, init_cache)


def _build_encdec(cfg: ModelConfig, use_kernel: Optional[bool]) -> Model:
    """Whisper: ``embeds`` (B, T_enc, D) are the stub frames the encoder
    reads.  The cache is {"dec": per-layer KV caches, "cross_kv": per-layer
    cross-attention K/V}; ``cross_kv`` is None until the prefill projects
    the encoder output once (the reference allocates zeros there).
    Parameters laid out over a mesh (DTensors) are gathered whole: the
    model axis's ranks compute the encoder-decoder alike."""

    def init(seed: Union[int, torch.Generator, None] = 0, device=None, with_axes: bool = False):
        return encdec_mod.init_encdec(_generator(seed, device), cfg, with_axes)

    def forward(params, tokens, embeds=None):
        params = tp.whole_tree(params)
        enc = encdec_mod.encode(params, embeds, cfg, use_kernel=use_kernel)
        logits, _ = encdec_mod.decode(params, tokens, enc, cfg, use_kernel=use_kernel)
        return logits

    def loss_fn(params, batch):
        logits = forward(params, batch["tokens"], batch["embeds"])
        return cross_entropy(logits, batch["labels"])

    def prefill(params, tokens, cache, embeds=None):
        enc = encdec_mod.encode(params, embeds, cfg, use_kernel=use_kernel)
        # project the encoder output through every layer's cross-attn K/V
        # ONCE: the decode steps reuse it
        cross = encdec_mod.compute_cross_kv(params, enc, cfg)
        logits, dec_c = encdec_mod.decode(params, tokens, enc, cfg, cache["dec"],
                                          use_kernel=use_kernel, last_only=True,
                                          cross_kv=cross)
        return logits[:, -1], dict(cache, dec=dec_c, cross_kv=cross)

    def decode_step(params, tokens, cache):
        logits, dec_c = encdec_mod.decode(params, tokens, None, cfg, cache["dec"],
                                          use_kernel=use_kernel, cross_kv=cache["cross_kv"])
        return logits[:, -1], dict(cache, dec=dec_c)

    def init_cache(batch, max_len, dtype=None, device=None):
        cdt = dtype or getattr(torch, cfg.compute_dtype)
        return {"dec": encdec_mod.init_dec_caches(cfg, batch, max_len, cdt,
                                                  _device.resolve(device)),
                "cross_kv": None}

    return Model(cfg, init, loss_fn, forward, prefill, decode_step, init_cache)
