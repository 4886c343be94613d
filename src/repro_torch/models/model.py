"""Public model API: build_model(cfg) -> Model with init/loss/prefill/decode
(port of ``repro.models.model``, decoder-only models)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from .. import _device
from . import transformer as tf_mod
from .config import ModelConfig


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE in fp32. logits (B,T,V) fp32, labels (B,T) int."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


@dataclasses.dataclass
class Model:
    """Bundle of functions for one architecture.  Unlike the reference's
    ``init(key) -> (params, axes)``, ``init(seed, device=None)`` returns the
    params alone (the port has no sharding axes yet), drawn on the device."""

    cfg: ModelConfig
    init: Callable[..., Any]                 # (seed | generator, device) -> params
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
    (``transformer.decoder_stack``)."""
    tf_mod._check_ported(cfg)
    cdt = getattr(torch, cfg.compute_dtype)

    def init(seed: Union[int, torch.Generator] = 0, device=None):
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=_device.resolve(device)).manual_seed(int(seed))
        return tf_mod.init_lm(gen, cfg)

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
