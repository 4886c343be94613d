"""Shape-only inputs and their shardings for every (arch, shape) (port of
``repro.launch.specs``).

The reference's stand-ins are ``jax.ShapeDtypeStruct``s; the port's are
tensors on the ``meta`` device: a shape and a type, no storage, so a
full-size model's parameters cost nothing (``Model.init(None)``, which
draws through ``ParamBuilder(generator=None)``, as the reference's
``eval_shape`` of its init).  A sharding is a spec tuple on a stand-in mesh
(``axis_names`` and a ``devices`` array) and ``(mesh, placements)`` on a
``DeviceMesh``, as :mod:`repro_torch.parallel.sharding` gives them.  The
caches are the port's per-layer layout (``models.transformer``); their
specs are the reference's without its groups entry.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.shapes import Shape
from ..models.common import tree_map
from ..models.config import ModelConfig
from ..models.model import Model
from ..optim import adamw
from ..parallel import sharding as shd

META = torch.device("meta")


def struct(shape, dtype) -> torch.Tensor:
    """A shape-only tensor: the port's ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text-token length for a total sequence budget (vlm prefix eats into
    the assigned seq_len)."""
    if cfg.frontend == "vision_stub":
        return max(seq_len - cfg.n_patches, 1)
    return seq_len


def batch_struct(cfg: ModelConfig, shape: Shape, n_micro: int) -> Dict[str, torch.Tensor]:
    gb = shape.global_batch
    t = text_len(cfg, shape.seq_len)
    mb = gb // n_micro
    cdt = getattr(torch, cfg.compute_dtype)
    out = {
        "tokens": struct((n_micro, mb, t), torch.int32),
        "labels": struct((n_micro, mb, t), torch.int32),
    }
    if cfg.frontend == "audio_stub":
        out["embeds"] = struct((n_micro, mb, cfg.enc_frames, cfg.d_model), cdt)
    elif cfg.frontend == "vision_stub":
        out["embeds"] = struct((n_micro, mb, cfg.n_patches, cfg.d_model), cdt)
    return out


def batch_shardings(mesh, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    out = {}
    for k, v in batch.items():
        gb = v.shape[1]
        spec = shd.batch_spec(mesh, gb, extra_dims=v.dim() - 2)
        out[k] = shd.named(mesh, (None, *spec))
    return out


def params_and_axes_struct(model: Model, seed: int = 0):
    """Shape-only params (``meta`` tensors) and the axes tree; nothing is
    drawn, so no allocation happens for full-size configs.  ``seed`` is
    the reference's argument: shapes do not depend on it."""
    del seed
    return model.init(None, with_axes=True)


def opt_struct(params_struct) -> adamw.AdamWState:
    return adamw.init(params_struct)


def shapes_of(tree):
    return tree_map(lambda x: tuple(x.shape), tree)


def serve_structs(model: Model, cfg: ModelConfig, shape: Shape):
    """(tokens, cache, embeds) structs for prefill/decode."""
    b = shape.global_batch
    cdt = getattr(torch, cfg.compute_dtype)
    cache = model.init_cache(b, shape.seq_len, cdt, device=META)
    if shape.kind == "prefill":
        tokens = struct((b, text_len(cfg, shape.seq_len)), torch.int32)
    else:
        tokens = struct((b, 1), torch.int32)
    embeds = None
    if cfg.frontend == "audio_stub":
        embeds = struct((b, cfg.enc_frames, cfg.d_model), cdt)
    elif cfg.frontend == "vision_stub" and shape.kind == "prefill":
        embeds = struct((b, cfg.n_patches, cfg.d_model), cdt)
    return tokens, cache, embeds


def serve_shardings(mesh, cfg: ModelConfig, shape: Shape, cache_struct,
                    rules) -> Tuple[Any, Any, Any]:
    b = shape.global_batch
    tok = shd.named(mesh, shd.batch_spec(mesh, b, extra_dims=1))
    cache = shd.cache_shardings(mesh, cfg, cache_struct, b, rules)
    emb = shd.named(mesh, shd.batch_spec(mesh, b, extra_dims=2))
    return tok, cache, emb
