"""State carried across from the JAX package, as numpy arrays only.

The port cannot reproduce ``jax.random`` draws, and its numpy code
construction is a copy, so these constructors let a test hand the port the
exact objects the reference built: an LT code or a coded-matmul plan from
the reference's tables, helper/packet tables, churn and transport dynamics
and fleet tables the reference drew (in this system they play the part that model weights play
elsewhere), the reference's LM parameter tree (and gradients, which share
its tree) and its AdamW state.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _device
from .core import engine, fountain
from .core.coded_matmul import CodedMatmulPlan

__all__ = ["adamw_state_from_numpy", "dynamics_from_numpy", "encdec_params_from_numpy",
           "fleet_tables_from_numpy", "lm_axes_from_reference", "lm_params_from_numpy",
           "lt_code_from_arrays", "plan_from_arrays", "tables_from_numpy"]


def lt_code_from_arrays(idx, mask, coef, R: int, K: int) -> fountain.LTCode:
    """An :class:`~repro_torch.core.fountain.LTCode` with the given tables,
    in the reference's dtypes (int32 / bool / float32)."""
    return fountain.LTCode(
        idx=np.asarray(idx, dtype=np.int32),
        mask=np.asarray(mask, dtype=bool),
        coef=np.asarray(coef, dtype=np.float32),
        R=int(R), K=int(K),
    )


def plan_from_arrays(idx, mask, coef, R: int, K: int, n_shards: int,
                     placement, bm: int) -> CodedMatmulPlan:
    """A coded-matmul plan equal to the reference plan with these tables."""
    return CodedMatmulPlan(
        code=lt_code_from_arrays(idx, mask, coef, R, K),
        n_shards=int(n_shards),
        placement=np.asarray(placement, dtype=np.int64),
        bm=int(bm),
    )


def tables_from_numpy(mu, a, rate, beta, d_up, d_ack, d_down,
                      device=None, dyn=None) -> engine.Tables:
    """Engine tables from reference draws: helper arrays (B, N) and packet
    tables (B, N, M), cast to float32 on ``device`` (CUDA by default), and
    churn dynamics ``dyn`` through :func:`dynamics_from_numpy` when given.

    The cast matters: a float64 numpy array would stay float64 in torch
    and break parity with the reference, whose tables are float32."""
    dev = _device.resolve(device)

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float32), device=dev)

    tables = engine.Tables(t(mu), t(a), t(rate), t(beta), t(d_up), t(d_ack),
                           t(d_down), None if dyn is None else dynamics_from_numpy(dyn, dev))
    if tables.mu.dim() != 2 or tables.beta.dim() != 3:
        raise ValueError("need helper arrays (B, N) and packet tables (B, N, M); "
                         f"got {tuple(tables.mu.shape)} and {tuple(tables.beta.shape)}")
    return tables


def fleet_tables_from_numpy(mu, a, rate, beta, d_up, d_ack, d_down, release, recruit,
                            prio, device=None, dyn=None) -> engine.FleetTables:
    """Fleet tables from reference draws: helper arrays (B, N), per-task
    packet tables (B, T, N, M), release times (B, T), the recruit mask
    (B, T, N) and priority keys (B, T), float32 (the mask bool) on
    ``device`` (CUDA by default), and the fleet dynamics ``dyn`` (the
    reference's ``draw_dynamics_fleet`` output per rep, whose per-packet
    tables carry the task axis) through :func:`dynamics_from_numpy`."""
    dev = _device.resolve(device)

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float32), device=dev)

    tables = engine.FleetTables(
        t(mu), t(a), t(rate), t(beta), t(d_up), t(d_ack), t(d_down), t(release),
        torch.as_tensor(np.asarray(recruit, dtype=bool), device=dev), t(prio),
        None if dyn is None else dynamics_from_numpy(dyn, dev))
    if tables.mu.dim() != 2 or tables.beta.dim() != 4 or tables.recruit.dim() != 3:
        raise ValueError("need helper arrays (B, N), packet tables (B, T, N, M) and a "
                         f"recruit mask (B, T, N); got {tuple(tables.mu.shape)}, "
                         f"{tuple(tables.beta.shape)} and {tuple(tables.recruit.shape)}")
    return tables


def dynamics_from_numpy(dyn, device=None) -> dict:
    """Churn (and transport) dynamics from reference draws: a dict of
    arrays stacked over reps (a leading B on every table, as
    :func:`repro_torch.core.simulator.draw_dynamics` returns them), or a
    sequence of the reference's per-rep ``draw_dynamics`` (or
    ``draw_dynamics_fleet``) dicts, which are stacked here; the per-rep
    scalar ``ack_p_drop`` becomes (B,).  Booleans stay bool,
    integers become int32 and floats float32, on ``device`` (CUDA by
    default): ``ge_params`` must be float32, or the loss comparisons would
    promote and move losses at the edges."""
    dev = _device.resolve(device)
    if not isinstance(dyn, dict):
        dyn = {k: np.stack([np.asarray(d[k]) for d in dyn]) for k in dyn[0]}

    def t(v):
        v = np.asarray(v)
        dtype = {"b": bool, "i": np.int32, "u": np.int32}.get(v.dtype.kind, np.float32)
        return torch.as_tensor(np.ascontiguousarray(v, dtype=dtype), device=dev)

    return {k: t(v) for k, v in dyn.items()}


def lm_params_from_numpy(cfg, tree, device=None) -> dict:
    """The port's LM parameters from the reference's parameter tree
    (``repro.models.transformer.init_lm``'s values, leaves as numpy arrays;
    for an encoder-decoder ``cfg``, :func:`encdec_params_from_numpy`).

    The reference stacks each pattern position ``b{j}`` over a leading
    ``n_groups`` axis (layer ``g * period + j``); the port keeps one dict per
    layer in ``params["blocks"]``.  Leaves keep their dtype and layout
    (``wq (d, hq, hd)``, ``wo (hq, hd, d)``, MLP ``x @ W``; RG-LRU's
    ``lam (w,)`` and ``conv (cw, w)``, sLSTM's ``r (4, H, dh, dh)``, the
    experts' ``(E, d, f)``) and go to ``device`` (CUDA by default)."""
    if cfg.enc_dec:
        return encdec_params_from_numpy(cfg, tree, device)
    dev = _device.resolve(device)
    period, stacked = cfg.pattern_period, tree["blocks"]
    params = {k: _to_torch(v, dev) for k, v in tree.items() if k != "blocks"}
    params["blocks"] = [_to_torch(stacked[f"b{i % period}"], dev, i // period)
                        for i in range(cfg.n_layers)]
    return params


def lm_axes_from_reference(cfg, axes) -> dict:
    """The port's logical axes tree from the reference's (``init(key)``'s
    second value; leaves plain tuples of names and None): its stacked
    layers, ``blocks/b{j}`` (``encoder``/``decoder`` for an encoder-decoder
    ``cfg``), become one dict a layer, each leaf without its leading
    ``"layers"`` entry, as :func:`lm_params_from_numpy` lays the values
    out."""
    def unstack(node):
        if isinstance(node, dict):
            return {k: unstack(v) for k, v in node.items()}
        node = tuple(node)
        if not node or node[0] != "layers":
            raise ValueError(f"a stacked layer leaf's axes start with 'layers': {node}")
        return node[1:]

    def plain(node):
        return {k: plain(v) for k, v in node.items()} if isinstance(node, dict) else tuple(node)

    if cfg.enc_dec:
        out = {k: plain(v) for k, v in axes.items() if k not in ("encoder", "decoder")}
        out["encoder"] = [unstack(axes["encoder"]) for _ in range(cfg.n_enc_layers)]
        out["decoder"] = [unstack(axes["decoder"]) for _ in range(cfg.n_layers)]
        return out
    out = {k: plain(v) for k, v in axes.items() if k != "blocks"}
    out["blocks"] = [unstack(axes["blocks"][f"b{i % cfg.pattern_period}"])
                     for i in range(cfg.n_layers)]
    return out


def encdec_params_from_numpy(cfg, tree, device=None) -> dict:
    """The port's encoder-decoder parameters from the reference's tree
    (``repro.models.encdec.init_encdec``'s values): its ``encoder`` and
    ``decoder``, stacked over ``n_enc_layers`` and ``n_layers``, become
    lists of per-layer dicts; leaves go to ``device`` (CUDA by default)."""
    dev = _device.resolve(device)
    params = {k: _to_torch(v, dev) for k, v in tree.items()
              if k not in ("encoder", "decoder")}
    params["encoder"] = [_to_torch(tree["encoder"], dev, i) for i in range(cfg.n_enc_layers)]
    params["decoder"] = [_to_torch(tree["decoder"], dev, i) for i in range(cfg.n_layers)]
    return params


def _to_torch(node, dev, layer=None):
    """A copy of a tree of numpy arrays on ``dev`` (entry ``layer`` of each
    leaf's leading axis, if given)."""
    if isinstance(node, dict):
        return {k: _to_torch(v, dev, layer) for k, v in node.items()}
    arr = np.asarray(node)
    return torch.tensor(arr if layer is None else arr[layer], device=dev)


def adamw_state_from_numpy(state, cfg=None, device=None):
    """The port's ``optim.adamw.AdamWState`` from the reference's (``step``,
    ``m``, ``v``; leaves as numpy arrays): the step as an int, the moments
    as float32 tensors on ``device`` (CUDA by default).  With a model
    ``cfg`` the moments are LM trees and take the port's per-layer layout
    (:func:`lm_params_from_numpy`); otherwise their dicts and lists are
    kept as they are."""
    from .models.common import tree_map
    from .optim import adamw

    dev = _device.resolve(device)

    def conv(tree):
        if cfg is not None:
            return lm_params_from_numpy(cfg, tree, dev)
        return tree_map(lambda x: torch.tensor(np.asarray(x, np.float32), device=dev), tree)

    return adamw.AdamWState(step=int(np.asarray(state.step)), m=conv(state.m), v=conv(state.v))
