"""Wrapper of the flash-attention CUDA kernel (K4).

The kernel is ``csrc/flash_attention.cu`` (see its header for the design
and what bounds it); it replaces the Pallas TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_pallas``.  This
wrapper checks what the kernel takes, allocates the output, launches on
PyTorch's current stream without synchronising, and counts its launches in
``flash_attention_cuda.launches``.  ``q_offset`` and ``tk_valid`` are launch
arguments: a decode loop calls it with a new offset each step and nothing
is recompiled.  q, k and v may be strided views (the einsum outputs of the
attention block) as long as their last dimension is contiguous.  It takes
CUDA tensors only; the plain versions for the CPU are in ``ref.py``.

Float32 calls with more than 8 query rows a KV head, D <= 128 and 16-byte
rows and strides run on the tensor cores (3xTF32 wgmma, K and V by TMA,
128 rows a CTA); ``ref.attention_3xtf32`` is the plain model of its
arithmetic.  The rest (bfloat16, decode steps, D > 128, unaligned rows, and
every launch whose keys are split) runs on the CUDA cores.  The choice
depends on the call's shape, type and alignment and the card's SM count,
never on the values (:func:`split_plan`).

Where the grid would not fill the card's SMs (a decode step), the keys are
split over more CTAs (:func:`split_plan`), each leaving a partial softmax
that the tile's last CTA combines in the same launch
(``ref.attention_split`` is the plain model).  The partials and the
combine's tickets live in one scratch pair per device, allocated (the
tickets zeroed) when a launch first needs them or needs more, and reused:
every launch leaves the tickets zero, so a call adds no launch and no
allocation of its own.  Launches that share a device's scratch must not
run at the same time on two streams.

Training: given ``lse``, a (B, Hq, Tq) float32 buffer, the forward also
stores each row's log-sum-exp for :func:`flash_attention_bwd_cuda`, the
wrapper of the backward kernel ``csrc/flash_attention_bwd.cu`` (two launches
a call, counted in ``flash_attention_bwd_cuda.launches``; :func:`bwd_plan`
is its instance and tiling).  Float32 calls with D <= 128 and 16-byte rows
and strides run its tensor-core instance (3xTF32 wgmma, tiles by TMA;
``ref.attention_bwd_3xtf32`` is the plain model of its arithmetic), the
rest (bfloat16, D > 128, unaligned rows) its CUDA-core instance.
``autograd.FlashAttentionFn`` joins the forward and the backward.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ...utils import trace
from .. import _nvcc

SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
BWD_LAUNCHES = 2    # launches of one backward call: dQ (and D), then dK and dV
MAX_HEAD_DIM = 256
_INT_MAX = 2**31 - 1
KEY_TILE = 64       # BK of csrc/flash_attention.cu
SPLIT_KEYS = 128    # keys a chunk when the keys are split (two tiles)
MAX_SPLIT = 64      # chunks a query tile at most: longer buffers take longer chunks
NARROW_ROWS = 8     # query rows a KV head up to which the narrow (decode) tile runs
WGMMA_ROWS = 128    # packed rows a CTA of the tensor-core instance
WGMMA_MAX_D = 128   # head dims the tensor-core instance takes

_scratch: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


class SplitPlan(NamedTuple):
    bq: int       # query rows a CTA
    dmax: int     # head dim the instance is compiled for
    tiles: int    # query tiles a (b, KV head)
    n_split: int  # key chunks a query tile (1: no split)
    chunk: int    # keys a chunk
    wgmma: bool = False  # the tensor-core instance (3xTF32 wgmma)

    def ctas(self, B: int, Hkv: int) -> int:
        return self.tiles * self.n_split * Hkv * B

    def working_ctas(self, B: int, Hkv: int, tk_valid: int) -> int:
        """CTAs whose chunk starts below ``tk_valid`` (the others leave an
        empty partial at once)."""
        live = min(self.n_split, math.ceil(tk_valid / self.chunk)) if self.n_split > 1 else 1
        return self.tiles * live * Hkv * B


@functools.lru_cache(maxsize=256)
def split_plan(B: int, Hq: int, Hkv: int, Tq: int, Tk: int, D: int, sms: int,
               tensor_cores: bool = False) -> SplitPlan:
    """The launch's instance and tile (as ``dispatch`` in
    csrc/flash_attention.cu picks them) and key split: where the CUDA-core
    grid (tiles, Hkv, B) has fewer CTAs than the card's ``sms``, the Tk keys
    of the buffer (never ``tk_valid``, so the grid is the same at every
    decode step) go in chunks of ``SPLIT_KEYS``, longer if that would make
    more than ``MAX_SPLIT``.  ``tensor_cores``: the call is float32 with
    16-byte rows and strides; an unsplit launch with more than
    ``NARROW_ROWS`` rows a KV head and D <= ``WGMMA_MAX_D`` then runs the
    tensor-core instance, ``WGMMA_ROWS`` rows a CTA."""
    rows = Hq // Hkv * Tq
    dmax = 64 if D <= 64 else 128 if D <= 128 else 256
    bq = 8 if rows <= NARROW_ROWS else 64 if D <= 128 else 32
    tiles = -(-rows // bq)
    if tiles * Hkv * B >= sms or Tk <= SPLIT_KEYS:
        if tensor_cores and rows > NARROW_ROWS and D <= WGMMA_MAX_D:
            return SplitPlan(WGMMA_ROWS, WGMMA_MAX_D, -(-rows // WGMMA_ROWS), 1, max(Tk, 1), True)
        return SplitPlan(bq, dmax, tiles, 1, max(Tk, 1))
    chunk = max(SPLIT_KEYS, KEY_TILE * -(-Tk // (MAX_SPLIT * KEY_TILE)))
    return SplitPlan(bq, dmax, tiles, -(-Tk // chunk), chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _split_scratch(device: torch.device, n_part: int,
                   n_tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device's split scratch: at least ``n_part`` floats of partials
    and ``n_tickets`` combine tickets, which are zero between launches."""
    part, ticket = _scratch.get(device, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty((n_part,), dtype=torch.float32, device=device)
    if ticket is None or ticket.numel() < n_tickets:
        ticket = torch.zeros((max(n_tickets, 1024),), dtype=torch.int32, device=device)
    _scratch[device] = (part, ticket)
    return part, ticket


def _lib():
    return _nvcc.bind(SOURCE, "flash_attention", 7, 23, 2)


def _bwd_lib():
    _nvcc.bind(BWD_SOURCE, "flash_attention_bwd_dq", 10, 27, 2)
    return _nvcc.bind(BWD_SOURCE, "flash_attention_bwd_dkdv", 10, 27, 2)


def valid_pairs(Tq: int, q_offset: int, tk_valid: int, causal: bool,
                window: Optional[int]) -> int:
    """(query, key) pairs a call attends over: key j < tk_valid, j <= the
    query's position if causal, position - j < window if windowed."""
    hi = [min(q_offset + t + 1, tk_valid) if causal else tk_valid for t in range(Tq)]
    lo = [0 if window is None else max(q_offset + t - window + 1, 0) for t in range(Tq)]
    return sum(max(h - l_, 0) for h, l_ in zip(hi, lo))


def attention_costs(B: int, Hq: int, Hkv: int, Tq: int, D: int, *, q_offset: int,
                    tk_valid: int, causal: bool, window: Optional[int], elem: int,
                    lse: bool = False) -> Tuple[float, int]:
    """(FLOPs, bytes) of one forward call, the counts of its bound: the two
    products over the valid pairs (4 B Hq pairs D); q read and the output
    written once, and the K/V rows some query attends to read once (plus
    the float32 log-sum-exp written, given ``lse``)."""
    flops = 4.0 * B * Hq * valid_pairs(Tq, q_offset, tk_valid, causal, window) * D
    keys = tk_valid - (0 if window is None else max(0, q_offset - window + 1))
    nbytes = 2 * B * Hq * Tq * D * elem + 2 * B * Hkv * keys * D * elem
    return flops, nbytes + (4 * B * Hq * Tq if lse else 0)


def attention_bwd_costs(B: int, Hq: int, Hkv: int, Tq: int, Tk: int, D: int, *,
                        q_offset: int, tk_valid: int, causal: bool, window: Optional[int],
                        elem: int) -> Tuple[float, int]:
    """(FLOPs, bytes) of one backward call, the counts of its bound: five
    products over the valid pairs (S, dP, dV, dQ, dK: 10 B Hq pairs D); q,
    o, dO, k, v and the float32 lse read once, dq, dk, dv written once."""
    flops = 10.0 * B * Hq * valid_pairs(Tq, q_offset, tk_valid, causal, window) * D
    nq, nk = B * Hq * Tq * D, B * Hkv * Tk * D
    return flops, elem * (3 * nq + 2 * nk) + 4 * B * Hq * Tq + elem * (nq + 2 * nk)


def _check_qkv(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The checks the forward and the backward share; returns (B, Hq, Hkv,
    Tq, Tk, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{fn} takes CUDA tensors; {name} is on "
                             f"{t.device} (use the plain versions in ref.py there)")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype not in _nvcc.DTYPE_CODE or t.dtype != q.dtype:
            raise ValueError(f"q, k, v must share one type of {list(_nvcc.DTYPE_CODE)}; "
                             f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, T, D); got {tuple(t.shape)}")
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Tk, D) or v.shape != k.shape:
        raise ValueError(f"need k, v (B, Hkv, Tk, D) = {(B, Hkv, Tk, D)}; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim D={D} outside the kernel's range (1..{MAX_HEAD_DIM})")
    return B, Hq, Hkv, Tq, Tk, D


def _check_options(Tk: int, tk_valid, window, softcap) -> int:
    tk_valid = Tk if tk_valid is None else int(tk_valid)
    if not 0 <= tk_valid <= Tk:
        raise ValueError(f"tk_valid={tk_valid} outside [0, Tk={Tk}]")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap={softcap} must be > 0")
    return tk_valid


def _rows_vec(tensors, D: int) -> tuple:
    """Each tensor with its last dimension contiguous, their (B, H, T)
    element strides, and whether rows load as 4-element vectors (D, the
    strides and the pointers allow it)."""
    tensors = [t if t.stride(-1) == 1 else t.contiguous() for t in tensors]
    strides = [s_ for t in tensors for s_ in t.stride()[:3]]
    align = 4 * tensors[0].element_size()
    vec = D % 4 == 0 and all(s_ % 4 == 0 for s_ in strides) and all(
        t.data_ptr() % align == 0 for t in tensors)
    return tensors, strides, vec


def flash_attention_cuda(
    q: torch.Tensor,  # (B, Hq, Tq, D) float32 or bfloat16
    k: torch.Tensor,  # (B, Hkv, Tk, D), q's type
    v: torch.Tensor,  # (B, Hkv, Tk, D), q's type
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    tk_valid: Optional[int] = None,
    lse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of q over the first ``tk_valid`` keys of k, v (all of them
    by default), q row t at absolute position ``q_offset + t``; a (B, Hq,
    Tq, D) contiguous tensor of q's type.  Semantics of
    ``ref.attention_ref(..., kv_len=tk_valid)``.  ``lse``, a (B, Hq, Tq)
    contiguous float32 tensor on q's device, receives each row's
    log-sum-exp (``ref.attention_lse_ref``; -inf for a row with no valid
    key)."""
    B, Hq, Hkv, Tq, Tk, D = _check_qkv("flash_attention_cuda", q, k, v)
    tk_valid = _check_options(Tk, tk_valid, window, softcap)
    (q, k, v), strides, vec = _rows_vec((q, k, v), D)
    if max(strides + [B, Hq, Tq, Tk, abs(q_offset) + Tq]) > _INT_MAX:
        raise ValueError("a size or stride exceeds the kernel's 32-bit arguments")
    if lse is not None and (lse.shape != (B, Hq, Tq) or lse.dtype != torch.float32
                            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 (B, Hq, Tq) = {(B, Hq, Tq)} "
                         f"tensor on {q.device}; got {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}")
    out = torch.empty((B, Hq, Tq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    plan = split_plan(B, Hq, Hkv, Tq, Tk, D, _sm_count(q.device),
                      vec and q.dtype == torch.float32)
    part = ticket = None
    if plan.n_split > 1:
        n_tiles = plan.tiles * Hkv * B
        part, ticket = _split_scratch(
            q.device, n_tiles * plan.n_split * plan.bq * (2 + plan.dmax), n_tiles)
    _nvcc.launch(_lib(), "flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), part.data_ptr() if part is not None else None,
                 ticket.data_ptr() if ticket is not None else None,
                 lse.data_ptr() if lse is not None else None, B, Hq, Hkv, Tq, Tk, D,
                 *strides, int(q_offset), tk_valid, int(bool(causal)), int(window or 0),
                 int(vec), plan.n_split, plan.chunk, _nvcc.DTYPE_CODE[q.dtype],
                 1.0 / (D ** 0.5),  # the TPU kernel's scale
                 float(softcap or 0.0))
    flash_attention_cuda.launches += 1
    if trace.counting():
        trace.count_kernel("flash_attention", *attention_costs(
            B, Hq, Hkv, Tq, D, q_offset=int(q_offset), tk_valid=tk_valid, causal=bool(causal),
            window=window, elem=q.element_size(), lse=lse is not None))
    return out


flash_attention_cuda.launches = 0


class BwdPlan(NamedTuple):
    dmax: int       # head dim the instances are compiled for
    dq_rows: int    # packed query rows a CTA of the dQ launch
    dq_keys: int    # keys a tile of the dQ launch
    kv_keys: int    # keys a CTA of the dK/dV launch
    kv_rows: int    # query rows a tile of the dK/dV launch
    wgmma: bool = False  # the tensor-core instances (3xTF32 wgmma)

    def ctas(self, B: int, Hq: int, Hkv: int, Tq: int, Tk: int) -> tuple:
        """CTAs of the two launches."""
        rows = Hq // Hkv * Tq
        return (-(-rows // self.dq_rows) * Hkv * B, -(-Tk // self.kv_keys) * Hkv * B)


def bwd_plan(D: int, tensor_cores: bool = False) -> BwdPlan:
    """The backward's instances and tiles (as ``tensor_cores``,
    ``dispatch_dq`` and ``dispatch_dkdv`` in csrc/flash_attention_bwd.cu
    pick them).  ``tensor_cores``: the call is float32 with 16-byte rows
    and strides; with D <= ``WGMMA_MAX_D`` it then runs on the tensor cores
    (3xTF32 wgmma): 128 packed rows a CTA and 32 keys a tile for dQ, 64 keys
    a CTA and 32 query positions (one head) a tile for dK and dV
    (``ref.attention_bwd_3xtf32`` is the plain model).  Otherwise the
    CUDA-core instances: 64 rows and 64 keys up to D = 128, 32 and 32 at D
    = 256.  Depends on the type, the alignment and the head dim only."""
    if tensor_cores and D <= WGMMA_MAX_D:
        return BwdPlan(128, 128, 32, 64, 32, True)  # the .cu's namespace tc
    if D <= 128:
        return BwdPlan(64 if D <= 64 else 128, 64, 64, 64, 64)
    return BwdPlan(256, 32, 32, 32, 32)


def flash_attention_bwd_cuda(
    q: torch.Tensor,    # (B, Hq, Tq, D) float32 or bfloat16
    k: torch.Tensor,    # (B, Hkv, Tk, D), q's type
    v: torch.Tensor,    # (B, Hkv, Tk, D), q's type
    o: torch.Tensor,    # (B, Hq, Tq, D): the forward's output
    do: torch.Tensor,   # (B, Hq, Tq, D): the output's gradient
    lse: torch.Tensor,  # (B, Hq, Tq) float32: the forward's log-sum-exp
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    tk_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_cuda` with
    the same options, contiguous, of q's type: ``ref.attention_bwd_ref`` on
    the card, in two launches (dQ and the rows' D, then dK and dV), each
    counted in ``flash_attention_bwd_cuda.launches``, on the instance
    ``bwd_plan(D, float32 and 16-byte rows)`` names (the kernel picks it by
    the same rule).  Keys at or beyond ``tk_valid`` get zero gradients and
    are never read."""
    B, Hq, Hkv, Tq, Tk, D = _check_qkv("flash_attention_bwd_cuda", q, k, v)
    tk_valid = _check_options(Tk, tk_valid, window, softcap)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be q's shape {tuple(q.shape)}, type and device; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if (lse.shape != (B, Hq, Tq) or lse.dtype != torch.float32 or lse.device != q.device):
        raise ValueError(f"lse must be float32 (B, Hq, Tq) = {(B, Hq, Tq)} on {q.device}; got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    (q, k, v, o, do), strides, vec = _rows_vec((q, k, v, o, do), D)
    lse = lse.contiguous()
    if max(strides + [B, Hq, Tq, Tk, abs(q_offset) + Tq, B * Hq * Tq * D]) > _INT_MAX:
        raise ValueError("a size or stride exceeds the kernel's 32-bit arguments")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((B, Hkv, Tk, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Hq, Hkv, Tq, Tk, D, *strides, int(q_offset), tk_valid, int(bool(causal)),
            int(window or 0), int(vec), _nvcc.DTYPE_CODE[q.dtype], 1.0 / (D ** 0.5),
            float(softcap or 0.0))
    _nvcc.launch(lib, "flash_attention_bwd_dq", q.device, *args)
    flash_attention_bwd_cuda.launches += 1
    _nvcc.launch(lib, "flash_attention_bwd_dkdv", q.device, *args)
    flash_attention_bwd_cuda.launches += 1
    if trace.counting():
        trace.count_kernel("flash_attention_bwd", *attention_bwd_costs(
            B, Hq, Hkv, Tq, Tk, D, q_offset=int(q_offset), tk_valid=tk_valid,
            causal=bool(causal), window=window, elem=q.element_size()))
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
