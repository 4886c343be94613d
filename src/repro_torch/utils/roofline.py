"""Roofline terms of one step on an NVIDIA H100 SXM (port of
``repro.utils.roofline``, whose constants are another chip's).

Peaks, from NVIDIA's H100 SXM5 data sheet (dense, no sparsity):
  989e12 FLOP/s bf16 and 495e12 TF32 on the tensor cores, 67e12 fp32 on
  the CUDA cores; HBM3 3.35e12 B/s; NVLink 4 450e9 B/s a direction.

The port computes fp32 products as three TF32 products on the tensor cores
(3xTF32, which meets fp32's tolerance where one TF32 product does not), so
an fp32 FLOP is held to 495e12 / 3 = 165e12 (``"fp32"``), with the CUDA
cores' 67e12 (``"fp32_cores"``) beside it.  A :class:`Roofline` is held to
one of ``PEAKS``.

Per-op collective wire-cost model (ring algorithms, per device), the
reference's:
  all-reduce         2 * S * (P-1)/P      (S = result bytes = shard bytes)
  all-gather         S * (P-1)/P          (S = result bytes = full bytes)
  reduce-scatter     S * (P-1)            (S = result bytes = full/P)
  all-to-all         S * (P-1)/P
  collective-permute S
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

BF16_FLOPS = 989e12      # tensor cores, dense
TF32_FLOPS = 495e12      # tensor cores, dense
FP32_FLOPS = 67e12       # CUDA cores
FP32_3XTF32_FLOPS = TF32_FLOPS / 3  # an fp32 product as three TF32 products
HBM_BW = 3.35e12         # B/s
NVLINK_BW = 450e9        # B/s a direction

PEAKS = {"bf16": BF16_FLOPS, "tf32": TF32_FLOPS, "fp32": FP32_3XTF32_FLOPS,
         "fp32_cores": FP32_FLOPS}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float              # per device
    hbm_bytes: float          # per device
    wire_bytes: float         # per device
    model_flops: Optional[float] = None  # 6ND-style useful flops (per device)
    peak: str = "fp32"        # which of PEAKS compute_s is held to

    @property
    def peak_flops(self) -> float:
        return PEAKS[self.peak]

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower-bound step time: overlapped terms -> max."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if self.model_flops is None or self.flops == 0:
            return None
        return self.model_flops / self.flops

    @property
    def roofline_fraction(self) -> Optional[float]:
        """MODEL_FLOPS / (bound_s * peak): how close the step is to the
        compute roofline, counting only useful flops."""
        if self.model_flops is None or self.bound_s == 0:
            return None
        return self.model_flops / (self.bound_s * self.peak_flops)

    def to_dict(self) -> Dict:
        return {
            "peak": self.peak,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def wire_bytes(ops: List) -> float:
    """Wire bytes of ``ops`` (``utils.trace.CollectiveOp``s or anything with
    ``kind``, ``bytes`` and ``group_size``)."""
    total = 0.0
    for op in ops:
        p = max(op.group_size, 1)
        if op.kind == "all-reduce":
            total += 2.0 * op.bytes * (p - 1) / p
        elif op.kind == "all-gather":
            total += op.bytes * (p - 1) / p
        elif op.kind == "reduce-scatter":
            total += op.bytes * (p - 1)
        elif op.kind == "all-to-all":
            total += op.bytes * (p - 1) / p
        elif op.kind == "collective-permute":
            total += op.bytes
    return total


def derive(
    cost_analysis: Dict[str, float],
    collectives: List = (),
    model_flops_per_device: Optional[float] = None,
    peak: str = "fp32",
) -> Roofline:
    """The roofline of a step from its counted costs
    (``utils.trace.StepCosts.cost_analysis()``) and its collectives
    (``utils.trace.parse_collectives``), held to ``PEAKS[peak]``."""
    flops = float(cost_analysis.get("flops", 0.0))
    bytes_accessed = float(cost_analysis.get("bytes accessed", 0.0))
    wb = wire_bytes(collectives)
    return Roofline(
        compute_s=flops / PEAKS[peak],
        memory_s=bytes_accessed / HBM_BW,
        collective_s=wb / NVLINK_BW,
        flops=flops,
        hbm_bytes=bytes_accessed,
        wire_bytes=wb,
        model_flops=model_flops_per_device,
        peak=peak,
    )


def model_flops(cfg, shape, n_devices: int) -> float:
    """Useful (6ND-style) FLOPs per device for one step of the given shape.

    train: 6 * N_active * tokens  (fwd 2ND + bwd 4ND)
    prefill: 2 * N_active * tokens
    decode: 2 * N_active * batch  (one token per sequence)
    Attention flops beyond the 6ND convention are excluded (convention).
    """
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n * tokens
    else:  # decode
        total = 2.0 * n * shape.global_batch
    return total / n_devices
