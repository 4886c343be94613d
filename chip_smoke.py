"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/csrc`` (and shows
from its SASS that K1's float32 product and K4's float32 prefill run on the
tensor cores), holds each against its plain PyTorch version on the card,
times it at the main path's shape beside its bound, drives the main paths
through the port's entry points (one C3P task: the coded-matmul data plane,
the helpers' products on K1 and the collector's peeling recoveries on K3,
and the CCP control plane beside the uncoded and HCMM baselines; the
paper's Figs. 3-5 and its efficiency table at their full sweeps; the
rateless path: the LT payload round trip on
K2 and K3 and the rateless CCP control plane with the decoder in the loop;
churn: the loop's losses and timeouts on the card against the CPU, and the
churn figures fig_churn and fig_decode at their full sweeps; transport and
fleet: the feedback-delay loop and the multi-tenant fleet loop on the card
against the CPU, and fig_transport and fig_fleet at their full sweeps;
LM serving: phi4-mini-3.8b at its full published size through
``ServeEngine.generate``, attention on K4, then CCP dispatch over two
replicas and the card against the CPU; LM training: phi4-mini at full width
and 8 layers through ``launch/train``, every attention's forward on K4 and
its backward on K4's backward kernel, then the card against the CPU and
coded data parallelism, training saved mid-run and resumed through
``launch/train --ckpt/--resume`` (phi4-mini at full width, 2 layers: the
resumed step bitwise the uninterrupted one's), and the roofline of one
training step and one decode step (``utils.trace.StepCosts`` against the
H100's peaks in ``utils.roofline``, beside what cuBLAS and a copy reach on
the card); the other model families: recurrentgemma-2b,
xlstm-350m, whisper-large-v3 and moonshot-v1-16b-a3b (16 of 48 layers)
served at their published widths, K4 at their attention shapes, and each
family's logits and gradients on the card against the CPU; the paths over
several devices and ranks: the coded matmul over a mesh of 8 shards on the
card, one K1 launch a shard, with the collector's recoveries, the sharded
Monte-Carlo engine and fleet bit for bit the unsharded runs, and phi4-mini
(1 layer) trained data parallel and coded data parallel across 4
``torch.distributed`` ranks spawned on the card); the tensor-parallel LM
across 4 ranks of the card: phi4-mini (2 layers) trained on a (data 2,
model 2) mesh with K4 and its backward on each rank's heads and ZeRO-1
AdamW, moonshot-v1-16b-a3b's forward (2 layers) through the
expert-parallel MoE on (1, 4), and elastic shrink-and-restore from (2, 2)
to (1, 2); the dry run's train cells: gemma2-27b on (16, 16) and
qwen3-235b on (2, 16, 16) counted on shape-only tensors through
``launch/dryrun``'s command line, and one production rank of each stepped
on the card and held to those counts), checks the results, and prints one
line per phase.  The line before
the last is a JSON object with every kernel's launches on the main path,
error and times; the last line is ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; so does a machine without a CUDA card,
or a directory without the repository's ``src/``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet), for the bounds:
# HBM3's rate, the CUDA cores' fp32 and the tensor cores' dense TF32.
from repro_torch.utils.roofline import FP32_FLOPS, TF32_FLOPS  # noqa: E402
from repro_torch.utils.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402

# The sweep shapes of tests/test_kernels_coded_matmul.py: (R, K, bm, k, n).
SWEEP = [(4, 2, 8, 16, 16), (6, 3, 16, 64, 32), (8, 4, 8, 128, 128),
         (3, 2, 32, 48, 24), (10, 5, 8, 32, 8)]
# test_lt_encode_sweep's shapes (R, K, bm, cols) and a ragged one.
ENC_SHAPES = [(4, 2, 8, 16), (8, 4, 16, 128), (5, 3, 8, 24), (2, 1, 128, 256), (7, 5, 9, 37)]
# test_lt_decode_kernel_vs_ref_vs_offline's shapes (R, K, bm, cols, lost
# sources) and a ragged one.
DEC_SHAPES = [(12, 10, 4, 24, 3), (20, 24, 8, 16, 6), (8, 8, 16, 40, 2), (24, 30, 5, 77, 6)]
# The rateless data plane: the two "production-ish" payload shapes of the
# reference's kernel benchmark (benchmarks/kernel_bench.py:70-71), (R, K, bm,
# cols, lost sources), float32.
RATELESS = [(64, 64, 256, 4096, 8), (256, 256, 64, 8192, 32)]
RATELESS_LIMIT = 1e-5  # max|decoded - sources| / max|sources|: ±1 pivots, fp32 sums
# The main path's shape (the first "production-ish" shape of the reference's
# kernel benchmark): A 8192x4096, X 4096x4096, 8 shards, 25% overhead.
MAIN = dict(rows=8192, k_dim=4096, n_dim=4096, n_shards=8, overhead=0.25, bm=256)
# K1 at the reference kernel benchmark's second shape
# (benchmarks/kernel_bench.py:35): A 8192x8192 in 64 blocks of 128 rows, 16
# parities, X 8192x1024.
K1_SECOND = dict(R=64, K=16, bm=128, k=8192, n=1024)
# The JAX package's committed figure artifacts (data files, read and printed
# beside the port's rows; nothing of the package is imported).
REF_BENCH = ROOT / "experiments" / "bench"
FIGURES_OUT = ROOT / "build" / "repro_torch" / "figures"
# K4 against its plain version: tests/test_kernels_flash_attention.py's cases,
# a cache buffer read up to tk_valid, a row with no valid key, wide heads.
# (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, q_offset, tk_valid)
FA_CASES = [
    ("mha", 1, 2, 2, 32, 32, 16, True, None, None, 0, None),
    ("gqa", 2, 4, 2, 64, 64, 32, True, None, None, 0, None),
    ("mqa", 1, 8, 1, 64, 64, 32, True, None, None, 0, None),
    ("aligned", 1, 2, 2, 128, 128, 64, True, None, None, 0, None),
    ("tk>tq", 2, 2, 1, 48, 96, 16, True, None, None, 48, None),
    ("window8", 1, 2, 2, 64, 64, 32, True, 8, None, 0, None),
    ("window16", 1, 2, 2, 64, 64, 32, True, 16, None, 0, None),
    ("window64", 1, 2, 2, 64, 64, 32, True, 64, None, 0, None),
    ("softcap10", 1, 2, 1, 32, 32, 16, True, None, 10.0, 0, None),
    ("softcap30", 1, 2, 1, 32, 32, 16, True, None, 30.0, 0, None),
    ("softcap50", 1, 2, 1, 32, 32, 16, True, None, 50.0, 0, None),
    ("noncausal", 2, 2, 2, 32, 48, 16, False, None, None, 0, None),
    ("unaligned", 1, 2, 2, 37, 53, 16, True, None, None, 16, None),
    ("decode256", 4, 8, 2, 1, 256, 32, True, None, None, 255, None),
    ("no-valid-key", 1, 4, 2, 5, 40, 8, True, None, None, 3, 0),
    ("window-decode-buffer", 2, 6, 2, 1, 64, 24, True, 8, None, 40, 41),
    ("head256", 1, 4, 4, 70, 200, 256, True, 32, None, 5, 75),
    # slice C3's attention shapes, smaller: recurrentgemma's MQA at D 256
    # with a window (prefill and a decode step in a buffer), whisper's
    # non-causal 1500 keys (a 28-key tail past the last 64-key tile) and
    # its cross-attention decode, moonshot's MHA
    ("rg-mqa-d256-window", 1, 10, 1, 300, 300, 256, True, 64, None, 0, None),
    ("rg-decode-d256-window", 2, 10, 1, 1, 512, 256, True, 64, None, 400, 401),
    ("whisper-encoder-1500", 2, 4, 4, 1500, 1500, 64, False, None, None, 0, None),
    ("whisper-cross-decode", 4, 20, 20, 1, 1500, 64, False, None, None, 0, None),
    ("moonshot-mha", 1, 16, 16, 200, 256, 128, True, None, None, 0, 200),
]
FA_TOL = {"float32": (2e-5, 1.6e-4), "bfloat16": (2e-2, 1.6e-1)}  # (rtol, atol), the reference's
# K4's backward, |d - ref| <= atol max|ref| + rtol |ref| for each gradient:
# float32 the forward's limit; bfloat16 a limit of its own, since dV = P^T dO
# falls off with the key's position under a causal mask and 0.16 max|ref|
# would pass late keys' gradients written as zeros. Both sides accumulate
# in fp32 and round once to bfloat16 (one ulp is at most 2^-7 |ref|, so
# rtol 2e-2 is 2.5 ulp); the fp32 sums in another order differ by ~1e-6
# of max|ref|, and atol 1e-3 leaves room for the forward's own rounding of
# O into D = sum dO O.
FA_BWD_TOL = {"float32": FA_TOL["float32"], "bfloat16": (2e-2, 1e-3)}
# The serving path: phi4-mini-3.8b at its published size (configs/phi4_mini_3p8b.py),
# 4 request batches of 4 prompts of 1024 tokens, 32 new tokens each.
SERVE = dict(name="serve", arch="phi4-mini-3.8b", n_layers=None, batches=4, batch=4, prompt=1024,
             new=32, max_len=2048, k4=4 * 32 * (1 + 32))
# CCPDispatcher over two replicas of that engine, the second slowed.
DISPATCH = dict(batches=12, prompt=128, new=8, delay_s=0.75)
# K4 at the serving path's shapes: prefill of 1023 tokens into a 2048-slot
# cache, and a decode step at position 1040.
FA_PREFILL = dict(B=4, Hq=24, Hkv=8, Tq=1023, buf=2048, q_offset=0, tk_valid=1023, D=128)
FA_DECODE = dict(B=4, Hq=24, Hkv=8, Tq=1, buf=2048, q_offset=1040, tk_valid=1041, D=128)
# The card against the CPU: phi4-mini's full width at 2 layers, logits
# teacher-forced at each step: fp32 sums over 3072-8192 terms in another order
# (cuBLAS against the CPU's BLAS, K4 against the plain version), two layers
# and the tied head.
CARD_VS_CPU = dict(n_layers=2, B=1, prompt=128, new=4, rtol=1e-4, atol=1e-4)


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def tolerance(dtype, ref) -> float:
    """f32: 1e-5 (the reference suite's kernel tolerance), bf16: 2e-2, both
    scaled by 1 + max|ref|."""
    import torch
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    return rel * (1.0 + float(ref.float().abs().max()))


def nan_equal_err(out, ref) -> tuple:
    """Largest difference over the elements where both are finite, and the
    tolerance (1e-5 f32 / 2e-2 bf16, scaled by 1 + max finite |ref|); inf
    if a NaN, an inf or its sign differs."""
    import torch
    o, r = out.float(), ref.float()
    fin = torch.isfinite(r)
    same = torch.equal(torch.isnan(o), torch.isnan(r)) and torch.equal(
        torch.where(fin | torch.isnan(r), 0.0, r), torch.where(fin | torch.isnan(o), 0.0, o))
    if not (same and torch.equal(torch.isfinite(o), fin)):
        return float("inf"), 0.0
    err = float((o - r)[fin].abs().max()) if bool(fin.any()) else 0.0
    rel = 1e-5 if ref.dtype == torch.float32 else 2e-2
    return err, rel * (1.0 + (float(r[fin].abs().max()) if bool(fin.any()) else 0.0))


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def tensor_core_sass(lib, *kernels: str) -> None:
    """Count the tensor-core instructions (HMMA, HGMMA) that ``cuobjdump
    -sass`` shows in each function of the built library; fail unless each
    of ``kernels`` has some."""
    import os
    import shutil
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    for fn, n in counts.items():
        phase("sass", source=Path(lib).name, function=fn[:96], tensor_core_instructions=n)
    for kernel in kernels:
        if not any(n > 0 for fn, n in counts.items() if kernel in fn):
            raise AssertionError(f"{kernel} has no tensor-core instruction in its SASS")


def check_kernel_against_plain(dev) -> None:
    """K1 against its plain version on the card: the reference suite's
    sweep shapes in f32 and bf16, the ragged k/n shape, and a bool mask
    against the float ±1 weights of one code."""
    import torch
    from repro_torch.core import fountain
    from repro_torch.kernels.coded_matmul import coded_matmul, coded_matmul_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(f"sweep{i}-{str(dt).split('.')[-1]}", R, K, bm, k, n, dt, "mask")
             for i, (R, K, bm, k, n) in enumerate(SWEEP)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [("ragged-k20-n13", 4, 2, 8, 20, 13, torch.float32, "mask"),
              ("weights-pm1", 8, 4, 16, 64, 48, torch.float32, "weights"),
              ("weights-pm1-bf16", 8, 4, 16, 64, 48, torch.bfloat16, "weights")]
    cases += [("k4096-f32", 8, 4, 32, 4096, 300, torch.float32, "weights"),
              ("pm1-systematic-f32", 6, 4, 8, 24, 12, torch.float32, "pm1")]
    for name, R, K, bm, k, n, dt, operand in cases + [
            ("nonfinite-f32", 6, 4, 8, 24, 12, torch.float32, "nonfinite"),
            ("nonfinite-bf16", 6, 4, 8, 24, 12, torch.bfloat16, "nonfinite"),
            ("inf-direct-f32", 6, 4, 8, 24, 12, torch.float32, "inf-direct"),
            ("nan-x-f32", 6, 4, 8, 24, 12, torch.float32, "nan-x")]:
        code = fountain.make_lt_code(R=R, K=K, seed=R * 31 + K)
        a = torch.randn((R * bm, k), generator=gen, device=dev).to(dt)
        x = torch.randn((k, n), generator=gen, device=dev).to(dt)
        idx = torch.as_tensor(code.idx, device=dev)
        weights = code.weights.copy()
        if operand == "pm1":  # a systematic block of weight -1: encoded, not copied
            weights[1, weights[1].nonzero()[0][0]] = -1.0
        mask = torch.as_tensor(code.mask if operand == "mask" else weights, device=dev)
        if operand == "nonfinite":
            # An inf in source block 0, which parity rows reach only through
            # padding slots (index 0, weight 0): 0 * inf makes those rows NaN.
            a[3, 5] = torch.inf
        if operand == "inf-direct":  # a row a systematic block reads straight from A
            a[bm + 2, 7] = torch.inf
        if operand == "nan-x":
            x[11, 2] = torch.nan
        out = coded_matmul(a, x, idx, mask, bm=bm)
        ref = coded_matmul_ref(a, x, idx, mask, bm)
        torch.cuda.synchronize()
        err, tol = nan_equal_err(out, ref)
        phase("k1-vs-plain", case=name, shape=f"R{R}K{K}bm{bm}k{k}n{n}",
              max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}",
              nan_rows=int(torch.isnan(ref).any(dim=1).sum()))
        if not (out.shape == ref.shape and err <= tol):
            raise AssertionError(f"K1 disagrees with its plain version on {name}")
        if operand in ("nonfinite", "inf-direct", "nan-x") and bool(torch.isfinite(ref).all()):
            raise AssertionError(f"the {operand} case made no inf or NaN in the plain version")
        if operand == "weights":
            # The ±1 weights must not collapse to the 0/1 mask: parity rows
            # differ between the two operands.
            as_mask = coded_matmul(a, x, idx, torch.as_tensor(code.mask, device=dev),
                                   bm=bm)
            if torch.equal(as_mask[R * bm:], out[R * bm:]):
                raise AssertionError("K1 dropped the parity signs")


def kernel_at_main_shape(dev) -> dict:
    """K1, its plain version and the library product at the main path's
    shape: error, device times and the bound of the same work."""
    import torch
    from repro_torch.core import coded_matmul as cm
    from repro_torch.kernels.coded_matmul import coded_matmul_cuda, coded_matmul_ref
    from repro_torch.kernels.coded_matmul.kernel import coded_matmul_costs
    from repro_torch.kernels.coded_matmul.ref import lt_encode_ref

    plan = cm.plan_coded_matmul(rows=MAIN["rows"], n_shards=MAIN["n_shards"],
                                overhead=MAIN["overhead"], bm=MAIN["bm"])
    gen = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn((MAIN["rows"], MAIN["k_dim"]), generator=gen, device=dev)
    x = torch.randn((MAIN["k_dim"], MAIN["n_dim"]), generator=gen, device=dev)
    idx, w = cm.device_blocks(plan, a)
    bm, (C, _d), (k, n) = plan.bm, idx.shape, x.shape
    out = coded_matmul_cuda(a, x, idx, w, bm)
    ref = coded_matmul_ref(a, x, idx, w, bm)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = tolerance(torch.float32, ref)
    if not (out.shape == (C * bm, n) and bool(torch.isfinite(out).all()) and err <= tol):
        raise AssertionError(f"K1 at the main shape: max|err| {err:.3e} > {tol:.3e}")
    del ref
    a_enc = lt_encode_ref(a, idx, w, bm)
    k1_precision(out, a_enc, x)
    ms = time_ms(lambda: coded_matmul_cuda(a, x, idx, w, bm), 10)
    plain_ms = time_ms(lambda: coded_matmul_ref(a, x, idx, w, bm), 5)
    lib_ms = time_ms(lambda: torch.matmul(a_enc, x), 10)
    # K1's launch by kernel on the device's clock: the prologue (the encode
    # once and the split of X^T), the tensor-core product, and under
    # "other" the non-finite marks (memset, name_padding, mark_rows).
    steps = kernel_device_ms(lambda: coded_matmul_cuda(a, x, idx, w, bm), 5, dict(
        prologue_ms="coded_matmul_encode_kernel|coded_matmul_split_xt_kernel",
        product_ms="coded_matmul_wgmma_kernel"))
    # Bounds: each input read once and the output written once, against
    # the operations as the kernel does them, three TF32 products on the
    # tensor cores (the encode's FMAs run beside them on the CUDA cores);
    # and, for comparison, the product plus this plan's nonzero-weight
    # encode FMAs in fp32 on the CUDA cores.
    nnz = int((w != 0).sum())
    products, nbytes = coded_matmul_costs(a.shape[0] // bm, bm, k, n, C, _d, a.element_size())
    ops = products + 2.0 * nnz * bm * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 3 * products / TF32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_fp32 = max(t_bytes, ops / FP32_FLOPS * 1e3)
    phase("k1-main-shape", A=f"{MAIN['rows']}x{k}", X=f"{k}x{n}", C=C, bm=bm,
          max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}", k1_ms=f"{ms:.4f}",
          prologue_ms=f"{steps['prologue_ms']:.4f}", product_ms=f"{steps['product_ms']:.4f}",
          marks_ms=f"{steps['other']:.4f}", plain_ms=f"{plain_ms:.4f}",
          torch_matmul_ms=f"{lib_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
          bound_by="bytes" if t_bytes >= t_ops else "operations",
          bound_fp32_cores_ms=f"{bound_fp32:.4f}", bytes=nbytes, ops=f"{ops:.4e}",
          k1_tflops=f"{ops / ms / 1e9:.2f}", share_of_bound=f"{bound_ms / ms:.3f}")
    # Where K1's time goes: systematic blocks (one neighbour, a plain GEMM)
    # against parity blocks (d neighbours to encode per tile).
    degree = (w != 0).sum(dim=1)
    for kind, sel in (("systematic", degree == 1), ("parity", degree > 1)):
        idx_s, w_s = idx[sel].contiguous(), w[sel].contiguous()
        ms_s = time_ms(lambda: coded_matmul_cuda(a, x, idx_s, w_s, bm), 10)
        phase("k1-split", blocks=kind, C=idx_s.shape[0], ms=f"{ms_s:.4f}",
              share_of_products=f"{idx_s.shape[0] / C:.3f}", share_of_time=f"{ms_s / ms:.3f}",
              product_tflops=f"{2.0 * idx_s.shape[0] * bm * k * n / ms_s / 1e9:.2f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_fp32_cores_ms=bound_fp32,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_device_ms(call, reps: int, groups: dict) -> dict:
    """Device time of the kernels one ``call`` launches, by torch.profiler
    over ``reps`` calls after a warm-up, ms a call: for each name of
    ``groups``, the kernels whose name holds one of its "|"-separated
    substrings, and under
    "other" the rest.  Unlike CUDA events around back-to-back calls, this
    does not count the device's idle time while the host enqueues.

    The profiler can drop some of a window's kernel records (torch 2.11
    on an H100: 2 of 20 before the churn phases, 11 of 20 after their
    millions of small launches; each record kept is whole), so a kernel's
    time a call is the mean of its records times its launches a call, the
    smallest whole number that covers the records seen; the dropped
    records are printed.  A window that kept no record of some group (late
    in the script it can keep 1 of 20) is profiled again, up to 5 times."""
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        seen_keys = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if all(any(sub in k for k in seen_keys for sub in subs.split("|"))
               for subs in groups.values()):
            break
        phase("profiler", kernels=",".join(groups.values()), window=attempt + 1,
              kept="none of a group: profiling again")
    out = dict.fromkeys([*groups, "other"], 0.0)
    seen = expected = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.device_type != DeviceType.CUDA or not us:
            continue
        key = next((g for g, subs in groups.items()
                    if any(sub in e.key for sub in subs.split("|"))), "other")
        per_call = math.ceil(e.count / reps)
        out[key] += us / e.count * per_call / 1e3
        seen, expected = seen + e.count, expected + per_call * reps
    for g in groups:
        if not out[g] > 0:
            raise AssertionError(f"the profiler saw no {groups[g]} kernel")
    if seen < expected:
        phase("profiler", kernels=",".join(groups.values()), records=seen, expected=expected,
              dropped=expected - seen)
    return out


def k1_precision(out, a_enc, x) -> None:
    """Why K1 runs 3xTF32: its error at the main shape against an fp64
    product, beside cuBLAS's fp32 product and one TF32 product (cuBLAS with
    TF32 allowed for this call only), each as a share of the fp32 tolerance
    1e-5 x (1 + max|ref|).  Fails unless K1 keeps the tolerance."""
    import torch
    exact = a_enc.double() @ x.double()
    tol = 1e-5 * (1.0 + float(exact.abs().max()))
    errs = {"k1": float((out.double() - exact).abs().max()),
            "fp32_matmul": float(((a_enc @ x).double() - exact).abs().max())}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        errs["tf32_matmul"] = float(((a_enc @ x).double() - exact).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    phase("k1-precision", tol=f"{tol:.3e}",
          **{f"{name}_err": f"{e:.3e}" for name, e in errs.items()},
          **{f"{name}_share_of_tol": f"{e / tol:.3f}" for name, e in errs.items()})
    if not errs["k1"] <= tol:
        raise AssertionError(f"K1 misses the fp32 tolerance against fp64: {errs['k1']:.3e}")


def peeling_losses() -> int:
    """How many of quickstart.coded_offload's survivor sets at MAIN (all
    shards, then each single shard lost) peel at least one step: K3's
    launches on the collector's path."""
    import numpy as np
    from repro_torch.core import coded_matmul as cm
    from repro_torch.core import fountain

    plan = cm.plan_coded_matmul(rows=MAIN["rows"], n_shards=MAIN["n_shards"],
                                overhead=MAIN["overhead"], bm=MAIN["bm"])
    n = 0
    for lost in [None] + list(range(MAIN["n_shards"])):
        ids = np.concatenate([plan.placement[s] for s in range(MAIN["n_shards"]) if s != lost])
        fplan = fountain.peel_decode_plan(plan.code, ids)
        n += fplan is not None and fplan.n_peeled > 0
    return n


def collector_times(dev) -> None:
    """The collector's recovery at MAIN for each survivor set of
    quickstart.coded_offload: ``recover``'s time on the card (peel on K3),
    the plain route on the same tensors (``apply_decode_plan``, the CPU
    route's peel), and the ``torch.cat`` of the survivors' blocks that both
    begin with; host clock, each call synchronised, mean of 3 after a
    warm-up.  The survivor sets that peel only: the dense solve is one route
    on both devices, and the data plane has run it.  The two routes must
    agree within the data plane's limit."""
    import numpy as np
    import torch
    from repro_torch.core import coded_matmul as cm
    from repro_torch.core import fountain
    from repro_torch.kernels.lt_decode import lt_decode_plan_cuda

    plan = cm.plan_coded_matmul(rows=MAIN["rows"], n_shards=MAIN["n_shards"],
                                overhead=MAIN["overhead"], bm=MAIN["bm"])
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((MAIN["rows"], MAIN["k_dim"]), generator=gen, device=dev)
    x = torch.randn((MAIN["k_dim"], MAIN["n_dim"]), generator=gen, device=dev)
    out = cm.run(plan, a, x)
    y_ref = a @ x
    scale = float(y_ref.abs().max())
    del a, x
    Bp, bm, R = plan.blocks_per_shard, plan.bm, plan.code.R

    def blocks(survivors):
        return torch.cat([out[s * Bp * bm:(s + 1) * Bp * bm].reshape(Bp, bm, -1)
                          for s in survivors], dim=0)

    def plain_recover(survivors):
        ids = np.concatenate([plan.placement[s] for s in survivors])
        fplan = fountain.peel_decode_plan(plan.code, ids)
        return fountain.apply_decode_plan(blocks(survivors), fplan).reshape(R * bm, -1)

    def host_ms(fn, reps=3):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.mean(times))

    n = MAIN["n_shards"]
    for lost in [None] + list(range(n)):
        survivors = np.array([s for s in range(n) if s != lost])
        ids = np.concatenate([plan.placement[s] for s in survivors])
        fplan = fountain.peel_decode_plan(plan.code, ids)
        if fplan is None:
            continue
        before = lt_decode_plan_cuda.launches
        y = cm.recover(plan, out, survivors)
        torch.cuda.synchronize()
        launches = lt_decode_plan_cuda.launches - before
        rel = float((y - y_ref).abs().max()) / scale
        t_cat = host_ms(lambda: blocks(survivors))
        diff = float((y - plain_recover(survivors)).abs().max()) / scale
        t_k3 = host_ms(lambda: cm.recover(plan, out, survivors))
        t_plain = host_ms(lambda: plain_recover(survivors))
        phase("data-plane-recover", lost="none" if lost is None else lost, method="peel",
              peeled=fplan.n_peeled, rounds=len(fountain.plan_rounds(fplan)),
              k3_launches=launches, recover_k3_ms=f"{t_k3:.4f}",
              recover_plain_ms=f"{t_plain:.4f}", cat_ms=f"{t_cat:.4f}",
              cat_mb=f"{2 * len(ids) * bm * out.shape[1] * 4 / 1e6:.1f}",
              routes_rel_diff=f"{diff:.3e}", rel_err=f"{rel:.3e}")
        if not (diff <= 1e-4 and rel <= 1e-4):
            raise AssertionError(f"recover with shard {lost} lost: routes differ by {diff:.3e}, "
                                 f"error {rel:.3e}")
        if launches != int(fplan.n_peeled > 0):
            raise AssertionError(f"recover launched K3 {launches} times with shard {lost} lost")
        del y
    del out, y_ref
    torch.cuda.empty_cache()


def k1_second_shape(dev) -> None:
    """K1 at the reference kernel benchmark's second shape: against its plain
    version at the fp32 tolerance, its device time by events beside the
    library product of the encoded blocks and the plain version, and its
    3xTF32 tensor-core bound."""
    import torch
    from repro_torch.core import fountain
    from repro_torch.kernels.coded_matmul import coded_matmul_cuda, coded_matmul_ref
    from repro_torch.kernels.coded_matmul.kernel import coded_matmul_costs
    from repro_torch.kernels.coded_matmul.ref import lt_encode_ref

    R, K, bm, k, n = (K1_SECOND[key] for key in ("R", "K", "bm", "k", "n"))
    code = fountain.make_lt_code(R, K, seed=0)
    gen = torch.Generator(device=dev).manual_seed(2)
    a = torch.randn((R * bm, k), generator=gen, device=dev)
    x = torch.randn((k, n), generator=gen, device=dev)
    idx = torch.as_tensor(code.idx, device=dev)
    w = torch.as_tensor(code.weights, device=dev)
    C = idx.shape[0]
    out = coded_matmul_cuda(a, x, idx, w, bm)
    ref = coded_matmul_ref(a, x, idx, w, bm)
    torch.cuda.synchronize()
    err, tol = float((out - ref).abs().max()), tolerance(torch.float32, ref)
    if not (out.shape == (C * bm, n) and bool(torch.isfinite(out).all()) and err <= tol):
        raise AssertionError(f"K1 at the second shape: max|err| {err:.3e} > {tol:.3e}")
    del ref
    a_enc = lt_encode_ref(a, idx, w, bm)
    ms = time_ms(lambda: coded_matmul_cuda(a, x, idx, w, bm), 10)
    plain_ms = time_ms(lambda: coded_matmul_ref(a, x, idx, w, bm), 5)
    lib_ms = time_ms(lambda: torch.matmul(a_enc, x), 10)
    products, nbytes = coded_matmul_costs(R, bm, k, n, C, idx.shape[1], a.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * products / TF32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    phase("k1-second-shape", A=f"{R * bm}x{k}", X=f"{k}x{n}", R=R, K=K, C=C, bm=bm,
          max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}", k1_ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", torch_matmul_ms=f"{lib_ms:.4f}",
          bound_ms=f"{bound_ms:.4f}", bound_by="bytes" if t_bytes >= t_ops else "operations",
          bytes_ms=f"{t_bytes:.4f}", share_of_bound=f"{bound_ms / ms:.3f}")
    del out, a_enc
    torch.cuda.empty_cache()


def baselines_control_plane(dev) -> None:
    """The quickstart's CCP against Best, Uncoded (both rules) and HCMM at
    FIG3[1], R=2000, 200 reps on one seed, held to tests/test_system.py's
    anchors: every rep certified, CCP ahead of every baseline and within
    1.25x of eq. (27).  T is in simulated seconds."""
    from repro_torch import quickstart

    res = quickstart.ccp_vs_baselines(device=dev, R=2000, reps=200)
    phase("baselines-control-plane", cfg="FIG3[1]", R=2000, reps=200,
          **{f"T_{p}": f"{res[f'T_{p}']:.6f}" for p in quickstart.POLICIES},
          T_opt=f"{res['T_opt']:.6f}", vs_hcmm=f"{res['vs_hcmm']:.4f}",
          vs_uncoded=f"{res['vs_uncoded']:.4f}", efficiency=f"{res['efficiency']:.6f}",
          M=res["M"], valid=res["valid"], wall_s=f"{res['wall_s']:.3f}")
    if not all(res["valid"].values()):
        raise AssertionError(f"uncertified reps: {res['valid']}")
    for p in ("uncoded_mean", "uncoded_mu", "hcmm"):
        if not res["T_ccp"] < res[f"T_{p}"]:
            raise AssertionError(f"T_ccp {res['T_ccp']} >= T_{p} {res[f'T_{p}']}")
    if not res["T_ccp"] <= 1.25 * res["T_opt"]:
        raise AssertionError(f"T_ccp {res['T_ccp']} > 1.25 T_opt {res['T_opt']}")


def _reference_rows(name: str) -> list:
    """The rows of the reference's artifact ``name`` (none for Fig. 4: the
    reference never committed one)."""
    path = REF_BENCH / f"{name}.json"
    return json.loads(path.read_text())["data"] if path.exists() else []


def _invalid(row: dict, policies) -> int:
    return sum(row[p]["invalid"] for p in policies)


def figures_on_card(dev) -> None:
    """Figs. 3, 4 and 5 and the efficiency table at their full default
    sweeps on the card, one line per row (the reference artifact's means
    beside Fig. 3's, Fig. 5's and the table's) and one per figure with its
    wall time.  Asserts the orderings that the reference's own artifacts and
    the paper show.  T is in simulated seconds; wall_s is the host's clock."""
    from repro_torch.figures import efficiency, fig3, fig4, fig5

    blocks = ("uncoded_mean", "uncoded_mu", "hcmm")
    for name, mod in (("fig3", fig3), ("fig4", fig4)):
        out = mod.run(device=dev, out_dir=FIGURES_OUT)
        ref = {(r["scenario"], r["R"]): r for r in _reference_rows(name)}
        for row in out["rows"]:
            r = ref.get((row["scenario"], row["R"]), {})
            cols = {p: f"{row[p]['mean']:.4f}" for p in mod.POLICIES}
            if "optimum" in row:
                cols["optimum"] = f"{row['optimum']['mean']:.4f}"
            cols.update({f"ref_{p}": f"{r[p]['mean']:.4f}" for p in cols if p in r})
            phase(name, scenario=row["scenario"], R=row["R"], reps=40,
                  invalid=_invalid(row, mod.POLICIES), **cols)
            if _invalid(row, mod.POLICIES):
                raise AssertionError(f"{name}: uncertified reps at {row['scenario']}/{row['R']}")
            for p in blocks:
                if not row["ccp"]["mean"] < row[p]["mean"]:
                    raise AssertionError(f"{name} sc{row['scenario']} R={row['R']}: "
                                         f"CCP not below {p}")
            if row["scenario"] == 2 and not row["hcmm"]["mean"] < min(
                    row["uncoded_mean"]["mean"], row["uncoded_mu"]["mean"]):
                raise AssertionError(f"{name} sc2 R={row['R']}: HCMM not below uncoded")
        phase(name, summary=",".join(f"{k}={v:.4f}" for k, v in out["summary"].items()),
              wall_s=f"{out['wall_s']:.3f}",
              out=(FIGURES_OUT / f"{name}.json").relative_to(ROOT))

    out = fig5.run(device=dev, out_dir=FIGURES_OUT)
    ref = {r["R"]: r for r in _reference_rows("fig5")}
    for row in out["rows"]:
        r = ref.get(row["R"], {})
        phase("fig5", R=row["R"], reps=30, invalid=_invalid(row, fig5.POLICIES),
              **{p: f"{row[p]['mean']:.4f}" for p in fig5.POLICIES},
              gap_naive=f"{row['gap_naive']:.4f}", gap_best=f"{row['gap_best']:.4f}",
              **{f"ref_{k}": f"{r[k]['mean'] if isinstance(r[k], dict) else r[k]:.4f}"
                 for k in (*fig5.POLICIES, "gap_naive", "gap_best") if k in r})
        if _invalid(row, fig5.POLICIES):
            raise AssertionError(f"fig5: uncertified reps at R={row['R']}")
    gaps = [row["gap_naive"] for row in out["rows"]]
    phase("fig5", naive_gap_growth=f"{out['naive_gap_growth']:.4f}",
          best_gap_growth=f"{out['best_gap_growth']:.4f}", wall_s=f"{out['wall_s']:.3f}",
          out=(FIGURES_OUT / "fig5.json").relative_to(ROOT))
    if not all(g1 > g0 for g0, g1 in zip(gaps, gaps[1:])):
        raise AssertionError(f"fig5: the naive gap does not grow with R: {gaps}")

    out = efficiency.run(device=dev, out_dir=FIGURES_OUT)
    ref = {r["scenario"]: r for r in _reference_rows("efficiency")}
    for row in out["rows"]:
        r = ref.get(row["scenario"], {})
        phase("efficiency", scenario=row["scenario"], R=8000, reps=20, invalid=row["invalid"],
              measured=f"{row['measured']:.6f}", theory_eq12=f"{row['theory_eq12']:.6f}",
              **{f"ref_{k}": f"{r[k]:.6f}" for k in ("measured", "theory_eq12") if k in r})
        if row["invalid"] or not (row["measured"] >= row["theory_eq12"]
                                  and row["measured"] > 0.99):
            raise AssertionError(f"efficiency sc{row['scenario']}: {row}")
    phase("efficiency", wall_s=f"{out['wall_s']:.3f}",
          out=(FIGURES_OUT / "efficiency.json").relative_to(ROOT))


def engine_cpu_vs_card(dev) -> None:
    """The engine on the card against the same engine on the CPU, from one
    set of tables (N=20, R=400, M=256): completion times and efficiencies
    agree to float32 rounding; the block policies' loads bit for bit."""
    import torch
    from repro_torch.core import engine, simulator

    cfg = simulator.ScenarioConfig(N=20, scenario=1)
    tables = engine.draw_tables(torch.Generator().manual_seed(3), cfg, 4, 400, 256)
    on_card = tables.to(dev)
    policies = ("ccp", "best", "naive", "rateless_ccp", "uncoded_mean", "uncoded_mu", "hcmm")
    for policy in policies:
        cpu = engine.simulate(tables, cfg, 400, policy)
        gpu = engine.simulate(on_card, cfg, 400, policy)
        if "x_loads" in cpu and not torch.equal(gpu["x_loads"].cpu(), cpu["x_loads"]):
            raise AssertionError(f"{policy}: the loads differ between card and CPU")
        torch.testing.assert_close(gpu["T"].cpu(), cpu["T"], rtol=1e-6, atol=0)
        torch.testing.assert_close(gpu["efficiency"].cpu(), cpu["efficiency"],
                                   rtol=1e-6, atol=1e-7, equal_nan=True)
        for k in ("r_n", "valid"):
            if not torch.equal(gpu[k].cpu(), cpu[k]):
                raise AssertionError(f"{policy}: {k} differs between card and CPU")
    # The symbol ids the rateless loop hands out, on the card and on the CPU.
    pol = engine._as_policy("rateless_ccp")
    c = cfg.ccp_cfg(400)
    ids = [engine.policy_stream(t.beta, t.d_up, t.d_ack, t.d_down, policy=pol,
                                cfg_static=(c.Bx, c.Br, c.Back, c.alpha),
                                aux=pol.prepare(cfg, 400, c, t.mu, t.a, t.rate))[0]["sym_id"]
           for t in (tables, on_card)]
    if not torch.equal(ids[1].cpu(), ids[0]):
        raise AssertionError("rateless_ccp: sym_id differs between card and CPU")
    phase("engine-card-vs-cpu", policies=",".join(policies), reps=4, N=20, R=400, M=256,
          sym_id="equal", loads="equal", agree="yes")


def _block0_loss(code, R: int, K: int):
    """A loss set with block 0 lost and recovered in a round r that also
    recovers other entries naming block 0 in padding slots, before a round
    with such entries: (lost, r)."""
    import numpy as np
    from repro_torch.core import fountain

    for n in range(2, R // 2 + 1):
        for seed in range(50):
            lost = np.unique(np.r_[0, np.random.default_rng(n + seed).choice(R, n, replace=False)])
            plan = fountain.peel_decode_plan(code, np.setdiff1d(np.arange(R + K), lost))
            if plan is None:
                continue
            rounds = fountain.plan_rounds(plan)
            r0 = next(i for i, r in enumerate(rounds) if 0 in r.src)
            if (rounds[r0].size > 1 and (rounds[r0].nbr_coef == 0).any()
                    and any((r.nbr_coef == 0).any() for r in rounds[r0 + 1:])):
                return lost, r0
    raise AssertionError(f"no block-0 loss pattern at R{R}K{K}")


def _scan_block0_loss(code, R: int, K: int):
    """A loss set with block 0 recovered at step t0 of the plan and a later
    step of the same round naming block 0 in a padding slot, where the
    plan's order (fountain.decode's scan) and its rounds differ."""
    import numpy as np
    from repro_torch.core import fountain

    for n in range(2, R // 2 + 1):
        for seed in range(50):
            lost = np.unique(np.r_[0, np.random.default_rng(n + seed).choice(R, n, replace=False)])
            plan = fountain.peel_decode_plan(code, np.setdiff1d(np.arange(R + K), lost))
            if plan is None:
                continue
            t0 = list(plan.order_src).index(0)
            step = fountain.plan_step_rounds(plan)
            pads0 = ((plan.order_nbr_coef == 0) & (plan.order_nbr_idx == 0)).any(axis=1)
            if (pads0[t0 + 1:] & (step[t0 + 1:] == step[t0])).any():
                return lost, plan
    raise AssertionError(f"no same-round block-0 loss pattern at R{R}K{K}")


def check_lt_kernels_against_plain(dev) -> None:
    """K2 and K3 against their plain versions on the card: the reference
    suite's shapes in f32 and bf16, a ragged shape, ±1 weights against the
    0/1 mask, and an inf and a NaN in source block 0 (which padding slots
    name), compared NaN-equal.  K3 also with block 0 lost and recovered
    non-finite in a round (that round's other entries stay finite, later
    rounds' padding slots give NaN) and with the coded buffer one element
    past a 16-byte boundary; one launch per plan.  Then fountain.decode's
    peel (K3 on the steps in plan order) against apply_decode_plan, the
    reference's scan, with block 0 recovered inf before a step of its own
    round that names it in a padding slot (NaN there in plan order)."""
    import numpy as np
    import torch
    from repro_torch.core import decode, fountain
    from repro_torch.kernels.coded_matmul.ref import lt_encode_ref
    from repro_torch.kernels.lt_decode import lt_decode, lt_decode_plan_cuda, lt_decode_ref
    from repro_torch.kernels.lt_encode import lt_encode

    gen = torch.Generator(device=dev).manual_seed(2)
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[-1]
        for R, K, bm, cols in ENC_SHAPES:
            code = fountain.make_lt_code(R=R, K=K, seed=R * 17 + K)
            a = torch.randn((R * bm, cols), generator=gen, device=dev).to(dt)
            idx = torch.as_tensor(code.idx, device=dev)
            for operand in ("mask", "weights", "nonfinite"):
                m = torch.as_tensor(code.mask if operand == "mask" else code.weights, device=dev)
                x = a.clone()
                if operand == "nonfinite":
                    x[3, 1], x[bm - 1, 0] = torch.inf, torch.nan
                out, ref = lt_encode(x, idx, m, bm=bm), lt_encode_ref(x, idx, m, bm)
                torch.cuda.synchronize()
                err, tol = nan_equal_err(out, ref)
                phase("k2-check", case=f"{operand}-{tag}", shape=f"R{R}K{K}bm{bm}c{cols}",
                      max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}")
                if not (out.shape == ref.shape and err <= tol):
                    raise AssertionError(f"K2 disagrees with its plain version: {operand} "
                                         f"{tag} R{R}K{K}bm{bm}c{cols}")
                if operand == "weights" and (code.weights < 0).any() and torch.equal(
                        out[R * bm:], lt_encode(x, idx, torch.as_tensor(code.mask, device=dev),
                                                bm=bm)[R * bm:]):
                    raise AssertionError("K2 dropped the parity signs")
        for R, K, bm, cols, n_lost in DEC_SHAPES:
            code = decode.make_decoder_code(R, K, seed=R + K, d_max=8)
            x = torch.randn((R * bm, cols), generator=gen, device=dev).to(dt)
            coded = lt_encode_ref(x, torch.as_tensor(code.idx, device=dev),
                                  torch.as_tensor(code.weights, device=dev), bm)
            lost = np.random.default_rng(n_lost).choice(R, size=n_lost, replace=False)
            lost0, r0 = _block0_loss(code, R, K)
            for case, gone in (("loss", lost), ("nonfinite", lost[lost != 0]),
                               ("block0-recovered-inf", lost0), ("unaligned", lost)):
                keep = np.setdiff1d(np.arange(R + K), gone)
                plan = fountain.peel_decode_plan(code, keep)
                if plan is None:
                    raise AssertionError(f"the check plan stalls at R{R}K{K}")
                rounds = fountain.plan_rounds(plan)
                crx = coded.reshape(R + K, bm, cols)[torch.as_tensor(keep, device=dev)]
                crx = crx.reshape(-1, cols).contiguous()
                if case == "nonfinite":  # rows of source 0, which padding slots name
                    crx[min(2, bm - 1), 1], crx[0, 0] = torch.inf, torch.nan
                if case == "block0-recovered-inf":  # the coded block that recovers block 0
                    cpos = int(rounds[r0].coded[list(rounds[r0].src).index(0)])
                    crx[cpos * bm + bm - 1, cols - 1] = torch.inf
                if case == "unaligned":
                    buf = torch.empty(crx.numel() + 1, dtype=dt, device=dev)
                    buf[1:] = crx.reshape(-1)
                    crx = buf[1:].view(-1, cols)
                before = lt_decode_plan_cuda.launches
                out, ref = lt_decode(crx, plan, bm=bm), lt_decode_ref(crx, plan, bm=bm)
                torch.cuda.synchronize()
                launches = lt_decode_plan_cuda.launches - before
                err, tol = nan_equal_err(out, ref)
                phase("k3-check", case=f"{case}-{tag}",
                      shape=f"R{R}K{K}bm{bm}c{cols}lost{len(gone)}", rounds=len(rounds),
                      launches=launches, max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}",
                      nan=int(torch.isnan(ref).sum()))
                if not (out.shape == ref.shape and err <= tol):
                    raise AssertionError(f"K3 disagrees with its plain version: {case} "
                                         f"{tag} R{R}K{K}bm{bm}c{cols}")
                if launches != (1 if rounds else 0):
                    raise AssertionError(f"K3 launched {launches} times for one plan")
                if case == "block0-recovered-inf":
                    at = ref.view(R, bm, cols)[:, bm - 1, cols - 1]
                    if not (all(bool(torch.isfinite(at[int(s)])) for s in rounds[r0].src if s)
                            and any(bool(torch.isnan(at[int(s)]))
                                    for r in rounds[r0 + 1:] for s in r.src)):
                        raise AssertionError("the block-0 case did not give round r0 finite "
                                             "entries and NaN after it in the plain version")
    for R, K, bm, cols, _n in DEC_SHAPES:
        code = decode.make_decoder_code(R, K, seed=R + K, d_max=8)
        x = torch.randn((R * bm, cols), generator=gen, device=dev)
        coded = lt_encode_ref(x, torch.as_tensor(code.idx, device=dev),
                              torch.as_tensor(code.weights, device=dev), bm)
        lost, plan = _scan_block0_loss(code, R, K)
        keep = np.setdiff1d(np.arange(R + K), lost)
        rx = coded.reshape(R + K, bm, cols)[torch.as_tensor(keep, device=dev)].contiguous()
        rx[int(plan.order_coded[list(plan.order_src).index(0)]), bm - 1, cols - 1] = torch.inf
        before = lt_decode_plan_cuda.launches
        out, method = fountain.decode(rx, code, keep)
        ref = fountain.apply_decode_plan(rx, plan)
        torch.cuda.synchronize()
        launches = lt_decode_plan_cuda.launches - before
        rounds_nan = torch.isnan(lt_decode_ref(rx.view(-1, cols), plan, bm=bm))
        err, tol = nan_equal_err(out, ref)
        phase("k3-check", case="scan-block0-recovered-inf-float32",
              shape=f"R{R}K{K}bm{bm}c{cols}lost{len(lost)}", steps=plan.n_peeled,
              launches=launches, max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}",
              nan=int(torch.isnan(ref).sum()), nan_by_rounds=int(rounds_nan.sum()))
        if not (method == "peel" and out.shape == ref.shape and err <= tol):
            raise AssertionError(f"fountain.decode on K3 disagrees with apply_decode_plan: "
                                 f"R{R}K{K}bm{bm}c{cols}")
        if launches != 1:
            raise AssertionError(f"fountain.decode launched K3 {launches} times for one plan")
        if torch.equal(rounds_nan.view(ref.shape), torch.isnan(ref)):
            raise AssertionError("the scan case does not tell plan order from the rounds")


def rateless_data_plane(dev) -> dict:
    """The LT payload round trip at the reference benchmark's two
    production-ish shapes, through the entry points a user calls: encode
    the sources with the decoder's pool code (K2, ``lt_encode_code``), drop
    the sources of kernel_bench's loss draw, peel the received set back
    (K3, ``lt_decode_code``, one launch for the plan).  Then each kernel, its
    plain version and its library yardstick are timed on the same inputs,
    beside the bound of the same work.  Returns the per-kernel numbers
    summed over the two shapes, with K2's and K3's launches on the path."""
    import dataclasses as dc

    import numpy as np
    import torch
    from repro_torch.core import decode, fountain
    from repro_torch.kernels.coded_matmul.ref import lt_encode_ref
    from repro_torch.kernels.lt_decode import (lt_decode, lt_decode_code, lt_decode_plan_cuda,
                                               lt_decode_ref, peel_round_ref, plan_program)
    from repro_torch.kernels.lt_decode.schedule import program_costs
    from repro_torch.kernels.lt_encode import lt_encode_code, lt_encode_cuda
    from repro_torch.kernels.lt_encode.kernel import lt_encode_costs

    gen = torch.Generator(device=dev).manual_seed(4)
    runs = []
    for R, K, bm, cols, n_lost in RATELESS:
        code = decode.make_decoder_code(R, K)
        a = torch.randn((R * bm, cols), generator=gen, device=dev)
        lost = np.random.default_rng(R).choice(R, size=n_lost, replace=False)
        keep = np.setdiff1d(np.arange(R + K), lost)
        # The main path, counted.
        lt_encode_cuda.launches = lt_decode_plan_cuda.launches = 0
        coded = lt_encode_code(a, code)
        crx = coded.view(R + K, bm, cols)[torch.as_tensor(keep, device=dev)].view(-1, cols)
        plan = fountain.peel_decode_plan(code, keep)
        if plan is None:
            phase("rateless-data-plane", R=R, K=K, peel="stalled", fallback="fountain.decode")
            dec, method = fountain.decode(crx.view(len(keep), bm, cols), code, keep)
            dec = dec.reshape(R * bm, cols)
        else:
            dec, method = lt_decode_code(crx, code, keep), "peel"
        torch.cuda.synchronize()
        launches = dict(lt_encode=lt_encode_cuda.launches,
                        lt_decode=lt_decode_plan_cuda.launches)
        rel = float((dec - a).abs().max()) / float(a.abs().max())
        rounds = fountain.plan_rounds(plan) if plan is not None else []
        phase("rateless-data-plane", R=R, K=K, bm=bm, cols=cols, lost=n_lost, method=method,
              rounds=len(rounds), round_sizes=",".join(str(r.size) for r in rounds),
              peeled=plan.n_peeled if plan is not None else 0,
              k2_launches=launches["lt_encode"], k3_launches=launches["lt_decode"],
              rel_err=f"{rel:.3e}", limit=f"{RATELESS_LIMIT:.0e}")
        if not (dec.shape == a.shape and rel <= RATELESS_LIMIT):
            raise AssertionError(f"rateless round trip R{R}: rel. error {rel:.3e}")
        if launches["lt_encode"] != 1 or launches["lt_decode"] != (1 if rounds else 0):
            raise AssertionError(f"rateless path launches {launches} for one plan")
        blk = bm * cols * a.element_size()

        # K2 alone against its plain version at this shape (every parity
        # block, also those the round trip never reads), then its time, the
        # plain version's and one library product's.
        idx = torch.as_tensor(code.idx, device=dev)
        w = torch.as_tensor(code.weights, device=dev)
        k2_ref = lt_encode_ref(a, idx, w, bm)
        k2_err = float((lt_encode_cuda(a, idx, w, bm) - k2_ref).abs().max())
        k2_tol = tolerance(torch.float32, k2_ref)
        del k2_ref
        if not k2_err <= k2_tol:
            raise AssertionError(f"K2 at R{R}: max|err| {k2_err:.3e} > {k2_tol:.3e}")
        k2_ms = time_ms(lambda: lt_encode_cuda(a, idx, w, bm), 10)
        k2_plain = time_ms(lambda: lt_encode_ref(a, idx, w, bm), 2)
        # What the card's memory gives a plain copy of A (read and write), and
        # the rate of K2's own traffic through L2: every neighbour tile read
        # and the output written.
        dst = torch.empty_like(a)
        copy_tbps = 2 * a.numel() * 4 / time_ms(lambda: dst.copy_(a), 10) / 1e9
        del dst
        torch.cuda.empty_cache()
        G = torch.as_tensor(code.dense_generator(), device=dev)  # (C, R)
        a2 = a.view(R, bm * cols)
        k2_lib = time_ms(lambda: torch.mm(G, a2), 10)
        nnz = int((w != 0).sum())
        k2_ops, k2_bytes = lt_encode_costs(R, bm, cols, idx.shape[0], idx.shape[1], nnz,
                                           a.element_size())
        k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / FP32_FLOPS) * 1e3
        k2 = dict(ms=k2_ms, plain_ms=k2_plain, library_ms=k2_lib, bound_ms=k2_bound,
                  max_abs_err=k2_err, bound_by="bytes"
                  if k2_bytes / HBM_BYTES_PER_S >= k2_ops / FP32_FLOPS else "operations")
        phase("k2-rateless-shape", R=R, C=R + K, bm=bm, cols=cols, nnz=nnz,
              k2_ms=f"{k2_ms:.4f}", bound_ms=f"{k2_bound:.4f}",
              share_of_bound=f"{k2_bound / k2_ms:.3f}", plain_ms=f"{k2_plain:.4f}",
              torch_mm_ms=f"{k2_lib:.4f}", bytes=k2_bytes, max_abs_err=f"{k2_err:.3e}",
              tol=f"{k2_tol:.3e}", hbm_tbps=f"{k2_bytes / k2_ms / 1e9:.3f}",
              gather_tbps=f"{(nnz * blk + coded.numel() * 4) / k2_ms / 1e9:.3f}",
              copy_tbps=f"{copy_tbps:.3f}")
        del coded, G
        torch.cuda.empty_cache()

        # K3: the plan's one launch alone, its program built once outside the
        # timed loop, against the plain decode of the received rows (the
        # round trip's output too); rerunning it rewrites the same blocks.
        # Then by the profiler, with the L2 as the previous launch left it (it
        # must see that kernel alone: no marks pass) and cold,
        # an empty plan's launch (every entry skipped: what a launch costs
        # besides its work), one whole lt_decode call on the host's clock
        # (schedule, copies, direct fills and the launch, synchronised), the
        # plain rounds, and the library form of each round (addmm + mul_).
        k3 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                  bound_by="bytes")
        if rounds:
            plain = lt_decode_ref(crx, plan, bm=bm)  # from the received rows alone
            src = plain.clone()  # its direct fills; the blocks the plan recovers NaN
            src.view(R, bm, cols)[torch.as_tensor(plan.order_src, device=dev).long()] = torch.nan
            coded3 = crx.view(len(keep), bm, cols)
            words = plan_program(plan, len(keep))
            prog = torch.as_tensor(words, device=dev)
            empty = torch.as_tensor(plan_program(dc.replace(
                plan, order_coded=np.full_like(plan.order_coded, -1)), len(keep)), device=dev)

            def k3_plan():
                lt_decode_plan_cuda(crx, src, prog, bm)

            k3_plan()
            k3_err = max(float((src - plain).abs().max()), float((dec - plain).abs().max()))
            k3_tol = tolerance(torch.float32, plain)
            if not k3_err <= k3_tol:
                raise AssertionError(f"K3 at R{R}: max|err| {k3_err:.3e} > {k3_tol:.3e}")

            def plain_rounds():
                s3 = plain.view(R, bm, cols)
                for rnd in rounds:
                    s3[torch.as_tensor(rnd.src, device=dev).long()] = peel_round_ref(
                        s3, coded3, rnd, bm=bm)

            dense = []
            for rnd in rounds:
                W = torch.zeros((rnd.size, R), device=dev)
                W.scatter_add_(1, torch.as_tensor(rnd.nbr_idx, device=dev).long(),
                               torch.as_tensor(rnd.nbr_coef, device=dev))  # padding adds 0
                dense.append((coded3[torch.as_tensor(rnd.coded, device=dev).long()].reshape(
                    rnd.size, -1), W, torch.as_tensor(1.0 / rnd.pivot, device=dev)[:, None]))
            s2 = src.view(R, bm * cols)

            def library_rounds():
                for c_sel, W, ip in dense:
                    torch.addmm(c_sel, W, s2, alpha=-1).mul_(ip)

            k3_ms = time_ms(k3_plan, 20)
            steps = kernel_device_ms(k3_plan, 20, dict(k3="lt_decode_plan_kernel"))
            if steps["other"] > 0:
                raise AssertionError("K3's plan launch ran kernels besides its own")
            # The same after each launch finds the L2 cold: 100 MB (2x the L2)
            # written elsewhere in between, as the inputs' first read would.
            flush = torch.empty(25 * 2 ** 20, device=dev)
            cold = kernel_device_ms(lambda: (flush.zero_(), k3_plan()), 10,
                                    dict(k3="lt_decode_plan_kernel"))
            del flush
            k3_empty = time_ms(lambda: lt_decode_plan_cuda(crx, src, empty, bm), 20)
            host = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lt_decode(crx, plan, bm=bm)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            k3_plain = time_ms(plain_rounds, 3)
            k3_lib = time_ms(library_rounds, 20)
            n_nbr = sum(int((rnd.nbr_coef != 0).sum()) for rnd in rounds)
            # The old per-round count: every distinct block a round reads, each
            # entry written, and each entry's tables.
            read = {("c", int(c)) for rnd in rounds for c in rnd.coded}
            read |= {("s", int(s)) for rnd in rounds
                     for s in rnd.nbr_idx[rnd.nbr_coef != 0]}
            round_bytes = (len(read) + plan.n_peeled) * blk + (
                12 + 8 * plan.order_nbr_idx.shape[1]) * plan.n_peeled
            # The plan count (schedule.program_costs): the inputs read once
            # and each recovered block written once, plus the program.
            k3_ops, k3_bytes = program_costs(words, bm * cols, a.element_size())
            k3_bound = max(k3_bytes / HBM_BYTES_PER_S, k3_ops / FP32_FLOPS) * 1e3
            round_bound = max(round_bytes / HBM_BYTES_PER_S, k3_ops / FP32_FLOPS) * 1e3
            k3 = dict(ms=k3_ms, plain_ms=k3_plain, library_ms=k3_lib, bound_ms=k3_bound,
                      round_bound_ms=round_bound, max_abs_err=k3_err, bound_by="bytes"
                      if k3_bytes / HBM_BYTES_PER_S >= k3_ops / FP32_FLOPS else "operations")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            ctas = -(-bm * cols // (4 * 256))
            phase("k3-rateless-shape", R=R, n_rx=len(keep), bm=bm, cols=cols,
                  rounds=len(rounds), peeled=plan.n_peeled, nbr_reads=n_nbr,
                  program_words=words.size, ctas=ctas, ctas_per_sm=f"{ctas / sms:.2f}",
                  k3_ms=f"{k3_ms:.4f}", k3_device_ms=f"{steps['k3']:.4f}",
                  k3_cold_device_ms=f"{cold['k3']:.4f}",
                  empty_plan_ms=f"{k3_empty:.4f}",
                  lt_decode_host_ms=f"{np.mean(host):.4f}",
                  lt_decode_host_min_ms=f"{min(host):.4f}",
                  bound_ms=f"{k3_bound:.4f}", share_of_bound=f"{k3_bound / k3_ms:.3f}",
                  round_bound_ms=f"{round_bound:.4f}", bytes=k3_bytes, round_bytes=round_bytes,
                  hbm_tbps=f"{k3_bytes / k3_ms / 1e9:.3f}", plain_ms=f"{k3_plain:.4f}",
                  addmm_mul_ms=f"{k3_lib:.4f}", max_abs_err=f"{k3_err:.3e}",
                  tol=f"{k3_tol:.3e}")
            del src, plain, dense, prog, empty
        runs.append(dict(launches=launches, lt_encode=k2, lt_decode=k3))
        del a, crx, dec
        torch.cuda.empty_cache()
    out = {}
    for name in ("lt_encode", "lt_decode"):
        tot = {k: sum(r[name].get(k, 0.0) for r in runs)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms", "round_bound_ms")}
        if name == "lt_encode":
            tot.pop("round_bound_ms")
        tot["max_abs_err"] = max(r[name]["max_abs_err"] for r in runs)
        tot["bound_by"] = runs[0][name]["bound_by"]
        tot["launches"] = sum(r["launches"][name] for r in runs)
        out[name] = tot
    return out


def rateless_control_plane(dev) -> None:
    """Rateless CCP against CCP at FIG3[1] through the quickstart (R=2000,
    200 reps), every rep certified by real decode success; the pacing equal
    to CCP's bit for bit on the same tables on the card; naive on the same
    seed; and rateless CCP on the card against the CPU."""
    import torch
    from repro_torch import quickstart
    from repro_torch.configs.ccp_paper import FIG3
    from repro_torch.core import engine
    from repro_torch.core.decode import peeling

    peeling.host_syncs = 0
    t0 = time.perf_counter()
    res = quickstart.rateless_vs_ccp(device=dev, R=2000, reps=200)
    torch.cuda.synchronize()
    phase("rateless-control-plane", cfg="FIG3[1]", R=2000, reps=200,
          T_rateless=f"{res['T_rateless']:.6f}", T_ccp=f"{res['T_ccp']:.6f}",
          certified=res["certified"], overhead_mean=f"{res['overhead_mean']:.3f}",
          overhead_max=f"{res['overhead_max']:.0f}", M=res["M"],
          wall_s=f"{time.perf_counter() - t0:.3f}", host_syncs=peeling.host_syncs)
    if not (res["certified"] and res["valid"]):
        raise AssertionError("uncertified rateless reps (dec_done / dec_count == R)")
    if not res["overhead_mean"] >= 0:
        raise AssertionError("negative measured LT overhead")

    cfg, R = FIG3[1], 2000
    t0 = time.perf_counter()
    naive = engine.Engine(device=dev).run(cfg, "naive", 200, R, seed=0)
    phase("naive-control-plane", cfg="FIG3[1]", R=R, reps=200,
          T_naive=f"{float(naive.T.mean()):.6f}", all_valid=bool(naive.valid.all()),
          M=naive.M, wall_s=f"{time.perf_counter() - t0:.3f}")
    if not bool(naive.valid.all()):
        raise AssertionError("uncertified naive reps")

    # Rateless pacing is Algorithm 1 bit for bit: its traces equal CCP's.
    tables = engine.draw_tables(torch.Generator(device=dev).manual_seed(0), cfg, 16, R, 256)
    c = cfg.ccp_cfg(R)
    outs = {}
    for name in ("ccp", "rateless_ccp"):
        pol = engine._as_policy(name)
        aux = pol.prepare(cfg, R, c, tables.mu, tables.a, tables.rate)
        outs[name], _ = engine.policy_stream(
            tables.beta, tables.d_up, tables.d_ack, tables.d_down, policy=pol,
            cfg_static=(c.Bx, c.Br, c.Back, c.alpha), aux=aux)
    for k in ("tx", "tr", "arrive", "idle"):
        if not torch.equal(outs["ccp"][k], outs["rateless_ccp"][k]):
            raise AssertionError(f"rateless_ccp's {k} trace differs from ccp's")
    phase("rateless-pacing-equals-ccp", cfg="FIG3[1]", reps=16, R=R, M=256,
          traces="tx,tr,arrive,idle", equal="yes")


CHURN_POLICIES = ("ccp", "best", "naive", "naive_oracle", "uncoded_mean", "uncoded_mu",
                  "hcmm", "rateless_ccp", "adaptive_rate", "adaptive_rate_fb")
# The card against the CPU under churn: the churn golden's config
# (tests/test_policies.py: N=16, lognormal outages, slowdowns, i.i.d. drop,
# Gilbert–Elliott and cell outages) at the golden's largest horizon.
CHURN_CARD_VS_CPU = dict(N=16, R=200, M=840, reps=4)
# An ordering of two policies' means in a reference artifact's row is
# asserted on the port's row only where the reference separates them by
# more than this share of the larger mean (other draws move each mean by a
# few standard errors, about 1-3%).
ORDER_MARGIN = 0.05


def _kernel_launches() -> dict:
    from repro_torch.kernels.coded_matmul import kernel as k1
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.lt_decode import kernel as k3
    from repro_torch.kernels.lt_encode import kernel as k2

    return {"coded_matmul": k1.coded_matmul_cuda.launches,
            "lt_encode": k2.lt_encode_cuda.launches,
            "lt_decode": k3.lt_decode_plan_cuda.launches + k3.lt_decode_round_cuda.launches,
            "flash_attention": k4.flash_attention_cuda.launches}


def _no_kernel_between(before: dict, label: str) -> None:
    """The churn, transport and fleet paths are the control plane: no
    kernel of the port runs."""
    delta = {k: v - before[k] for k, v in _kernel_launches().items()}
    if any(delta.values()):
        raise AssertionError(f"{label} launched kernels: {delta}")


def _golden_churn_cfg(N: int):
    from repro_torch.core import simulator

    return simulator.ScenarioConfig(N=N, scenario=1, churn=simulator.ChurnConfig(
        period=5.0, p_down=0.1, p_slow=0.2, drop_prob=0.05, ge_p_bad=0.02, ge_p_good=0.2,
        ge_loss_bad=0.5, p_cell=0.1, cell_frac=0.5, outage_dist="lognormal",
        outage_mean=4.0, outage_sigma=0.5, max_backoff=8.0))


def churn_card_vs_cpu(dev) -> None:
    """The churn loop on the card against the CPU on one set of tables:
    every ported policy's lost, tx and tr traces, T, r_n, valid,
    max_backoff and lost_frac bit for bit; efficiency at rtol 1e-6."""
    import torch
    from repro_torch.core import engine

    c = CHURN_CARD_VS_CPU
    cfg, R = _golden_churn_cfg(c["N"]), c["R"]
    tables = engine.draw_tables(torch.Generator().manual_seed(1), cfg, c["reps"], R, c["M"])
    on_card = tables.to(dev)
    cc = cfg.ccp_cfg(R)
    before = _kernel_launches()
    t0 = time.perf_counter()
    lost = {}
    for policy in CHURN_POLICIES:
        pol = engine._as_policy(policy)
        traces = [engine.policy_stream(
            t.beta, t.d_up, t.d_ack, t.d_down, policy=pol,
            cfg_static=(cc.Bx, cc.Br, cc.Back, cc.alpha), churn_static=cfg.churn.static_key(),
            dyn=t.dyn, a=t.a, aux=pol.prepare(cfg, R, cc, t.mu, t.a, t.rate))[0]
            for t in (tables, on_card)]
        for k in ("lost", "tx", "tr", "tx_end"):
            if not torch.equal(traces[1][k].cpu(), traces[0][k]):
                raise AssertionError(f"churn {policy}: the {k} trace differs between card and CPU")
        cpu = engine.simulate(tables, cfg, R, policy)
        gpu = engine.simulate(on_card, cfg, R, policy)
        for k in ("T", "r_n", "valid", "max_backoff", "lost_frac"):
            if not torch.equal(gpu[k].cpu(), cpu[k]):
                raise AssertionError(f"churn {policy}: {k} differs between card and CPU")
        torch.testing.assert_close(gpu["efficiency"].cpu(), cpu["efficiency"],
                                   rtol=1e-6, atol=1e-7, equal_nan=True)
        lost[policy] = int(traces[0]["lost"].sum())
    _no_kernel_between(before, "churn-card-vs-cpu")
    phase("churn-card-vs-cpu", cfg="golden churn", N=c["N"], R=R, M=c["M"], reps=c["reps"],
          policies=",".join(CHURN_POLICIES), lost=",".join(str(v) for v in lost.values()),
          equal="lost,tx,tr,tx_end,T,r_n,valid,max_backoff,lost_frac",
          wall_s=f"{time.perf_counter() - t0:.3f}")
    if not all(lost.values()):
        raise AssertionError(f"a policy lost no packet under churn: {lost}")


def _check_orderings(name: str, row: dict, ref: dict, policies, where: str,
                     stat: str = "mean") -> int:
    """Assert on the port's row every ordering of two policies' ``stat``
    (the mean, or fig_fleet's p50 and p99) that the reference artifact's
    row shows with a margin; returns the count."""
    n = 0
    for p in policies:
        for q in policies:
            if p in ref and q in ref and ref[p][stat] < (1 - ORDER_MARGIN) * ref[q][stat]:
                n += 1
                if not row[p][stat] < row[q][stat]:
                    raise AssertionError(
                        f"{name} {where}: the reference has {p}'s {stat} below {q}'s "
                        f"({ref[p][stat]:.3f} < {ref[q][stat]:.3f}), the port "
                        f"{row[p][stat]:.3f} >= {row[q][stat]:.3f}")
    return n


def churn_figures_on_card(dev) -> None:
    """fig_churn (N=50, R=1000, 40 reps, its three sweeps and five
    policies) and fig_decode (N=20, R=400, 40 reps, drop 0-0.3) at the
    reference figure scripts' full defaults on the card, one line a row with the
    invalid count and the reference artifact's means beside the port's;
    asserts the orderings the artifact shows (ORDER_MARGIN).  T is in
    simulated seconds; wall_s is the host's clock."""
    from repro_torch.figures import fig_churn, fig_decode

    before = _kernel_launches()
    out = fig_churn.run(device=dev, out_dir=FIGURES_OUT)
    axes = {"iid": "drop_prob", "burst": "ge_p_bad", "cell": "p_cell"}
    ref = {(r["sweep"], r[axes[r["sweep"]]]): r for r in _reference_rows("fig_churn")}
    checked = 0
    for row in out["rows"]:
        x = row[axes[row["sweep"]]]
        r = ref[(row["sweep"], x)]
        phase("fig_churn", sweep=row["sweep"], **{axes[row["sweep"]]: x}, reps=40,
              invalid=_invalid(row, fig_churn.POLICIES),
              M=",".join(str(row[p]["M"]) for p in fig_churn.POLICIES),
              **{p: f"{row[p]['mean']:.4f}" for p in fig_churn.POLICIES},
              **{f"ref_{p}": f"{r[p]['mean']:.4f}" for p in fig_churn.POLICIES},
              ref_invalid=_invalid(r, fig_churn.POLICIES))
        checked += _check_orderings("fig_churn", row, r, fig_churn.POLICIES,
                                    f"{row['sweep']}={x}")
    phase("fig_churn", orderings_checked=checked, wall_s=f"{out['wall_s']:.3f}",
          sweep_wall_s=",".join(f"{k}={v:.3f}" for k, v in out["sweep_wall_s"].items()),
          summary=",".join(f"{k}={v:.4f}" for k, v in out["summary"].items()),
          out=(FIGURES_OUT / "fig_churn.json").relative_to(ROOT))

    out = fig_decode.run(device=dev, out_dir=FIGURES_OUT)
    ref = {r["drop_prob"]: r for r in _reference_rows("fig_decode")}
    checked = 0
    for row in out["rows"]:
        r = ref[row["drop_prob"]]
        phase("fig_decode", drop_prob=row["drop_prob"], reps=40,
              invalid=",".join(str(row[p]["invalid"]) for p in fig_decode.POLICIES),
              M=",".join(str(row[p]["M"]) for p in fig_decode.POLICIES),
              **{p: f"{row[p]['mean']:.4f}" for p in fig_decode.POLICIES},
              overhead_frac=f"{row['rateless_ccp']['overhead']['frac_mean']:.4f}",
              counter_gap=f"{row['counter_gap']:.4f}", feedback_gain=f"{row['feedback_gain']:.4f}",
              **{f"ref_{p}": f"{r[p]['mean']:.4f}" for p in fig_decode.POLICIES},
              ref_invalid=",".join(str(r[p]["invalid"]) for p in fig_decode.POLICIES),
              ref_overhead_frac=f"{r['rateless_ccp']['overhead']['frac_mean']:.4f}",
              ref_counter_gap=f"{r['counter_gap']:.4f}",
              ref_feedback_gain=f"{r['feedback_gain']:.4f}")
        checked += _check_orderings("fig_decode", row, r, fig_decode.POLICIES,
                                    f"p={row['drop_prob']}")
    _no_kernel_between(before, "the churn figures")
    phase("fig_decode", orderings_checked=checked, wall_s=f"{out['wall_s']:.3f}",
          summary=",".join(f"{k}={v:.4f}" for k, v in out["summary"].items()),
          out=(FIGURES_OUT / "fig_decode.json").relative_to(ROOT))


def churn_control_plane(dev) -> None:
    """One ``Engine.run`` a ported policy at fig_churn's burst endpoint
    (N=50, R=1000, 40 reps, GE p_bad 0.06): wall time, the horizon M it
    certified at, certified reps, and the decoder's host syncs (the
    decoder policies' only device-to-host copies inside the loop)."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.decode import peeling
    from repro_torch.figures import fig_churn

    cfg = fig_churn.burst_cfg(fig_churn.BURST_SWEEP[-1])
    eng = engine.Engine(device=dev)
    before = _kernel_launches()
    for policy in CHURN_POLICIES:
        peeling.host_syncs = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(cfg, policy, 40, fig_churn.R, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok = res.valid & torch.isfinite(res.T)
        t_mean = float(res.T[ok].mean()) if bool(ok.any()) else float("inf")
        phase("churn-control-plane", cfg="fig_churn burst p_bad=0.06", N=cfg.N, R=fig_churn.R,
              reps=40, policy=policy, M=res.M, certified=int(res.valid.sum()),
              T_mean=f"{t_mean:.4f}", lost_frac=f"{float(res.lost_frac.mean()):.4f}",
              wall_s=f"{wall:.3f}", host_syncs=peeling.host_syncs)
    _no_kernel_between(before, "churn-control-plane")


# The transport line on the card against the CPU: tests/test_transport.py's
# churn mix (outages, slowdowns, drop, Gilbert–Elliott, cell outages) under
# log-normal feedback RTT, at R=60 and the churn cap 4(R+K).
TRANSPORT_CARD_VS_CPU = dict(N=16, R=60, M=252, reps=4, rtt_mean=2.0)
# The fleet loop on the card against the CPU: 3 tenants on 12 helpers, 6
# recruits each (striped, overlapping), under the same churn and transport.
FLEET_CARD_VS_CPU = dict(N=12, R=60, M=128, reps=4, n_tasks=3, helpers_per_task=6,
                         policies=("ccp", "tfrc_ccp", "rateless_ccp", "hcmm"))


def _transport_churn(rtt_mean: float):
    from repro_torch.core import simulator

    return simulator.ChurnConfig(
        period=5.0, p_down=0.1, p_slow=0.2, drop_prob=0.05, ge_p_bad=0.03, ge_p_good=0.25,
        ge_loss_bad=0.5, p_cell=0.05, cell_frac=0.5, max_backoff=8.0,
        rtt_dist="lognormal", rtt_mean=rtt_mean)


def _equal_or_raise(label: str, gpu: dict, cpu: dict, exact, close=()) -> None:
    import torch

    for k in exact:
        g, c = gpu[k].cpu(), cpu[k]
        same = (g == c) | (g.isnan() & c.isnan()) if c.is_floating_point() else g == c
        if g.shape != c.shape or g.dtype != c.dtype or not bool(same.all()):
            raise AssertionError(f"{label}: {k} differs between card and CPU "
                                 f"({int((~same).sum())} entries)")
    for k in close:
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], rtol=1e-6, atol=1e-7, equal_nan=True)


def transport_card_vs_cpu(dev) -> None:
    """The transport loop on the card against the CPU on one set of tables:
    every registered policy's traces (lost, tx, tr, idle, backoff, tx_end,
    sym_id) and the results extracted from them (T, r_n, valid,
    max_backoff, lost_frac) bit for bit, efficiency at rtol 1e-6 (its sums
    run in another order on each device)."""
    import torch
    from repro_torch.core import engine, policies, simulator

    c = TRANSPORT_CARD_VS_CPU
    cfg = simulator.ScenarioConfig(N=c["N"], scenario=1, churn=_transport_churn(c["rtt_mean"]))
    R = c["R"]
    tables = engine.draw_tables(torch.Generator().manual_seed(2), cfg, c["reps"], R, c["M"])
    on_card = tables.to(dev)
    cc = cfg.ccp_cfg(R)
    before = _kernel_launches()
    t0 = time.perf_counter()
    names = policies.names()
    lost, p_ev = {}, 0.0
    for name in names:
        pol = engine._as_policy(name)
        got = []
        for t in (tables, on_card):
            aux = pol.prepare(cfg, R, cc, t.mu, t.a, t.rate)
            outs, psum = engine.policy_stream(
                t.beta, t.d_up, t.d_ack, t.d_down, policy=pol,
                cfg_static=(cc.Bx, cc.Br, cc.Back, cc.alpha),
                churn_static=cfg.churn.static_key(), dyn=t.dyn, a=t.a, aux=aux)
            stats = engine._task_stats(outs, aux, cfg, R, pol, outs["tx_end"])
            got.append(dict(outs, **stats, **{f"x_{k}": v for k, v in psum.items()}))
        _equal_or_raise(f"transport {name}", got[1], got[0],
                        [k for k in got[0] if k != "efficiency"], close=("efficiency",))
        lost[name] = int(got[0]["lost"].sum())
        if name == "tfrc_ccp":
            p_ev = float(got[0]["x_p_ev"].max())
    _no_kernel_between(before, "transport-card-vs-cpu")
    phase("transport-card-vs-cpu", cfg="test_transport CHURN + lognormal RTT", N=c["N"], R=R,
          M=c["M"], reps=c["reps"], rtt_mean=c["rtt_mean"], policies=",".join(names),
          lost=",".join(str(v) for v in lost.values()), tfrc_p_ev_max=f"{p_ev:.4f}",
          equal="every trace,T,r_n,valid,max_backoff,lost_frac,summary",
          wall_s=f"{time.perf_counter() - t0:.3f}")
    if not all(lost.values()) or not p_ev > 0:
        raise AssertionError(f"no loss under the transport churn mix: {lost}, p_ev {p_ev}")


def transport_figure_on_card(dev) -> None:
    """fig_transport at the reference figure script's defaults (N=50, R=1000, 40
    reps, the iid/burst/cell regimes x RTT 0, 0.25, 1, 4, ccp tfrc_ccp
    best), one line a row beside the artifact's means; asserts every
    ordering the artifact shows with a 5% margin (ORDER_MARGIN) and that
    ``best``, which reads no feedback, is the same at every RTT."""
    from repro_torch.figures import fig_transport

    before = _kernel_launches()
    out = fig_transport.run(device=dev, out_dir=FIGURES_OUT)
    _no_kernel_between(before, "fig_transport")
    ref = {(r["sweep"], r["rtt_mean"]): r for r in _reference_rows("fig_transport")}
    pols = fig_transport.POLICIES
    checked = 0
    for row in out["rows"]:
        r = ref[(row["sweep"], row["rtt_mean"])]
        phase("fig_transport", sweep=row["sweep"], rtt_mean=row["rtt_mean"], reps=40,
              invalid=_invalid(row, pols), M=",".join(str(row[p]["M"]) for p in pols),
              **{p: f"{row[p]['mean']:.4f}" for p in pols},
              **{f"ref_{p}": f"{r[p]['mean']:.4f}" for p in pols},
              **{f"eff_{p}": f"{row[p]['efficiency']:.4f}" for p in pols},
              ref_invalid=_invalid(r, pols))
        checked += _check_orderings("fig_transport", row, r, pols,
                                    f"{row['sweep']} rtt={row['rtt_mean']}")
    for regime in fig_transport.REGIMES:
        best = {row["best"]["mean"] for row in out["rows"] if row["sweep"] == regime}
        if len(best) != 1:
            raise AssertionError(f"fig_transport {regime}: best is not flat across RTT: {best}")
    phase("fig_transport", orderings_checked=checked, best_flat="yes",
          wall_s=f"{out['wall_s']:.3f}",
          regime_wall_s=",".join(f"{k}={v:.3f}" for k, v in out["regime_wall_s"].items()),
          summary=",".join(f"{k}={v:.4f}" for k, v in out["summary"].items()),
          out=(FIGURES_OUT / "fig_transport.json").relative_to(ROOT))


def fleet_card_vs_cpu(dev) -> None:
    """The fleet loop on the card against the CPU on one set of fleet
    tables, under churn and transport, for ccp, tfrc_ccp, rateless_ccp and
    hcmm under FIFO, priority and processor sharing: every trace (tr, idle,
    tx, lost, backoff, queue_delay, contention, tx_end, busy_end, sym_id)
    and T, sojourn, valid, r_n, max_backoff, lost_frac, makespan and
    fairness bit for bit; efficiency and utilization at rtol 1e-6 (sums in
    another order on each device)."""
    import torch
    from repro_torch.core import engine, fleet, simulator

    c = FLEET_CARD_VS_CPU
    cfg = simulator.ScenarioConfig(N=c["N"], scenario=1, churn=_transport_churn(1.0))
    R = c["R"]
    before = _kernel_launches()
    t0 = time.perf_counter()
    contention = 0
    for discipline in fleet.DISCIPLINES:
        fc = fleet.FleetConfig(n_tasks=c["n_tasks"], discipline=discipline, placement="striped",
                               helpers_per_task=c["helpers_per_task"])
        tables = engine.draw_fleet_tables(torch.Generator().manual_seed(4), cfg, fc, c["reps"],
                                          R, c["M"])
        on_card = tables.to(dev)
        cc = cfg.ccp_cfg(R)
        for name in c["policies"]:
            pol = engine._as_policy(name)
            per_task = pol.fleet_aux == "per_task"
            traces, results = [], []
            for t in (tables, on_card):
                aux = (pol.prepare_fleet(cfg, R, cc, t.mu, t.a, t.rate, t.recruit) if per_task
                       else pol.prepare(cfg, R, cc, t.mu, t.a, t.rate))
                traces.append(fleet.fleet_stream(
                    t.beta, t.d_up, t.d_ack, t.d_down, t.release, t.recruit, t.prio,
                    policy=pol, cfg_static=(cc.Bx, cc.Br, cc.Back, cc.alpha),
                    fleet_static=discipline, churn_static=cfg.churn.static_key(), dyn=t.dyn,
                    a=t.a, aux=aux, aux_task_axis=per_task)[0])
                results.append(engine.simulate_fleet(t, cfg, R, pol, fc))
            label = f"fleet {name} {discipline}"
            _equal_or_raise(label, traces[1], traces[0], list(traces[0]))
            _equal_or_raise(label, results[1], results[0],
                            [k for k in results[0] if k not in ("efficiency", "util")],
                            close=("efficiency", "util"))
            contention = max(contention, int(traces[0]["contention"].max()))
    _no_kernel_between(before, "fleet-card-vs-cpu")
    phase("fleet-card-vs-cpu", cfg="test_transport CHURN + lognormal RTT 1.0", N=c["N"], R=R,
          M=c["M"], reps=c["reps"], n_tasks=c["n_tasks"], placement="striped",
          helpers_per_task=c["helpers_per_task"], policies=",".join(c["policies"]),
          disciplines=",".join(fleet.DISCIPLINES), max_contention=contention,
          equal="traces,queue_delay,contention,T,sojourn,valid,r_n,max_backoff,lost_frac,"
                "makespan,fairness", wall_s=f"{time.perf_counter() - t0:.3f}")
    if contention < 2:
        raise AssertionError("no tenant queued behind another in fleet-card-vs-cpu")


def fleet_figure_on_card(dev) -> None:
    """fig_fleet at the reference figure script's defaults (N=20, R=300, 40 reps,
    1-12 tasks, 5 helpers a task, striped, FIFO, ccp adaptive_rate hcmm
    naive), one line a row with p50/p99 sojourn beside the artifact's;
    asserts every ordering of p50 and of p99 the artifact shows with a 5%
    margin.  Sojourns are simulated seconds."""
    from repro_torch.figures import fig_fleet

    before = _kernel_launches()
    out = fig_fleet.run(device=dev, out_dir=FIGURES_OUT)
    _no_kernel_between(before, "fig_fleet")
    ref = {r["n_tasks"]: r for r in _reference_rows("fig_fleet")}
    pols = fig_fleet.POLICIES
    checked = 0
    for row in out["rows"]:
        r = ref[row["n_tasks"]]
        phase("fig_fleet", n_tasks=row["n_tasks"], offered=row["offered"], reps=40,
              invalid=_invalid(row, pols), M=",".join(str(row[p]["M"]) for p in pols),
              **{f"p50_{p}": f"{row[p]['p50']:.4f}" for p in pols},
              **{f"ref_p50_{p}": f"{r[p]['p50']:.4f}" for p in pols},
              **{f"p99_{p}": f"{row[p]['p99']:.4f}" for p in pols},
              **{f"ref_p99_{p}": f"{r[p]['p99']:.4f}" for p in pols},
              util_ccp=f"{row['ccp']['util_mean']:.4f}",
              ref_util_ccp=f"{r['ccp']['util_mean']:.4f}", ref_invalid=_invalid(r, pols))
        for stat in ("p50", "p99"):
            checked += _check_orderings("fig_fleet", row, r, pols,
                                        f"n_tasks={row['n_tasks']}", stat=stat)
    phase("fig_fleet", orderings_checked=checked, wall_s=f"{out['wall_s']:.3f}",
          row_wall_s=",".join(f"{k}={v:.3f}" for k, v in out["row_wall_s"].items()),
          knee=",".join(f"{k}={v:.4f}" for k, v in out["knee"].items()),
          out=(FIGURES_OUT / "fig_fleet.json").relative_to(ROOT))


def _qkv(dev, gen, B, Hq, Hkv, Tq, Tk, D, dtype):
    import torch
    q = (torch.randn((B, Hq, Tq, D), generator=gen, device=dev) * 0.5).to(dtype)
    k = (torch.randn((B, Hkv, Tk, D), generator=gen, device=dev) * 0.5).to(dtype)
    v = torch.randn((B, Hkv, Tk, D), generator=gen, device=dev).to(dtype)
    return q, k, v


def _fa_err(out, ref, dtype) -> tuple:
    """max|out - ref|, and whether |out - ref| <= atol + rtol |ref| everywhere."""
    import torch
    rtol, atol = FA_TOL[str(dtype).split(".")[-1]]
    ok = out.shape == ref.shape and bool(torch.isfinite(out).all()) and bool(
        torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol))
    return float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0, ok


def check_flash_attention_against_plain(dev) -> None:
    """K4 against its plain version on the card, f32 and bf16: the reference
    suite's cases, cache buffers read up to tk_valid (whatever lies beyond is
    NaN, so a read or a weight there shows), a row with no valid key, wide
    heads, and the serving path's prefill and decode shapes."""
    import torch
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.kernel import split_plan

    gen = torch.Generator(device=dev).manual_seed(5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    model = [(f"phi4-{name}", c["B"], c["Hq"], c["Hkv"], c["Tq"], c["buf"], c["D"], True, None,
              None, c["q_offset"], c["tk_valid"])
             for name, c in (("prefill", FA_PREFILL), ("decode", FA_DECODE))]
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[-1]
        for name, B, Hq, Hkv, Tq, Tk, D, causal, window, cap, off, tkv in FA_CASES + model:
            q, k, v = _qkv(dev, gen, B, Hq, Hkv, Tq, Tk, D, dt)
            valid = Tk if tkv is None else tkv
            k[:, :, valid:], v[:, :, valid:] = torch.nan, torch.nan
            kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
            out = flash_attention(q, k, v, tk_valid=tkv, **kw)
            ref = (attention_ref(q, k[:, :, :valid], v[:, :, :valid], **kw) if valid
                   else torch.zeros_like(q))
            torch.cuda.synchronize()
            err, ok = _fa_err(out, ref, dt)
            rtol, atol = FA_TOL[tag]
            plan = split_plan(B, Hq, Hkv, Tq, Tk, D, sms, dt == torch.float32 and D % 4 == 0)
            phase("k4-check", case=f"{name}-{tag}", shape=f"B{B}H{Hq}/{Hkv}Tq{Tq}Tk{Tk}D{D}",
                  tk_valid=valid, instance="wgmma" if plan.wgmma else "cuda-cores",
                  splits=plan.n_split, max_abs_err=f"{err:.3e}", rtol=rtol, atol=atol)
            if not ok:
                raise AssertionError(f"K4 disagrees with its plain version: {name} {tag}")
            del q, k, v, out, ref
    torch.cuda.empty_cache()


def k4_at_shape(dev, gen, label: str, B, Hq, Hkv, Tq, buf, D, causal, window, off, tkv,
                precision: bool = False) -> dict:
    """K4 at one shape, f32, with what lies in the buffer beyond ``tkv``
    zero (as init_cache makes it): against its plain version (the CPU
    route: attention_ref over the buffer, masked by the valid length), its
    device time by the profiler (every kernel the call launched must be
    K4's, of the instance ``split_plan`` names), CUDA events (which also
    count the card waiting for the host's enqueue where a call is as short
    as a decode step's), the plain version's time and the library
    yardstick (scaled_dot_product_attention with enable_gqa and an explicit
    mask where causal or windowed, over the valid prefix; the port never
    calls it), beside the bound of the same work: the valid pairs' products
    as three TF32 products on the tensor cores and, for comparison, fp32 on
    the CUDA cores, against the bytes of q, the output and the K/V rows some
    query attends to.  ``precision``: then ``[k4-precision]``.  Prints
    ``[label]`` and returns the row for the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_cuda
    from repro_torch.kernels.flash_attention.kernel import attention_costs, split_plan

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q, k, v = _qkv(dev, gen, B, Hq, Hkv, Tq, buf, D, torch.float32)
    k[:, :, tkv:], v[:, :, tkv:] = 0.0, 0.0
    kw = dict(causal=causal, window=window, q_offset=off)

    def k4():
        return flash_attention_cuda(q, k, v, tk_valid=tkv, **kw)

    out = k4()
    ref = attention_ref(q, k, v, kv_len=tkv, **kw)
    torch.cuda.synchronize()
    err, ok = _fa_err(out, ref, torch.float32)
    if not ok:
        raise AssertionError(f"K4 at the {label} shape: max|err| {err:.3e}")
    del ref
    kv = k[:, :, :tkv], v[:, :, :tkv]
    mask = None
    if causal or window is not None:
        qp = off + torch.arange(Tq, device=dev)[:, None]
        kp = torch.arange(tkv, device=dev)[None, :]
        mask = (kp <= qp) if causal else torch.ones((Tq, tkv), dtype=torch.bool, device=dev)
        if window is not None:
            mask &= (qp - kp) < window
    lib = F.scaled_dot_product_attention(q, *kv, attn_mask=mask, enable_gqa=True)
    lib_err = float((lib - out).abs().max())
    plan = split_plan(B, Hq, Hkv, Tq, buf, D, sms, True)
    kernel = "flash_attention_wgmma_kernel" if plan.wgmma else "flash_attention_kernel"
    steps = kernel_device_ms(k4, 20 if Tq > 1 else 200, dict(k4=kernel))
    if steps["other"] > 0:
        raise AssertionError(f"the {label} shape launched kernels besides {kernel}")
    ms = steps["k4"]
    event_ms = time_ms(k4, 20 if Tq > 1 else 200)
    plain_ms = time_ms(lambda: attention_ref(q, k, v, kv_len=tkv, **kw), 5 if Tq > 1 else 50)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, *kv, attn_mask=mask,
                                                             enable_gqa=True),
                     20 if Tq > 1 else 200)
    ops, nbytes = attention_costs(B, Hq, Hkv, Tq, D, q_offset=off, tk_valid=tkv,
                                  causal=causal, window=window, elem=q.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fp32 = ops / FP32_FLOPS * 1e3
    t_ops = 3 * ops / TF32_FLOPS * 1e3
    bound, bound_fp32 = max(t_bytes, t_ops), max(t_bytes, t_fp32)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    working = plan.working_ctas(B, Hkv, tkv)
    phase(label, B=B, Hq=Hq, Hkv=Hkv, Tq=Tq, buffer=buf, q_offset=off, tk_valid=tkv, D=D,
          causal=causal, window=window, instance=kernel, splits=plan.n_split,
          chunk=plan.chunk, ctas=plan.ctas(B, Hkv), working_ctas=working,
          k4_ms=f"{ms:.4f}", k4_event_ms=f"{event_ms:.4f}", bound_ms=f"{bound:.4f}",
          bound_by=bound_by, share_of_bound=f"{bound / ms:.3f}",
          bound_fp32_cores_ms=f"{bound_fp32:.4f}",
          share_of_fp32_bound=f"{bound_fp32 / ms:.3f}", gflop=f"{ops / 1e9:.4f}",
          k4_tflops=f"{ops / ms / 1e9:.2f}", mbytes=f"{nbytes / 1e6:.2f}",
          k4_gbps=f"{nbytes / ms / 1e6:.1f}", plain_ms=f"{plain_ms:.4f}",
          sdpa_ms=f"{lib_ms:.4f}", sdpa_max_abs_diff=f"{lib_err:.3e}",
          max_abs_err=f"{err:.3e}")
    if precision:
        k4_precision(out, q, *kv)
    del q, k, v, kv, out, lib, mask
    torch.cuda.empty_cache()
    return dict(shape=label, wgmma=plan.wgmma, working_ctas=working, sms=sms, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_fp32_cores_ms=bound_fp32, bound_by=bound_by, max_abs_err=err)


def flash_attention_at_path_shapes(dev) -> dict:
    """K4 at the serving path's prefill and decode shapes (``k4_at_shape``):
    the prefill must run on the tensor cores (3xTF32 wgmma) alone, the
    decode step on the CUDA cores over at least one working CTA an SM.
    Then ``[k4-precision]`` at the prefill shape.  Returns the sums over
    the two shapes for the kernels line."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(6)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bound_fp32_cores_ms=0.0,
               max_abs_err=0.0)
    for name, c in (("prefill", FA_PREFILL), ("decode", FA_DECODE)):
        row = k4_at_shape(dev, gen, f"k4-{name}-shape", c["B"], c["Hq"], c["Hkv"], c["Tq"],
                          c["buf"], c["D"], True, None, c["q_offset"], c["tk_valid"],
                          precision=name == "prefill")
        if row["wgmma"] != (c["Tq"] > 1):
            raise AssertionError(f"the {name} shape's plan has wgmma={row['wgmma']}")
        if c["Tq"] == 1 and row["working_ctas"] < row["sms"]:
            raise AssertionError(f"the decode step splits over {row['working_ctas']} working "
                                 f"CTAs, fewer than the {row['sms']} SMs")
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_fp32_cores_ms"):
            tot[key] += row[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_abs_err"])
        if name == "prefill":  # the sum is dominated by the prefill's operations bound
            tot["bound_by"] = row["bound_by"]
    return tot


def k4_precision(out, q, k, v) -> None:
    """Why K4's prefill runs 3xTF32: its error at the prefill shape against
    an fp64 attention, beside the plain version's (fp32 on cuBLAS) and one
    TF32 product's (``ref.attention_3xtf32`` with ``products=1``), each as a
    share of FA_TOL, max |err| / (atol + rtol |ref|).  Fails unless K4
    keeps the tolerance."""
    import torch
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_3xtf32

    group = q.shape[1] // k.shape[1]
    s = (q.double() @ k.double().repeat_interleave(group, 1).transpose(-1, -2))
    s /= q.shape[-1] ** 0.5
    s.masked_fill_(~torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril(), -torch.inf)
    exact = torch.softmax(s, dim=-1) @ v.double().repeat_interleave(group, 1)
    del s
    rtol, atol = FA_TOL["float32"]
    tol = atol + rtol * exact.abs()
    runs = {"k4": lambda: out, "plain": lambda: attention_ref(q, k, v, causal=True),
            "tf32": lambda: attention_3xtf32(q, k, v, products=1)}
    errs, shares = {}, {}
    for name, run in runs.items():
        d = (run().double() - exact).abs()
        errs[name], shares[name] = float(d.max()), float((d / tol).max())
        del d
    phase("k4-precision", rtol=rtol, atol=atol,
          **{f"{n}_err": f"{e:.3e}" for n, e in errs.items()},
          **{f"{n}_share_of_tol": f"{sh:.4f}" for n, sh in shares.items()})
    del exact, tol
    if not shares["k4"] <= 1.0:
        raise AssertionError(f"K4 misses FA_TOL against fp64: {shares['k4']:.3f} of it")


def _gb(tree) -> float:
    if isinstance(tree, dict):
        return sum(_gb(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_gb(v) for v in tree)
    return tree.numel() * tree.element_size() / 1e9


def _state_bytes(cache) -> int:
    """Bytes of the tensors of a cache tree (its Python ints aside)."""
    import torch
    from repro_torch.models.common import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(cache)
               if isinstance(t, torch.Tensor))


def serve_main_path(dev) -> int:
    """phi4-mini-3.8b at its full published config (32 layers, d_model 3072,
    24 heads / 8 KV heads, head_dim 128, d_ff 8192, vocab 200064, tied
    embeddings, fp32) through ``serve_family``: 4 request batches of 4
    prompts of 1024 tokens, 32 new tokens each.  Then the decode step under
    the profiler, and CCPDispatcher over two replicas of the engine, one
    slowed.  Returns K4's launches."""
    import numpy as np
    from repro_torch.runtime.serve_loop import CCPDispatcher

    def after(model, params, engine, toks, rng, cfg):
        profile_decode(model, params, toks)
        roofline_decode_step(model, params, toks)

        def replica(delay):
            def run(b):
                time.sleep(delay)
                return engine.generate(b, n_new=DISPATCH["new"])
            return run

        small = [rng.integers(0, cfg.vocab, size=(SERVE["batch"], DISPATCH["prompt"]))
                 .astype(np.int32) for _ in range(DISPATCH["batches"])]
        t0 = time.perf_counter()
        out, allocs = CCPDispatcher([replica(0.0), replica(DISPATCH["delay_s"])]).run(small)
        phase("serve-dispatch", replicas=2, slow_delay_s=DISPATCH["delay_s"],
              batches=len(small), prompt=DISPATCH["prompt"], new_tokens=DISPATCH["new"],
              allocs="|".join(",".join(str(int(x)) for x in a) for a in allocs),
              wall_s=f"{time.perf_counter() - t0:.3f}")
        if not all(r is not None and r.shape == (SERVE["batch"], DISPATCH["new"]) for r in out):
            raise AssertionError("a dispatched batch came back with the wrong shape")

    return serve_family(dev, SERVE, after)


def profile_decode(model, params, toks, steps: int = 3) -> None:
    """Where a decode step's time goes: torch.profiler over ``steps``
    decode steps after a prefill of ``toks[:, :-1]``; the device's busy time
    per step by kernel family, its idle share of the steps' span (CUDA
    events), and the kernel launches the host makes per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache = model.init_cache(toks.shape[0], SERVE["max_len"], device=toks.device)
    with torch.no_grad():
        _, cache = model.prefill(params, toks[:, :-1], cache)
        cur = toks[:, -1:]
        logits, cache = model.decode_step(params, cur, cache)  # warm-up
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(steps):
                logits, cache = model.decode_step(params, cur, cache)
                cur = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            end.record()
            end.synchronize()
    span = start.elapsed_time(end) / steps

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = prof.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kern) / 1e3 / steps
    fam = {"k4": 0.0, "gemm": 0.0}
    for e in kern:
        key = ("k4" if "flash_attention_" in e.key else
               "gemm" if "gemm" in e.key.lower() or "splitkreduce" in e.key.lower() else None)
        if key:
            fam[key] += dev_us(e) / 1e3 / steps
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    top = sorted(kern, key=dev_us, reverse=True)[:5]
    phase("serve-profile", steps=steps, span_ms_per_step=f"{span:.3f}",
          device_busy_ms_per_step=f"{busy:.3f}" if kern else "not-measured",
          idle_share=f"{1 - busy / span:.3f}" if kern else "not-measured",
          k4_ms_per_step=f"{fam['k4']:.3f}", gemm_ms_per_step=f"{fam['gemm']:.3f}",
          other_ms_per_step=f"{busy - fam['k4'] - fam['gemm']:.3f}",
          launches_per_step=f"{launches / steps:.0f}",
          top=";".join(f"{e.key[:48]}={dev_us(e) / 1e3 / steps:.3f}ms" for e in top))
    del cache, logits


def serve_card_vs_cpu(dev) -> None:
    """phi4-mini's full width at 2 layers with the same weights on the card
    (K4, cuBLAS) and on the CPU (the plain version): prefill, then the
    logits of every decode step teacher-forced with the card's tokens, and
    the generated tokens equal."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import ServeEngine

    c = CARD_VS_CPU
    cfg = get_config(SERVE["arch"], n_layers=c["n_layers"])
    model = build_model(cfg)
    on_card = model.init(1, device=dev)

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu()

    on_cpu = to_cpu(on_card)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=(c["B"], c["prompt"]))
    prompt = prompt.astype(np.int32)
    max_len = c["prompt"] + c["new"]
    toks_card = ServeEngine(model, on_card, max_len=max_len, device=dev).generate(prompt, c["new"])
    toks_cpu = ServeEngine(model, on_cpu, max_len=max_len, device="cpu").generate(prompt, c["new"])
    worst, scale = 0.0, 0.0
    with torch.no_grad():
        runs = []
        for params, d in ((on_card, dev), (on_cpu, torch.device("cpu"))):
            cache = model.init_cache(c["B"], max_len, device=d)
            logits, cache = model.prefill(params, torch.as_tensor(prompt[:, :-1], device=d), cache)
            steps = [logits.cpu()]
            forced = np.concatenate([prompt[:, -1:], toks_card[:, :-1]], axis=1)
            for t in range(c["new"]):
                logits, cache = model.decode_step(
                    params, torch.as_tensor(forced[:, t:t + 1], device=d), cache)
                steps.append(logits.cpu())
            runs.append(steps)
    for a, b in zip(*runs):
        worst = max(worst, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
        if not torch.allclose(a, b, rtol=c["rtol"], atol=c["atol"]):
            raise AssertionError(f"card and CPU logits differ by {worst:.3e}")
    phase("serve-card-vs-cpu", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
          B=c["B"], prompt=c["prompt"], new_tokens=c["new"], steps=len(runs[0]),
          max_abs_logit_diff=f"{worst:.3e}", max_abs_logit=f"{scale:.3f}",
          rtol=c["rtol"], atol=c["atol"], tokens_equal=bool(np.array_equal(toks_card, toks_cpu)))
    if not np.array_equal(toks_card, toks_cpu):
        raise AssertionError(f"card tokens {toks_card} != CPU tokens {toks_cpu}")
    del on_card, on_cpu
    torch.cuda.empty_cache()


# --- LM training (slice C2) ------------------------------------------------------

# K4's backward against its plain version: (name, B, Hq, Hkv, Tq, Tk, D,
# causal, window, softcap, q_offset, tk_valid).  GQA groups 1, 3 and 4,
# ragged rows (300 packed rows against the tensor-core instance's 128),
# windows, softcaps, a cache buffer read up to tk_valid (what lies beyond is
# NaN and must get zero gradients; 101 lies inside a 32-key tile), rows
# with no valid key (a negative offset leaves the first rows without one;
# tk_valid 0 all), head dims 24, 64, 128 and 256, and phi4-mini's heads at
# 256 tokens.  In float32 every case with D <= 128 but the unaligned D 30
# runs the tensor-core instance; D 256, D 30 and bfloat16 the CUDA cores.
FA_BWD_CASES = [
    ("mha-d64", 1, 2, 2, 64, 64, 64, True, None, None, 0, None),
    ("gqa3-ragged-d128", 2, 6, 2, 100, 100, 128, True, None, None, 0, None),
    ("gqa4-noncausal-d128", 1, 8, 2, 37, 53, 128, False, None, None, 0, None),
    ("window16", 1, 4, 2, 96, 96, 64, True, 16, None, 0, None),
    ("softcap30-gqa4", 1, 4, 1, 80, 80, 64, True, None, 30.0, 0, None),
    ("window8-softcap50-d24", 2, 4, 2, 45, 45, 24, True, 8, 50.0, 0, None),
    ("offset-buffer", 2, 6, 2, 23, 64, 24, True, None, None, 10, 33),
    ("first-rows-no-key", 1, 4, 2, 16, 32, 64, True, None, None, -3, None),
    ("no-valid-key", 1, 4, 2, 5, 40, 8, True, None, None, 3, 0),
    ("head256-window", 1, 4, 4, 70, 200, 256, True, 32, None, 5, 75),
    ("phi4-heads", 1, 24, 8, 256, 256, 128, True, None, None, 0, None),
    ("offset-buffer-d128", 2, 6, 2, 70, 160, 128, True, None, None, 40, 101),
    ("unaligned-d30", 1, 4, 2, 50, 50, 30, True, None, None, 0, None),
    ("rg-heads-d256-window", 1, 10, 1, 256, 256, 256, True, 64, None, 0, None),
]
# K4's backward at the training shape (phi4-mini's heads, 1024 tokens, a
# microbatch of 4 sequences, causal, f32).
FA_BWD_SHAPE = dict(B=4, Hq=24, Hkv=8, T=1024, D=128)
# The training path: phi4-mini-3.8b at full width, 8 of its 32 layers (the
# full depth's 3.84 B parameters with their gradients and AdamW's m and v
# need ~61 GB before any activation), batch 8 in 2 microbatches of 4 x 1024
# tokens, 4 steps, remat on, through launch/train.
TRAIN = dict(arch="phi4-mini-3.8b", n_layers=8, batch=8, n_micro=2, seq=1024, steps=4)
# Card against CPU: full width, 2 layers, 1 x 64 tokens; the loss within
# 1e-5 relative, each gradient leaf within 1e-4 of its max |.| (the port's
# parity tolerance against the reference: fp32 sums over 3072-200064 terms in
# another order, K4 and its backward against the plain versions), one AdamW
# step on the same gradients within 1e-6 (elementwise fp32; CUDA divides by
# a scalar as a product with its reciprocal).
TRAIN_CARD_VS_CPU = dict(n_layers=2, B=1, T=64, loss_rtol=1e-5, grad_tol=1e-4, opt_tol=1e-6)
# Coded DP: tests/test_coded_train_step.py's setup (mistral-nemo-12b smoke,
# R=8 workers, 4 parities, microbatches of 2 x 16 tokens, the update within
# 5e-5 of the uncoded one), then phi4-mini's full width at 2 layers, where
# the coded gradient sum must be within 1e-5 of the uncoded sum, relative to
# its max |.|.
CODED = dict(R=8, n_parity=4, mb=2, T=16, tol=5e-5, full_layers=2, full_mb=1, full_T=64,
             full_rtol=1e-5)


def _fa_bwd_inputs(dev, gen, B, Hq, Hkv, Tq, Tk, D, dtype, tk_valid):
    """q, k, v, dO; keys at or beyond tk_valid NaN."""
    import torch
    q, k, v = _qkv(dev, gen, B, Hq, Hkv, Tq, Tk, D, dtype)
    do = torch.randn((B, Hq, Tq, D), generator=gen, device=dev).to(dtype)
    if tk_valid is not None:
        k[:, :, tk_valid:], v[:, :, tk_valid:] = torch.nan, torch.nan
    return q, k, v, do


def check_flash_attention_bwd(dev) -> None:
    """K4's forward with its log-sum-exp, and its backward kernel, against
    the plain versions (``ref.attention_lse_ref``, ``attention_fwd_ref``,
    ``attention_bwd_ref`` over the valid prefix) on the card, f32 and bf16,
    with the instance that ran (``bwd_plan``): each gradient within
    FA_BWD_TOL for the type (|d - ref| <= atol max|ref| + rtol |ref|; the
    share of that limit the worst element uses is printed), the tensor-core
    instance's also against the plain model of its arithmetic
    (``attention_bwd_3xtf32``), the log-sum-exp within the forward's
    FA_TOL, zero gradients at keys beyond tk_valid, and two runs of the
    backward bitwise equal."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.flash_attention.autograd import kernel_forward
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_3xtf32,
                                                         attention_bwd_ref, attention_fwd_ref)

    gen = torch.Generator(device=dev).manual_seed(7)
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[-1]
        rtol, atol = FA_TOL[tag]
        g_rtol, g_atol = FA_BWD_TOL[tag]
        for name, B, Hq, Hkv, Tq, Tk, D, causal, window, cap, off, tkv in FA_BWD_CASES:
            q, k, v, do = _fa_bwd_inputs(dev, gen, B, Hq, Hkv, Tq, Tk, D, dt, tkv)
            valid = Tk if tkv is None else tkv
            kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
            out, lse = kernel_forward(q, k, v, kv_len=tkv, **kw)
            before = k4.flash_attention_bwd_cuda.launches
            grads = k4.flash_attention_bwd_cuda(q, k, v, out, do, lse, tk_valid=tkv, **kw)
            again = k4.flash_attention_bwd_cuda(q, k, v, out, do, lse, tk_valid=tkv, **kw)
            torch.cuda.synchronize()
            if k4.flash_attention_bwd_cuda.launches != before + 2 * k4.BWD_LAUNCHES:
                raise AssertionError("the backward's launch count is off")
            ks, vs = k[:, :, :valid], v[:, :, :valid]
            o_ref, lse_ref = attention_fwd_ref(q, ks, vs, kv_len=None, **kw)
            ref = attention_bwd_ref(q, ks, vs, o_ref, do, lse_ref, kv_len=None, **kw)
            pad = torch.zeros((B, Hkv, Tk - valid, D), dtype=dt, device=dev)
            ref = (ref[0], torch.cat([ref[1], pad], 2), torch.cat([ref[2], pad], 2))
            # -inf on the same rows (no valid key), the rest within tolerance
            fin_lse, fin_ref = (torch.where(torch.isinf(x), 0, x) for x in (lse, lse_ref))
            lse_err = float((fin_lse - fin_ref).abs().max())
            lse_ok = torch.equal(torch.isinf(lse), torch.isinf(lse_ref)) and bool(
                torch.allclose(fin_lse, fin_ref, rtol=rtol, atol=atol))
            plan = k4.bwd_plan(D, dt == torch.float32 and D % 4 == 0)
            model = (attention_bwd_3xtf32(q, k, v, out, do, lse, kv_len=tkv, **kw)
                     if plan.wgmma else None)

            def share_of(g, r):  # the worst element's share of FA_BWD_TOL's limit
                diff, r = (g.float() - r.float()).abs(), r.float()
                limit = g_atol * float(r.abs().max()) + g_rtol * r.abs()
                return float(diff.max()), float(torch.where(diff > 0, diff / limit, 0.0).max())

            errs, share, model_share, ok = [], 0.0, 0.0, lse_ok
            for i, (g, r) in enumerate(zip(grads, ref)):
                err, sh = share_of(g, r)
                errs.append(err)
                share = max(share, sh)
                ok = ok and bool(torch.isfinite(g).all()) and sh <= 1.0
                if model is not None:
                    model_share = max(model_share, share_of(g, model[i])[1])
            ok = ok and model_share <= 1.0
            zeros = all(bool((g[:, :, valid:] == 0).all()) for g in grads[1:])
            bitwise = all(torch.equal(a, b) for a, b in zip(grads, again))
            phase("k4-bwd-check", case=f"{name}-{tag}", shape=f"B{B}H{Hq}/{Hkv}Tq{Tq}Tk{Tk}D{D}",
                  instance="wgmma" if plan.wgmma else "cuda-cores", q_offset=off,
                  tk_valid=valid, lse_err=f"{lse_err:.3e}",
                  dq_err=f"{errs[0]:.3e}", dk_err=f"{errs[1]:.3e}", dv_err=f"{errs[2]:.3e}",
                  grad_rtol=g_rtol, grad_atol=g_atol, share_of_limit=f"{share:.3f}",
                  model_share_of_limit=f"{model_share:.3f}" if plan.wgmma else "n/a",
                  zeros_beyond_tk_valid=zeros, bitwise_repeat=bitwise)
            if not ok or not zeros:
                raise AssertionError(f"K4's backward disagrees with its plain version: {name} "
                                     f"{tag}")
            if not bitwise:
                raise AssertionError(f"K4's backward is not bitwise repeatable: {name} {tag}")
            del q, k, v, do, out, lse, grads, again, ref, model
    torch.cuda.empty_cache()


def k4_bwd_at_shape(dev, label: str, B, Hq, Hkv, T, D, window=None) -> dict:
    """K4's backward at one causal f32 shape, on the instance ``bwd_plan``
    names: against the plain version, the two launches' device time by the
    profiler (by kernel name: anything else the backward launched fails)
    and by CUDA events, the plain version's time, the library yardstick (the
    backward of ``scaled_dot_product_attention(..., is_causal=True,
    enable_gqa=True)`` in fp32, timed only; the port never calls it; no
    window, which changes nothing where the window spans the sequence) and
    the bounds: 10 B Hq pairs D FLOP as three TF32 products on the tensor
    cores (the least time fp32-accurate products take on the card, as for
    K1 and K4's forward), beside it the two-launch design's own floor (7 of
    those 5 products a pair: 7/5 of the bound) and the bound over the CUDA
    cores' fp32 rate; the bytes of q, k, v, o, dO, lse in and dq, dk, dv
    out.  Prints ``[k4-bwd-shape]`` and returns the numbers for the
    kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.flash_attention.autograd import kernel_forward
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v, do = _fa_bwd_inputs(dev, gen, B, Hq, Hkv, T, T, D, torch.float32, None)
    kw = dict(causal=True, window=window, softcap=None, q_offset=0)
    out, lse = kernel_forward(q, k, v, kv_len=None, **kw)

    def bwd():
        return k4.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)

    grads = bwd()
    ref = attention_bwd_ref(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    rtol, atol = FA_TOL["float32"]
    err, ok = 0.0, True
    for g, r in zip(grads, ref):
        scale = float(r.abs().max())
        err = max(err, float((g - r).abs().max()))
        ok = ok and bool(((g - r).abs() <= atol * scale + rtol * r.abs()).all())
    if not ok:
        raise AssertionError(f"K4's backward at the {label} shape: max|err| {err:.3e}")
    del grads, ref
    plan = k4.bwd_plan(D, True)
    tc = "_wgmma" if plan.wgmma else ""
    steps = kernel_device_ms(bwd, 20, dict(dq=f"attention_bwd_dq{tc}_kernel",
                                           dkdv=f"attention_bwd_dkdv{tc}_kernel"))
    if steps["other"] > 0:
        raise AssertionError("the backward launched kernels besides its two")
    ms = steps["dq"] + steps["dkdv"]
    event_ms = time_ms(bwd, 10)
    plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, out, do, lse, **kw), 3)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    lib_diff = float((lib_out.detach() - out).abs().max())
    lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True),
                     10)
    flops, nbytes = k4.attention_bwd_costs(B, Hq, Hkv, T, T, D, q_offset=0, tk_valid=T,
                                           causal=True, window=window, elem=q.element_size())
    dq_ctas, dkdv_ctas = plan.ctas(B, Hq, Hkv, T, T)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fp32 = flops / FP32_FLOPS * 1e3
    t_tf32 = 3 * flops / TF32_FLOPS * 1e3
    bound, bound_fp32 = max(t_bytes, t_tf32), max(t_bytes, t_fp32)
    floor = 7 / 5 * t_tf32  # S and dP recomputed in the second launch
    bound_by = "bytes" if t_bytes >= t_tf32 else "operations"
    phase("k4-bwd-shape", shape=label, B=B, Hq=Hq, Hkv=Hkv, T=T, D=D, causal=True,
          window=window, dtype="float32", instance="wgmma" if plan.wgmma else "cuda-cores",
          dq_ctas=dq_ctas, dkdv_ctas=dkdv_ctas, dq_ms=f"{steps['dq']:.4f}",
          dkdv_ms=f"{steps['dkdv']:.4f}", bwd_ms=f"{ms:.4f}",
          bwd_event_ms=f"{event_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=bound_by,
          two_launch_floor_ms=f"{floor:.4f}", share_of_floor=f"{floor / ms:.3f}",
          bound_fp32_cores_ms=f"{bound_fp32:.4f}", bytes_bound_ms=f"{t_bytes:.4f}",
          share_of_bound=f"{bound / ms:.3f}", gflop=f"{flops / 1e9:.2f}",
          tflops=f"{flops / ms / 1e9:.2f}", plain_ms=f"{plain_ms:.3f}",
          sdpa_bwd_ms=f"{lib_ms:.4f}", sdpa_fwd_max_abs_diff=f"{lib_diff:.3e}",
          max_abs_err=f"{err:.3e}")
    del q, k, v, do, out, lse, ql, kl, vl, lib_out
    torch.cuda.empty_cache()
    return dict(shape=label, wgmma=plan.wgmma, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=lib_ms, max_abs_err=err,
                bound_fp32_cores_ms=bound_fp32)


def flash_attention_bwd_at_train_shape(dev) -> dict:
    """K4's backward at the training shape (FA_BWD_SHAPE: B 4, 24/8 heads,
    1024 tokens, D 128, causal, f32, ``k4_bwd_at_shape``), which must run
    the tensor-core instance."""
    c = FA_BWD_SHAPE
    row = k4_bwd_at_shape(dev, "train", c["B"], c["Hq"], c["Hkv"], c["T"], c["D"])
    if not row.pop("wgmma"):
        raise AssertionError("the training shape's backward is not on the tensor cores")
    return row


def train_main_path(dev) -> dict:
    """phi4-mini-3.8b at full width, 8 layers, through ``launch/train``
    (remat on, AdamW, the synthetic stream): batch 8 in 2 microbatches of
    4 x 1024 tokens, 4 steps, every attention's forward on K4 and its
    backward on the backward kernel.  The launch counts are reset just
    before the run and must be exact: K4's forward twice a layer and
    microbatch (remat recomputes it), the backward's two launches once.
    Every loss finite, and at step 1 every gradient leaf finite and not all
    zero.  Returns the launches."""
    import os

    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.launch import train

    c = TRAIN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    os.environ["REPRO_TRAIN_OVERRIDES"] = f"n_layers={c['n_layers']}"
    try:
        k4.flash_attention_cuda.launches = k4.flash_attention_bwd_cuda.launches = 0
        res = train.run(["--arch", c["arch"], "--steps", str(c["steps"]), "--batch",
                         str(c["batch"]), "--seq", str(c["seq"]), "--n-micro", str(c["n_micro"]),
                         "--log-every", "1"])
        fwd, bwd = k4.flash_attention_cuda.launches, k4.flash_attention_bwd_cuda.launches
    finally:
        del os.environ["REPRO_TRAIN_OVERRIDES"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    cfg = res["cfg"]
    for rec in res["history"]:
        phase("train", step=rec["step"] + 1, loss=f"{rec['loss']:.6f}",
              grad_norm=f"{rec['grad_norm']:.6f}", lr=f"{rec['lr']:.3e}",
              step_ms=f"{rec['ms']:.1f}", tokens_per_s=f"{rec['tokens_per_s']:.1f}")
    calls = cfg.n_layers * c["n_micro"] * c["steps"]
    sq = res["history"][0]["grad_leaf_sq"]
    phase("train", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
          heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", head_dim=cfg.head_dim_, d_ff=cfg.d_ff,
          vocab=cfg.vocab, params=cfg.n_params(), batch=c["batch"], n_micro=c["n_micro"],
          seq=c["seq"], steps=c["steps"], remat="full", wall_s=f"{res['wall_s']:.3f}",
          max_memory_allocated_gb=f"{peak:.3f}", k4_fwd_launches=fwd,
          k4_bwd_launches=bwd, grad_leaves=len(sq),
          step1_min_leaf_sq=f"{float(np.min(sq)):.3e}")
    if not all(np.isfinite(r["loss"]) for r in res["history"]):
        raise AssertionError("a training loss is not finite")
    if not (np.all(np.isfinite(sq)) and np.all(sq > 0)):
        raise AssertionError(f"at step 1 {int(np.sum(~(sq > 0)))} gradient leaves are zero or "
                             "not finite")
    if fwd != 2 * calls or bwd != k4.BWD_LAUNCHES * calls:
        raise AssertionError(f"K4 launched {fwd} forwards and {bwd} backward kernels, expected "
                             f"{2 * calls} and {k4.BWD_LAUNCHES * calls}")
    torch.cuda.empty_cache()
    return dict(fwd=fwd, bwd=bwd)


def profile_train_step(dev) -> None:
    """Where a training step's time goes: torch.profiler over one step of
    the [train] configuration after a warm-up step; the device's busy time
    against the step's span (CUDA events), by kernel family (the fp32
    products, K4's forward, its backward), the device span of AdamW's
    update and of the loss's forward (the cross entropy over the vocab,
    after the LM head's product), each from a profiler range put around
    the port's function for this step only, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.models import model as model_mod
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import make_train_step

    c = TRAIN
    cfg = get_config(c["arch"], n_layers=c["n_layers"])
    model = build_model(cfg, remat=True)
    params = model.init(0, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=c["steps"])
    opt_state = adamw.init(params)
    step = make_train_step(model, opt_cfg, c["n_micro"], pre_shaped=True, device=dev)
    data = SyntheticLM(cfg.vocab, c["seq"], c["batch"], n_micro=c["n_micro"], seed=0)

    def batch(i):
        return {k: torch.as_tensor(v, device=dev) for k, v in data.batch(i).items()}

    params, opt_state, _ = step(params, opt_state, batch(0))
    b = batch(1)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ranges = {"adamw": (adamw, "apply"), "cross_entropy_fwd": (model_mod, "cross_entropy")}
    saved = {name: getattr(mod, fn) for name, (mod, fn) in ranges.items()}

    def in_range(name, fn):
        def run(*args, **kwargs):
            with record_function(f"train:{name}"):
                return fn(*args, **kwargs)
        return run

    try:
        for name, (mod, fn) in ranges.items():
            setattr(mod, fn, in_range(name, saved[name]))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            params, opt_state, _ = step(params, opt_state, b)
            end.record()
            end.synchronize()
    finally:
        for name, (mod, fn) in ranges.items():
            setattr(mod, fn, saved[name])
    span = start.elapsed_time(end)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # A range appears on the device's timeline too, as the span from its
    # first kernel's start to its last's end; it is no kernel.
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    spans = {e.key: dev_us(e) / 1e3 for e in events if e.key.startswith("train:")}

    def range_ms(name):
        ms = spans.get(f"train:{name}", 0.0)
        return f"{ms:.1f}" if ms > 0 else "not-measured"

    kern = [e for e in events if dev_us(e) > 0 and not e.key.startswith("train:")]
    # The profiler can drop kernel records (kernel_device_ms): the launches
    # the host made (every runtime and driver launch call) against the
    # records kept say how many.
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type != DeviceType.CUDA and "LaunchKernel" in e.key)
    records = sum(e.count for e in kern)
    busy = sum(dev_us(e) for e in kern) / 1e3
    fam = dict(gemm=0.0, k4_fwd=0.0, k4_bwd=0.0)
    for e in kern:
        key = ("k4_bwd" if "attention_bwd_" in e.key else
               "k4_fwd" if "flash_attention_" in e.key else
               "gemm" if "gemm" in e.key.lower() or "splitkreduce" in e.key.lower() else None)
        if key:
            fam[key] += dev_us(e) / 1e3
    top = sorted(kern, key=dev_us, reverse=True)[:8]
    phase("train-profile", arch=cfg.name, layers=cfg.n_layers, step_span_ms=f"{span:.1f}",
          kernel_launches=launches, kernel_records=records,
          device_busy_ms=f"{busy:.1f}" if kern else "not-measured",
          idle_share=f"{1 - busy / span:.3f}" if kern else "not-measured",
          gemm_ms=f"{fam['gemm']:.1f}", k4_fwd_ms=f"{fam['k4_fwd']:.2f}",
          k4_bwd_ms=f"{fam['k4_bwd']:.2f}",
          other_ms=f"{busy - sum(fam.values()):.1f}", adamw_ms=range_ms("adamw"),
          cross_entropy_fwd_ms=range_ms("cross_entropy_fwd"),
          top=";".join(f"{e.key[:56]}={dev_us(e) / 1e3:.2f}ms/{e.count}" for e in top))
    del params, opt_state, model
    torch.cuda.empty_cache()


def train_card_vs_cpu(dev) -> None:
    """phi4-mini's full width at 2 layers with the same weights and tokens
    on the card (K4 forward and backward, cuBLAS) and on the CPU (the plain
    versions): the loss and every gradient leaf, then one AdamW step on the
    CPU's gradients given to both."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import value_and_grad

    c = TRAIN_CARD_VS_CPU
    cfg = get_config(TRAIN["arch"], n_layers=c["n_layers"])
    model = build_model(cfg, remat=True)
    on_card = model.init(2, device=dev)
    on_cpu = tree_map(lambda t: t.cpu(), on_card)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, size=(c["B"], c["T"] + 1))
    toks = toks.astype(np.int32)
    runs = []
    for params, d in ((on_card, dev), (on_cpu, torch.device("cpu"))):
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=d),
                 "labels": torch.as_tensor(toks[:, 1:], device=d)}
        loss, grads = value_and_grad(model.loss_fn, params, batch)
        runs.append((float(loss), [g.cpu() for g in tree_leaves(grads)], grads))
    (l_card, g_card, _), (l_cpu, g_cpu, grads_cpu) = runs
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(g_card, g_cpu))
    live = all(bool(torch.isfinite(a).all()) and bool((a != 0).any()) for a in g_card)
    # One AdamW step on the CPU's gradients, on both devices.
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=4)
    grads_card = tree_map(lambda g: g.to(dev), grads_cpu)
    p_card, _, m_card = adamw.apply(opt_cfg, on_card, grads_card, adamw.init(on_card))
    p_cpu, _, m_cpu = adamw.apply(opt_cfg, on_cpu, grads_cpu, adamw.init(on_cpu))
    opt_err = max(float(((a.cpu() - b).abs() / (1 + b.abs())).max())
                  for a, b in zip(tree_leaves(p_card), tree_leaves(p_cpu)))
    phase("train-card-vs-cpu", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
          B=c["B"], T=c["T"], loss_card=f"{l_card:.7f}", loss_cpu=f"{l_cpu:.7f}",
          loss_rel_diff=f"{loss_rel:.3e}", worst_leaf_rel_diff=f"{worst:.3e}",
          grad_leaves=len(g_card), all_leaves_live=live,
          grad_norm_card=f"{float(m_card['grad_norm']):.6f}",
          grad_norm_cpu=f"{float(m_cpu['grad_norm']):.6f}", adamw_max_diff=f"{opt_err:.3e}",
          loss_rtol=c["loss_rtol"], grad_tol=c["grad_tol"], opt_tol=c["opt_tol"])
    if not loss_rel <= c["loss_rtol"]:
        raise AssertionError(f"card and CPU losses differ by {loss_rel:.3e} relative")
    if not (live and worst <= c["grad_tol"]):
        raise AssertionError(f"card and CPU gradients differ by {worst:.3e} of a leaf's max")
    if not opt_err <= c["opt_tol"]:
        raise AssertionError(f"card and CPU AdamW steps differ by {opt_err:.3e}")
    del on_card, on_cpu, grads_card, p_card, p_cpu
    torch.cuda.empty_cache()


def _one_straggler(code, pats, ws, R: int):
    """A weight pattern that drops one worker's own gradient (the reference
    test's choice): from the table, else the decode weights without worker 0."""
    import numpy as np
    from repro_torch.core import gradient_coding as gc
    for pat, w in zip(pats[1:], ws[1:]):
        if len(np.flatnonzero(~pat[:R])) == 1:
            return w
    surv = np.setdiff1d(np.arange(R + code.K), [0])
    w = np.zeros(R + code.K, np.float32)
    w[surv] = gc.decode_weights(code, surv)
    return w


def coded_dp_train(dev) -> None:
    """The coded data-parallel step on the card: the reference test's setup
    (tests/test_coded_train_step.py: mistral-nemo-12b smoke, R=8, 4
    parities), the updates with no straggler and with one within 5e-5 of
    the uncoded update; then at phi4-mini's full width (2 layers) the coded
    gradient sums within 1e-5 of the uncoded sum, relative to its max."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import make_coded_train_step, value_and_grad

    c = CODED
    R = c["R"]
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant", weight_decay=0.0)

    def clone(tree):
        return tree_map(lambda x: x.clone(), tree)

    def uncoded_sum(model, params, batch):
        g = None
        for r in range(R):
            _, gi = value_and_grad(model.loss_fn, params, {k: v[r] for k, v in batch.items()})
            g = gi if g is None else tree_map(lambda a, b: a + b, g, gi)
        return g

    def batch_of(cfg, mb, T, seed):
        tok = np.random.default_rng(seed).integers(0, cfg.vocab, size=(R, mb, T)).astype(np.int32)
        t = torch.as_tensor(tok, device=dev)
        return {"tokens": t, "labels": t}

    # The reference test's setup.
    cfg = get_config("mistral-nemo-12b", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    step, code, (pats, ws) = make_coded_train_step(model, opt_cfg, R, n_parity=c["n_parity"],
                                                   seed=0, device=dev)
    batch = batch_of(cfg, c["mb"], c["T"], 1)
    gref = tree_map(lambda g: g / R, uncoded_sum(model, params, batch))
    pref, _, _ = adamw.apply(opt_cfg, clone(params), gref, adamw.init(params))
    errs = {}
    for name, w in (("no_straggler", ws[0]), ("one_straggler", _one_straggler(code, pats, ws, R))):
        p, _, m = step(clone(params), adamw.init(params), batch, w)
        errs[name] = max(float((a - b).abs().max())
                         for a, b in zip(tree_leaves(pref), tree_leaves(p)))
        errs[f"{name}_loss"] = float(m["loss"])
    phase("coded-dp-train", cfg=cfg.name, R=R, K=code.K, mb=c["mb"], T=c["T"],
          err_no_straggler=f"{errs['no_straggler']:.3e}",
          err_one_straggler=f"{errs['one_straggler']:.3e}",
          loss=f"{errs['no_straggler_loss']:.6f}", tol=c["tol"])
    if not (errs["no_straggler"] < c["tol"] and errs["one_straggler"] < c["tol"]
            and errs["no_straggler_loss"] > 0):
        raise AssertionError(f"the coded update misses the uncoded one: {errs}")

    # phi4-mini's full width at 2 layers: the gradient sums.
    cfg = get_config(TRAIN["arch"], n_layers=c["full_layers"])
    model = build_model(cfg, remat=True)
    params = model.init(3, device=dev)
    step, code, (pats, ws) = make_coded_train_step(model, opt_cfg, R, n_parity=c["n_parity"],
                                                   seed=0, device=dev)
    batch = batch_of(cfg, c["full_mb"], c["full_T"], 3)
    ref = tree_leaves(uncoded_sum(model, params, batch))
    rel = {}
    t0 = time.perf_counter()
    for name, w in (("no_straggler", ws[0]), ("one_straggler", _one_straggler(code, pats, ws, R))):
        g, _ = step.grads(params, batch, w)
        rel[name] = max(float((a - b).abs().max()) / float(b.abs().max())
                        for a, b in zip(tree_leaves(g), ref))
        del g
    torch.cuda.synchronize()
    phase("coded-dp-train", cfg=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, R=R,
          K=code.K, mb=c["full_mb"], T=c["full_T"],
          rel_err_no_straggler=f"{rel['no_straggler']:.3e}",
          rel_err_one_straggler=f"{rel['one_straggler']:.3e}", rtol=c["full_rtol"],
          wall_s=f"{time.perf_counter() - t0:.3f}")
    if not max(rel.values()) <= c["full_rtol"]:
        raise AssertionError(f"the coded gradient sum misses the uncoded one: {rel}")
    del params, ref, model
    torch.cuda.empty_cache()


# --- Checkpointing, the card's ceilings and the roofline (slice C4) ---------

# [ckpt-train]: the [train] configuration at 2 of its 32 layers (params, m
# and v in fp32 are 3 x 4 B a parameter, 9.79 GB at 2 layers, 7.4 GB of it
# the tied 200064 x 3072 embedding's three copies), 4 steps.  Run A saves at
# step 3 (the write runs in the background during step 4), run B resumes
# from it and runs step 4; a third run without a checkpoint says how far
# two uninterrupted runs repeat.  The disk must hold MIN_FREE times the
# state before anything is written.
CKPT_TRAIN = dict(n_layers=2, steps=4, every=3, min_free=2.5)
# [ceilings]: cuBLAS products of 8192^3 in fp32, TF32 and bf16, and a 4 GiB
# device-to-device copy, against the data sheet's peaks.
CEILINGS = dict(n=8192, copy_bytes=4 << 30)


def ceilings(dev) -> None:
    """What the card gives a library call: cuBLAS's fp32 (CUDA cores), TF32
    (switched on for this call only) and bf16 products at 8192^3, and a
    4 GiB copy (read and write), each beside the data sheet's peak.  None of
    these calls is on a path; they measure the card."""
    import torch
    from repro_torch.utils import roofline as rl

    n = CEILINGS["n"]
    gen = torch.Generator(device=dev).manual_seed(11)
    a = torch.randn((n, n), generator=gen, device=dev)
    b = torch.randn((n, n), generator=gen, device=dev)
    flops = 2.0 * n ** 3
    fp32_ms = time_ms(lambda: torch.mm(a, b), 5)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32_ms = time_ms(lambda: torch.mm(a, b), 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    a16, b16 = a.bfloat16(), b.bfloat16()
    bf16_ms = time_ms(lambda: torch.mm(a16, b16), 10)
    del a, b, a16, b16
    src = torch.empty(CEILINGS["copy_bytes"] // 4, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), 10)
    del src, dst
    torch.cuda.empty_cache()
    copy_gbps = 2 * CEILINGS["copy_bytes"] / copy_ms / 1e6
    phase("ceilings", n=n, fp32_ms=f"{fp32_ms:.3f}", fp32_tflops=f"{flops / fp32_ms / 1e9:.1f}",
          fp32_cores_peak_tflops=f"{rl.FP32_FLOPS / 1e12:.0f}", tf32_ms=f"{tf32_ms:.3f}",
          tf32_tflops=f"{flops / tf32_ms / 1e9:.1f}", tf32_peak_tflops=f"{rl.TF32_FLOPS / 1e12:.0f}",
          bf16_ms=f"{bf16_ms:.3f}", bf16_tflops=f"{flops / bf16_ms / 1e9:.1f}",
          bf16_peak_tflops=f"{rl.BF16_FLOPS / 1e12:.0f}", copy_gib=CEILINGS["copy_bytes"] >> 30,
          copy_ms=f"{copy_ms:.3f}", copy_gbps=f"{copy_gbps:.1f}",
          hbm_peak_gbps=f"{rl.HBM_BW / 1e9:.0f}")


def ckpt_train(dev) -> dict:
    """Training saved mid-run and resumed through ``launch/train``: the
    [train] configuration at ``CKPT_TRAIN``'s 2 layers, 4 steps.  Three
    runs, each with K4's launch counts reset just before it and exact: one
    without a checkpoint (the repeat), run A with ``--ckpt D --ckpt-every
    3`` and run B with ``--ckpt D --resume``, which must resume from step
    3.  Run A's 4 steps against the repeat's say whether two uninterrupted
    runs repeat bit for bit; run B's step 4 (loss and gradient norm) must
    equal run A's bit for bit if they do, else lie within their spread.
    Prints the loop's wait for the host copy, the background write, the
    checkpoint's GB raw and on disk, its codec and threads, the restore's
    seconds and each run's peak device memory.  Returns K4's forward and
    backward launches over runs A and B."""
    import os
    import shutil

    import torch
    from repro_torch.checkpoint import checkpoint as ckm
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.launch import train

    c, t = CKPT_TRAIN, TRAIN
    cfg = get_config(t["arch"], n_layers=c["n_layers"])
    state_gb = 3 * 4 * cfg.n_params() / 1e9
    root = ROOT / "build" / "ckpt-train"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free_gb = shutil.disk_usage(root).free / 1e9
    if free_gb < c["min_free"] * state_gb:
        shutil.rmtree(root, ignore_errors=True)
        raise AssertionError(f"{free_gb:.1f} GB free under {root}, the checkpoint test needs "
                             f"{c['min_free']} x {state_gb:.2f} GB")
    args = ["--arch", t["arch"], "--steps", str(c["steps"]), "--batch", str(t["batch"]),
            "--seq", str(t["seq"]), "--n-micro", str(t["n_micro"]), "--log-every", "1"]
    runs, info = {}, {}
    os.environ["REPRO_TRAIN_OVERRIDES"] = f"n_layers={c['n_layers']}"
    try:
        for name, extra in (("repeat", []),
                            ("A", ["--ckpt", str(root), "--ckpt-every", str(c["every"])]),
                            ("B", ["--ckpt", str(root), "--resume"])):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            k4.flash_attention_cuda.launches = k4.flash_attention_bwd_cuda.launches = 0
            res = train.run(args + extra)
            runs[name] = dict(res, fwd=k4.flash_attention_cuda.launches,
                              bwd=k4.flash_attention_bwd_cuda.launches,
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            if name == "A":
                step_dir = root / f"step_{c['every']:09d}"
                index = ckm._msgpack.unpack((step_dir / "index.msgpack").read_bytes())
                info = dict(codec=index["codec"], leaves=len(index["leaves"]),
                            raw_gb=sum(e["raw_bytes"] for e in index["leaves"].values()) / 1e9,
                            disk_gb=sum(p.stat().st_size for p in step_dir.iterdir()) / 1e9)
    finally:
        del os.environ["REPRO_TRAIN_OVERRIDES"]
        shutil.rmtree(root, ignore_errors=True)
    rep, a, b = runs["repeat"], runs["A"], runs["B"]
    for name, r in runs.items():
        steps = len(r["history"])
        calls = cfg.n_layers * t["n_micro"] * steps
        phase("ckpt-train", run=name, start=r["start"], steps_run=steps,
              losses=",".join(repr(h["loss"]) for h in r["history"]),
              grad_norms=",".join(repr(h["grad_norm"]) for h in r["history"]),
              wall_s=f"{r['wall_s']:.3f}", max_memory_allocated_gb=f"{r['peak_gb']:.3f}",
              k4_fwd_launches=r["fwd"], k4_bwd_launches=r["bwd"],
              **{k: f"{v:.3f}" for k, v in r["ckpt"].items() if v is not None})
        if r["fwd"] != 2 * calls or r["bwd"] != k4.BWD_LAUNCHES * calls:
            raise AssertionError(f"run {name}: K4 launched {r['fwd']} forwards and {r['bwd']} "
                                 f"backward kernels, expected {2 * calls} and "
                                 f"{k4.BWD_LAUNCHES * calls}")
    if b["start"] != c["every"] or len(b["history"]) != c["steps"] - c["every"]:
        raise AssertionError(f"run B started at step {b['start']}, expected {c['every']}")
    pairs = [(x["loss"], y["loss"]) for x, y in zip(a["history"], rep["history"])]
    pairs += [(x["grad_norm"], y["grad_norm"]) for x, y in zip(a["history"], rep["history"])]
    spread = max(abs(x - y) / abs(y) for x, y in pairs)
    last_a, last_b = a["history"][-1], b["history"][-1]
    diff = max(abs(last_b[k] - last_a[k]) / abs(last_a[k]) for k in ("loss", "grad_norm"))
    phase("ckpt-train", arch=cfg.name, layers=cfg.n_layers, params=cfg.n_params(),
          state_gb=f"{state_gb:.3f}", free_gb=f"{free_gb:.1f}", codec=info["codec"],
          threads=ckm.DEFAULT_THREADS, leaves=info["leaves"], raw_gb=f"{info['raw_gb']:.3f}",
          disk_gb=f"{info['disk_gb']:.3f}", disk_share=f"{info['disk_gb'] / info['raw_gb']:.3f}",
          snapshot_s=f"{a['ckpt']['snapshot_s']:.3f}", write_s=f"{a['ckpt']['write_s']:.3f}",
          write_gbps=f"{info['raw_gb'] / a['ckpt']['write_s']:.3f}",
          restore_s=f"{b['ckpt']['restore_s']:.3f}",
          restore_gbps=f"{info['raw_gb'] / b['ckpt']['restore_s']:.3f}",
          resumed_from=b["start"], repeat_bitwise=spread == 0.0, repeat_spread=f"{spread:.3e}",
          step4_loss_a=repr(last_a["loss"]), step4_loss_b=repr(last_b["loss"]),
          step4_grad_norm_a=repr(last_a["grad_norm"]), step4_grad_norm_b=repr(last_b["grad_norm"]),
          resume_diff=f"{diff:.3e}", resume_bitwise=diff == 0.0)
    if not diff <= spread:
        raise AssertionError(f"the resumed step 4 differs from run A's by {diff:.3e} relative; "
                             f"two uninterrupted runs differ by {spread:.3e}")
    torch.cuda.empty_cache()
    return dict(fwd=a["fwd"] + b["fwd"], bwd=a["bwd"] + b["bwd"])


def _roofline_line(step: str, costs, mf: float, step_s: float, **fields) -> None:
    """Print one ``[roofline]`` line: the counted costs, the terms at each
    peak of ``utils.roofline.PEAKS``, and the measured step against the
    bound at the port's fp32 convention (three TF32 products)."""
    from repro_torch.utils import roofline as rl

    terms = {p: rl.derive(costs.cost_analysis(), [], mf, peak=p) for p in rl.PEAKS}
    r = terms["fp32"]
    phase("roofline", step=step, **fields, aten_flops=f"{costs.aten_flops:.4e}",
          kernel_flops=f"{costs.kernel_flops:.4e}", aten_bytes=f"{costs.aten_bytes:.4e}",
          kernel_bytes=f"{costs.kernel_bytes:.4e}", aten_ops=costs.aten_ops,
          kernel_calls=";".join(f"{k}={v['calls']}" for k, v in sorted(costs.by_kernel.items())),
          **{f"compute_s_{p}": f"{x.compute_s:.4e}" for p, x in terms.items()},
          memory_s=f"{r.memory_s:.4e}", dominant=r.dominant, bound_s=f"{r.bound_s:.4e}",
          model_flops=f"{mf:.4e}", useful_flops_ratio=f"{r.useful_flops_ratio:.4f}",
          roofline_fraction=f"{r.roofline_fraction:.4f}", step_s=f"{step_s:.4e}",
          step_over_bound=f"{step_s / r.bound_s:.3f}",
          **{f"mfu_{p}": f"{mf / (step_s * x.peak_flops):.4f}" for p, x in terms.items()})


def roofline_train_step(dev) -> None:
    """One step of the [train] configuration (8 layers, 8 x 1024 tokens in
    2 microbatches) under ``utils.trace.StepCosts`` (aten ops and the port's
    kernels counted apart), its roofline terms, and the step's time,
    measured on the host's clock around two synchronised steps outside the
    counting (its per-op Python cost is not the step's)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import Shape
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import make_train_step
    from repro_torch.utils import roofline as rl
    from repro_torch.utils.trace import StepCosts

    c = TRAIN
    cfg = get_config(c["arch"], n_layers=c["n_layers"])
    model = build_model(cfg, remat=True)
    params = model.init(0, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=c["steps"])
    opt_state = adamw.init(params)
    step = make_train_step(model, opt_cfg, c["n_micro"], pre_shaped=True, device=dev)
    data = SyntheticLM(cfg.vocab, c["seq"], c["batch"], n_micro=c["n_micro"], seed=0)

    def batch(i):
        return {k: torch.as_tensor(v, device=dev) for k, v in data.batch(i).items()}

    params, opt_state, _ = step(params, opt_state, batch(0))
    times = []
    for i in (1, 2):
        b = batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, _ = step(params, opt_state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    b = batch(3)
    with StepCosts() as costs:
        params, opt_state, _ = step(params, opt_state, b)
        torch.cuda.synchronize()
    mf = rl.model_flops(cfg, Shape("train", "train", c["seq"], c["batch"]), 1)
    _roofline_line("train", costs, mf, sum(times) / len(times), arch=cfg.name,
                   layers=cfg.n_layers, tokens=c["batch"] * c["seq"], n_micro=c["n_micro"],
                   params=cfg.n_params(), step_s_each=",".join(f"{x:.4f}" for x in times))
    del params, opt_state, model
    torch.cuda.empty_cache()


def roofline_decode_step(model, params, toks, steps: int = 10) -> None:
    """One decode step of the [serve] path (phi4-mini at its full size, B 4,
    after a prefill of ``toks[:, :-1]``) under ``StepCosts``, its roofline
    terms, and the step's time: the mean of ``steps`` synchronised steps on
    the host's clock, outside the counting."""
    import torch
    from repro_torch.configs.shapes import Shape
    from repro_torch.utils import roofline as rl
    from repro_torch.utils.trace import StepCosts

    cache = model.init_cache(toks.shape[0], SERVE["max_len"], device=toks.device)
    with torch.no_grad():
        _, cache = model.prefill(params, toks[:, :-1], cache)
        cur = toks[:, -1:]
        logits, cache = model.decode_step(params, cur, cache)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = model.decode_step(params, cur, cache)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
        with StepCosts() as costs:
            logits, cache = model.decode_step(params, cur, cache)
            torch.cuda.synchronize()
    cfg = model.cfg
    mf = rl.model_flops(cfg, Shape("decode", "decode", SERVE["max_len"], toks.shape[0]), 1)
    _roofline_line("decode", costs, mf, step_s, arch=cfg.name, layers=cfg.n_layers,
                   batch=toks.shape[0], position=toks.shape[1] + steps, params=cfg.n_params())
    del cache, logits


# --- The other model families (slice C3) ------------------------------------------

# The serving paths of slice C3, each through ServeEngine.generate at its
# published width (configs/*.py), random weights from seed 0: (phase name,
# arch, layers (None: the published depth), request batches, prompts a
# batch, prompt tokens, new tokens, max_len, K4's launches over the run).
# recurrentgemma-2b (26 layers, 8 of them local attention with a window of
# 2048) takes prompts past its window; xlstm-350m has no attention; whisper
# reads stub frames (B, 1500, 1280) x 0.02 and its launches are the
# encoder's 32 plus the decoder's self- and cross-attention, 32 each, at the
# prefill and at every step; moonshot-v1-16b-a3b runs 16 of its 48 layers
# (2.35 GB of fp32 weights a layer: the full depth is 115.6 GB).
FAMILY_SERVE = [
    dict(name="serve-recurrentgemma", arch="recurrentgemma-2b", n_layers=None, batches=2, batch=2,
         prompt=3072, new=16, max_len=4096, k4=2 * 8 * (1 + 16)),
    dict(name="serve-xlstm", arch="xlstm-350m", n_layers=None, batches=2, batch=4, prompt=512,
         new=16, max_len=1024, k4=0),
    dict(name="serve-whisper", arch="whisper-large-v3", n_layers=None, batches=2, batch=4,
         prompt=64, new=32, max_len=128, k4=2 * (32 + 32 * 33 + 32 * 33)),
    dict(name="serve-moe", arch="moonshot-v1-16b-a3b", n_layers=16, batches=2, batch=4, prompt=512,
         new=16, max_len=1024, k4=2 * 16 * 17),
]
# K4 at the new paths' shapes (f32): (name, B, Hq, Hkv, Tq, buffer, D,
# causal, window, q_offset, tk_valid).  recurrentgemma's prefill of 3071
# tokens and a decode step in its 4096-slot buffer (MQA, 10/1 heads, D 256:
# the CUDA-core instance); whisper's encoder (non-causal, 1500 x 1500, D 64:
# the tensor cores, a 28-key tail) and its cross-attention decode step over
# the 1500 encoder keys; moonshot's MHA prefill of 511 tokens.
FA_FAMILY_SHAPES = [
    ("recurrentgemma-prefill", 2, 10, 1, 3071, 4096, 256, True, 2048, 0, 3071),
    ("recurrentgemma-decode", 2, 10, 1, 1, 4096, 256, True, 2048, 3079, 3080),
    ("whisper-encoder", 4, 20, 20, 1500, 1500, 64, False, None, 0, 1500),
    ("whisper-cross-decode", 4, 20, 20, 1, 1500, 64, False, None, 0, 1500),
    ("moonshot-prefill", 4, 16, 16, 511, 1024, 128, True, None, 0, 511),
]
# K4's backward at recurrentgemma's heads (the [families-train-card] shape:
# 1 x 256 tokens, 10/1 heads, D 256, window 2048): the CUDA-core instance.
FA_BWD_FAMILY_SHAPE = dict(B=1, Hq=10, Hkv=1, T=256, D=256, window=2048)
# The card against the CPU, teacher-forced logits (B 1, prompt 128, 4 new
# tokens) within CARD_VS_CPU's 1e-4: recurrentgemma at full width and 3
# layers (rglru, rglru, attn_local), xlstm at 2, whisper at 2 + 2, moonshot
# at 2, qwen3-moe at its smoke config (9.95 GB a layer at full width, too
# large for the CPU side).  MoE routes are compared first: a token whose
# k-th and (k+1)-th router probabilities lie within ROUTE_TIE may route
# differently; any other must not.
FAMILY_CARD_VS_CPU = [
    ("recurrentgemma-2b", dict(n_layers=3, block_pattern=("rglru", "rglru", "attn_local")),
     False),
    ("xlstm-350m", dict(n_layers=2), False),
    ("whisper-large-v3", dict(n_layers=2, n_enc_layers=2), False),
    ("moonshot-v1-16b-a3b", dict(n_layers=2), False),
    ("qwen3-moe-235b-a22b", {}, True),
]
ROUTE_TIE = 1e-6
# loss_fn(...).backward() on the card against the CPU, TRAIN_CARD_VS_CPU's
# tolerances: recurrentgemma at full width, 3 layers, 1 x 256 tokens (K4's
# D = 256 backward), the others at their smoke configs, 2 x 64 tokens.  A
# leaf whose gradient is zero in exact arithmetic (whisper's key biases: no
# RoPE, and a row's softmax ignores a constant added to its scores) is
# rounding noise: below GRAD_NOISE of the largest leaf on both devices.
FAMILY_TRAIN = [
    ("recurrentgemma-2b", dict(n_layers=3, block_pattern=("rglru", "rglru", "attn_local")),
     False, 1, 256),
    ("xlstm-350m", {}, True, 2, 64),
    ("whisper-large-v3", {}, True, 2, 64),
    ("moonshot-v1-16b-a3b", {}, True, 2, 64),
    ("qwen3-moe-235b-a22b", {}, True, 2, 64),
]
GRAD_NOISE = 1e-6


def k4_family_shapes(dev) -> list:
    """K4 at each new path's shape (FA_FAMILY_SHAPES, ``k4_at_shape``).
    Returns one row a shape for the kernels line."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for name, *shape in FA_FAMILY_SHAPES:
        row = k4_at_shape(dev, gen, f"k4-{name}-shape", *shape)
        row["shape"] = name
        rows.append({k: v for k, v in row.items() if k not in ("wgmma", "working_ctas", "sms")})
    return rows


def k4_bwd_family_shape(dev) -> dict:
    """K4's backward at FA_BWD_FAMILY_SHAPE (recurrentgemma's heads, D 256,
    ``k4_bwd_at_shape``), which runs the CUDA-core instance."""
    c = FA_BWD_FAMILY_SHAPE
    row = k4_bwd_at_shape(dev, "recurrentgemma", c["B"], c["Hq"], c["Hkv"], c["T"], c["D"],
                          c["window"])
    if row.pop("wgmma"):
        raise AssertionError("the D 256 backward ran on the tensor cores")
    return row


def serve_family(dev, spec: dict, after=None) -> int:
    """A serving path (SERVE, FAMILY_SERVE) through
    ``ServeEngine.generate``: the model at its published width on the card
    (random weights from seed 0), its request batches with K4's launches
    counted over exactly that run (they must be ``spec["k4"]``), then a
    timed prefill and decode of the first batch on the device's clock,
    whose last tokens must be generate's.  The first token must be the
    no-cache forward's argmax (not for MoE, whose capacity, and so its
    drops, depends on the tokens in the call).  Per family: recurrentgemma
    the RG-LRU scan's device ms at the prefill's shape; xlstm its cache
    bytes at max_len 1024 and 4096 (equal) and the launches of its token
    loop; moe the assignments dropped at capacity in the prefill and a
    second prefill bitwise equal.  ``after(model, params, engine, toks, rng,
    cfg)`` runs last.  Prints ``[spec["name"]]``; returns K4's launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rglru
    from repro_torch.models.transformer import block_kinds
    from repro_torch.runtime.serve_loop import ServeEngine

    over = {} if spec["n_layers"] is None else {"n_layers": spec["n_layers"]}
    cfg = get_config(spec["arch"], **over)
    B, P, new, max_len = spec["batch"], spec["prompt"], spec["new"], spec["max_len"]
    if cfg.enc_dec:
        expect = spec["batches"] * (cfg.n_enc_layers + 2 * cfg.n_layers * (1 + new))
    else:
        expect = spec["batches"] * sum(k.startswith("attn") for k in block_kinds(cfg)) * (1 + new)
    if expect != spec["k4"]:
        raise AssertionError(f"{spec['name']}: K4's launches are {expect} by the config, "
                             f"{spec['k4']} by the table")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(model, params, max_len=max_len, device=dev)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 products on the fp32 serving path")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab, size=(B, P)).astype(np.int32)
               for _ in range(spec["batches"])]
    frames = [(rng.standard_normal((B, cfg.enc_frames, cfg.d_model)) * 0.02).astype(np.float32)
              if cfg.enc_dec else None for _ in batches]

    # The path, counted.
    flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    results = [engine.generate(b, n_new=new, embeds=f) for b, f in zip(batches, frames)]
    wall = time.perf_counter() - t0
    launches = flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != spec["k4"]:
        raise AssertionError(f"K4 launched {launches} times on the {spec['name']} path, "
                             f"expected {spec['k4']}")
    for r in results:
        if not (r.shape == (B, new) and r.dtype == np.int32 and r.min() >= 0
                and r.max() < cfg.vocab):
            raise AssertionError(f"a generated batch has shape {r.shape}, range "
                                 f"[{r.min()}, {r.max()}]")

    # A timed prefill and decode of the first batch, on the device's clock.
    toks = torch.as_tensor(batches[0], device=dev)
    emb = None if frames[0] is None else torch.as_tensor(frames[0], device=dev)
    extra = {}
    if cfg.moe is not None:
        moe_mod.set_moe_opts(count_drops=True)
        moe_mod.moe_block.dropped = 0
    cache = model.init_cache(B, max_len, device=dev)
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    with torch.no_grad():
        start.record()
        first, cache = model.prefill(params, toks[:, :-1], cache, emb)
        mid.record()
        moe_mod.set_moe_opts()
        cur = toks[:, -1:]
        t1 = time.perf_counter()
        for _ in range(new):
            logits, cache = model.decode_step(params, cur, cache)
            cur = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        enqueue = time.perf_counter() - t1
        end.record()
        end.synchronize()
        decode_wall = time.perf_counter() - t1
    prefill_ms = start.elapsed_time(mid)
    decode_ms = mid.elapsed_time(end) / new
    cache_gb = _state_bytes(cache) / 1e9
    if not torch.equal(cur[:, 0].cpu(), torch.as_tensor(results[0][:, -1])):
        raise AssertionError("the timed decode's last tokens differ from generate's")
    del cache, logits
    if cfg.moe is not None:
        extra["dropped_at_capacity"] = int(moe_mod.moe_block.dropped)
        extra["assignments"] = (P - 1) * B * cfg.n_layers * cfg.moe.top_k
        moe_mod.moe_block.dropped = 0
        with torch.no_grad():
            again, _ = model.prefill(params, toks[:, :-1],
                                     model.init_cache(B, max_len, device=dev), emb)
        extra["prefill_bitwise_repeat"] = bool(torch.equal(first, again))
        if not extra["prefill_bitwise_repeat"]:
            raise AssertionError("two MoE prefills differ")
        extra["first_token"] = "not-compared:moe-capacity-depends-on-the-call"
        del again
    else:
        # First generated token == argmax of the no-cache forward's last logits.
        with torch.no_grad():
            fwd = model.forward(params, toks, emb)[:, -1]
        expect_first = torch.argmax(fwd, dim=-1).cpu().numpy()
        del fwd
        if not np.array_equal(results[0][:, 0], expect_first):
            raise AssertionError(f"first tokens {results[0][:, 0]} != forward argmax "
                                 f"{expect_first}")
        extra["first_token"] = "forward-argmax"
    if spec["name"] == "serve-recurrentgemma":
        u = torch.randn((B, P - 1, cfg.lru_width), generator=torch.Generator(device=dev)
                        .manual_seed(3), device=dev)
        mixer = params["blocks"][0]["mixer"]
        scan_ms = time_ms(lambda: rglru._rglru_scan(u, mixer, None), 5)
        n_rg = sum(k == "rglru" for k in block_kinds(cfg))
        extra.update(rglru_scan_ms=f"{scan_ms:.3f}", rglru_layers=n_rg,
                     rglru_scan_ms_per_prefill=f"{scan_ms * n_rg:.2f}")
        del u
    if spec["name"] == "serve-xlstm":
        b1 = _state_bytes(model.init_cache(B, 1024, device=dev))
        b4 = _state_bytes(model.init_cache(B, 4096, device=dev))
        extra.update(cache_bytes_max_len_1024=b1, cache_bytes_max_len_4096=b4,
                     **xlstm_launches(model, params, toks))
        if b1 != b4:
            raise AssertionError(f"xLSTM's cache grows with max_len: {b1} -> {b4}")
    n_tok = sum(r.size for r in results)
    phase(spec["name"], arch=cfg.name, layers=cfg.n_layers,
          enc_layers=cfg.n_enc_layers or None, d_model=cfg.d_model,
          heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", head_dim=cfg.head_dim_, d_ff=cfg.d_ff,
          vocab=cfg.vocab, dtype=cfg.param_dtype, params=cfg.n_params(),
          weights_gb=f"{_gb(params):.3f}", cache_gb=f"{cache_gb:.3f}",
          max_memory_allocated_gb=f"{peak:.3f}", init_s=f"{init_s:.2f}",
          batches=spec["batches"], batch=B, prompt=P, new_tokens=new, max_len=max_len,
          wall_s=f"{wall:.3f}", tokens_per_s=f"{n_tok / wall:.1f}",
          prefill_ms=f"{prefill_ms:.2f}", decode_ms_per_step=f"{decode_ms:.3f}",
          decode_enqueue_ms_per_step=f"{enqueue * 1e3 / new:.3f}",
          decode_wall_ms_per_step=f"{decode_wall * 1e3 / new:.3f}", k4_launches=launches,
          **extra)
    if after is not None:
        after(model, params, engine, toks, rng, cfg)
    del engine, params, model, first
    torch.cuda.empty_cache()
    return launches


def xlstm_launches(model, params, toks, n: int = 16) -> dict:
    """The kernel launches of xLSTM's token loop: torch.profiler over a
    prefill of ``n`` tokens, the launches a token (all layers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    B = toks.shape[0]
    with torch.no_grad():
        model.prefill(params, toks[:, :n], model.init_cache(B, 64, device=toks.device))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.prefill(params, toks[:, :n], model.init_cache(B, 64, device=toks.device))
            torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    return dict(launches_per_prefill_token=f"{launches / n:.0f}")


def _route_recorder():
    """Wrap ``moe.route`` so every call's router probabilities and top-k
    experts are kept (on the CPU), call by call."""
    from repro_torch.models import moe as moe_mod

    calls, inner = [], moe_mod.route

    def route(params, xf, cfg):
        probs, top_w, top_e = inner(params, xf, cfg)
        calls.append((probs.detach().cpu(), top_e.detach().cpu()))
        return probs, top_w, top_e

    return calls, route, inner


def families_card_vs_cpu(dev) -> None:
    """FAMILY_CARD_VS_CPU: the same weights on the card (K4, cuBLAS) and on
    the CPU (the plain version): prefill, then the logits of every decode
    step teacher-forced with the card's tokens, within CARD_VS_CPU's
    tolerance.  For MoE the routes are compared first, call by call
    (each layer's prefill and decode steps): the tokens whose k-th and
    (k+1)-th router probabilities (the CPU's) lie within ROUTE_TIE are
    counted; any other token routed to another expert set fails; a step's
    logits are compared only while every route so far agrees."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import tree_map
    from repro_torch.runtime.serve_loop import ServeEngine

    c = CARD_VS_CPU
    for arch, over, smoke in FAMILY_CARD_VS_CPU:
        cfg = get_config(arch, smoke=smoke, **over)
        model = build_model(cfg)
        on_card = model.init(1, device=dev)
        on_cpu = tree_map(lambda t: t.cpu(), on_card)
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, cfg.vocab, size=(c["B"], c["prompt"])).astype(np.int32)
        frames = ((rng.standard_normal((c["B"], cfg.enc_frames, cfg.d_model)) * 0.02)
                  .astype(np.float32) if cfg.enc_dec else None)
        max_len = c["prompt"] + c["new"]
        toks_card = ServeEngine(model, on_card, max_len=max_len, device=dev).generate(
            prompt, c["new"], embeds=frames)
        forced = np.concatenate([prompt[:, -1:], toks_card[:, :-1]], axis=1)
        runs, routes = [], []
        for params, d in ((on_card, dev), (on_cpu, torch.device("cpu"))):
            calls, route, inner = _route_recorder()
            moe_mod.route = route
            try:
                with torch.no_grad():
                    emb = None if frames is None else torch.as_tensor(frames, device=d)
                    cache = model.init_cache(c["B"], max_len, device=d)
                    logits, cache = model.prefill(params, torch.as_tensor(prompt[:, :-1],
                                                                          device=d), cache, emb)
                    steps, marks = [logits.cpu()], [len(calls)]
                    for t in range(c["new"]):
                        logits, cache = model.decode_step(
                            params, torch.as_tensor(forced[:, t:t + 1], device=d), cache)
                        steps.append(logits.cpu())
                        marks.append(len(calls))
            finally:
                moe_mod.route = inner
            runs.append(steps)
            routes.append((calls, marks))
        (calls_card, marks), (calls_cpu, _) = routes
        ties = differ = 0
        agree_until = len(calls_card)
        k = cfg.moe.top_k if cfg.moe is not None else 0
        for i, ((_, e_card), (p_cpu, e_cpu)) in enumerate(zip(calls_card, calls_cpu)):
            top = torch.sort(p_cpu, dim=-1, descending=True).values
            tie = (top[:, k - 1] - top[:, k]) <= ROUTE_TIE
            same = torch.equal(torch.sort(e_card, -1).values, torch.sort(e_cpu, -1).values)
            rows_differ = (torch.sort(e_card, -1).values != torch.sort(e_cpu, -1).values).any(-1)
            ties += int(tie.sum())
            differ += int(rows_differ.sum())
            if bool((rows_differ & ~tie).any()):
                raise AssertionError(f"{arch}: a token without a near-tie routes differently "
                                     f"on the card and on the CPU (call {i})")
            if not same:
                agree_until = min(agree_until, i)
        worst, scale, compared = 0.0, 0.0, 0
        for s, (a, b) in enumerate(zip(*runs)):
            if cfg.moe is not None and marks[s] > agree_until:
                continue
            compared += 1
            worst = max(worst, float((a - b).abs().max()))
            scale = max(scale, float(b.abs().max()))
            if not torch.allclose(a, b, rtol=c["rtol"], atol=c["atol"]):
                raise AssertionError(f"{arch}: card and CPU logits differ by {worst:.3e}")
        phase("families-card-vs-cpu", arch=cfg.name, smoke=smoke, layers=cfg.n_layers,
              enc_layers=cfg.n_enc_layers or None, d_model=cfg.d_model, B=c["B"],
              prompt=c["prompt"], new_tokens=c["new"], steps_compared=f"{compared}/{len(runs[0])}",
              max_abs_logit_diff=f"{worst:.3e}", max_abs_logit=f"{scale:.3f}",
              rtol=c["rtol"], atol=c["atol"],
              **({} if cfg.moe is None else dict(route_calls=len(calls_card),
                                                 near_ties=ties, routed_differently=differ,
                                                 route_tie=ROUTE_TIE)))
        if compared < 1:
            raise AssertionError(f"{arch}: no step's routes agree")
        del on_card, on_cpu
        torch.cuda.empty_cache()


def families_train_card(dev) -> None:
    """FAMILY_TRAIN: ``loss_fn(...).backward()`` (through
    ``train_loop.value_and_grad``) on the card against the CPU with the
    same weights and tokens: the loss within TRAIN_CARD_VS_CPU's 1e-5
    relative, each gradient leaf within its 1e-4 of the leaf's max |.| (a
    leaf below GRAD_NOISE of the largest: below it on both), every leaf
    finite and live on the card; K4's backward must run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.runtime.train_loop import value_and_grad

    c = TRAIN_CARD_VS_CPU
    for arch, over, smoke, B, T in FAMILY_TRAIN:
        cfg = get_config(arch, smoke=smoke, **over)
        model = build_model(cfg)
        on_card = model.init(4, device=dev)
        on_cpu = tree_map(lambda t: t.cpu(), on_card)
        rng = np.random.default_rng(4)
        toks = rng.integers(0, cfg.vocab, size=(B, T + 1)).astype(np.int32)
        frames = ((rng.standard_normal((B, cfg.enc_frames, cfg.d_model)) * 0.02)
                  .astype(np.float32) if cfg.enc_dec else None)
        runs = []
        k4.flash_attention_bwd_cuda.launches = 0
        for params, d in ((on_card, dev), (on_cpu, torch.device("cpu"))):
            batch = {"tokens": torch.as_tensor(toks[:, :-1], device=d),
                     "labels": torch.as_tensor(toks[:, 1:], device=d),
                     "embeds": None if frames is None else torch.as_tensor(frames, device=d)}
            loss, grads = value_and_grad(model.loss_fn, params, batch)
            runs.append((float(loss), [g.cpu() for g in tree_leaves(grads)]))
            del grads
        bwd = k4.flash_attention_bwd_cuda.launches
        (l_card, g_card), (l_cpu, g_cpu) = runs
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        top = max(float(b.abs().max()) for b in g_cpu)
        worst, noise = 0.0, 0
        for a, b in zip(g_card, g_cpu):
            m = float(b.abs().max())
            if m < GRAD_NOISE * top:
                noise += 1
                if not float(a.abs().max()) < GRAD_NOISE * top:
                    raise AssertionError(f"{arch}: a noise leaf is {float(a.abs().max()):.3e} "
                                         "on the card")
                continue
            worst = max(worst, float((a - b).abs().max()) / m)
        live = all(bool(torch.isfinite(a).all()) for a in g_card) and all(
            bool((a != 0).any()) for a, b in zip(g_card, g_cpu)
            if float(b.abs().max()) >= GRAD_NOISE * top)
        phase("families-train-card", arch=cfg.name, smoke=smoke, layers=cfg.n_layers,
              d_model=cfg.d_model, B=B, T=T, loss_card=f"{l_card:.7f}", loss_cpu=f"{l_cpu:.7f}",
              loss_rel_diff=f"{loss_rel:.3e}", worst_leaf_rel_diff=f"{worst:.3e}",
              grad_leaves=len(g_card), noise_leaves=noise, all_leaves_live=live,
              k4_bwd_launches=bwd, loss_rtol=c["loss_rtol"], grad_tol=c["grad_tol"])
        if not loss_rel <= c["loss_rtol"]:
            raise AssertionError(f"{arch}: card and CPU losses differ by {loss_rel:.3e}")
        if not (live and worst <= c["grad_tol"]):
            raise AssertionError(f"{arch}: card and CPU gradients differ by {worst:.3e} of a "
                                 "leaf's max, or a leaf is dead or not finite")
        has_attn = cfg.enc_dec or any(k.startswith("attn") for k in cfg.block_pattern)
        if has_attn and bwd < k4.BWD_LAUNCHES:
            raise AssertionError(f"{arch}: K4's backward did not run")
        del on_card, on_cpu, runs
        torch.cuda.empty_cache()


# --- The C3P paths over several devices and ranks (slice C5a) ---------------

# [engine-shard]: FIG3[1] (N=100, R=2000) with 202 reps (not a multiple of
# the 4 slices) on four slices of the one card, CCP and rateless CCP (the
# decoder in the loop); the fleet at tests/test_fleet.py:436's config (6
# helpers, 3 striped tenants of 3, churn, GE loss, a fixed RTT), 11 reps.
ENGINE_SHARD = dict(R=2000, reps=202, slices=4, policies=("ccp", "rateless_ccp"),
                    fleet_reps=11, fleet_R=30)
# [ranks-train]: 4 ranks on the one card (gloo: NCCL refuses two ranks on
# one device), phi4-mini at its published width, n_layers cut from 32 to 1:
# at [ckpt-train]'s 2 layers (params, gradients, m and v 13 GB a rank) the
# four ranks ran out of the card's 80 GB in the coded step, where the rank
# holding the parity keeps its own gradient while it differentiates the
# parity's 4 sequences and each rank's backward through the tied 200064 x
# 3072 embedding adds 2.46 GB temporaries; a global
# batch of 4 x 512 synthetic tokens, one sequence a rank; 2 data-parallel
# steps, then 2 coded-DP steps (R=4 workers, K=1 parity) from the same
# init.  The DP loss within 1e-5 relative of the one-process step's on the
# same batch and each gradient leaf within 1e-4 of its max |g| (the port's
# card-vs-CPU tolerances); the coded update within 5e-5 of the uncoded one
# and its gradient sum within 1e-5 of R times the DP mean, relative to the
# leaf's max (tests/test_coded_train_step.py's and [coded-dp-train]'s):
# with no straggler (every parity weight 0: the sum is the workers' own
# gradients) and, outside the counted runs, with one (a worker's own
# gradient dropped and decoded from the parity).
RANKS_TRAIN = dict(world=4, n_layers=1, batch=4, seq=512, steps=2, n_parity=1, seed=5,
                   lr=1e-3, loss_rtol=1e-5, grad_tol=1e-4, update_tol=5e-5, sum_rtol=1e-5,
                   timeout_s=600)


def shard_data_plane(dev) -> dict:
    """MAIN's coded matmul over a mesh of 8 shards, all on the one card
    (``run(plan, a, x, mesh=make_host_mesh(model=8, devices=[dev] * 8))``):
    one K1 launch a shard, the output against the one-launch run, then the
    collector's ``recover`` from 7 survivors for each of the 7 losses that
    peel (K3), the error against A X in fp64 (limit 1e-4).  K1's and K3's
    counts are reset just before the run and read after the recoveries.
    Then, outside the counted run, each shard's launch timed by events
    beside its bound, and the whole sharded run beside the one launch.
    Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.core import coded_matmul as cm
    from repro_torch.core import fountain
    from repro_torch.kernels.coded_matmul import coded_matmul_cuda
    from repro_torch.kernels.coded_matmul.kernel import coded_matmul_costs
    from repro_torch.kernels.lt_decode import lt_decode_plan_cuda
    from repro_torch.launch import mesh

    n = MAIN["n_shards"]
    plan = cm.plan_coded_matmul(rows=MAIN["rows"], n_shards=n, overhead=MAIN["overhead"],
                                bm=MAIN["bm"])
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((MAIN["rows"], MAIN["k_dim"]), generator=gen, device=dev)
    x = torch.randn((MAIN["k_dim"], MAIN["n_dim"]), generator=gen, device=dev)
    grid = mesh.make_host_mesh(model=n, devices=[dev] * n)
    y64 = a.double() @ x.double()
    scale = float(y64.abs().max())

    def survivors(lost):
        return np.array([s for s in range(n) if s != lost])

    peel = [lost for lost in range(n)
            if (fp := fountain.peel_decode_plan(
                plan.code, np.concatenate([plan.placement[s] for s in survivors(lost)])))
            is not None and fp.n_peeled > 0]
    torch.cuda.synchronize()
    coded_matmul_cuda.launches = lt_decode_plan_cuda.launches = 0
    out = cm.run(plan, a, x, mesh=grid)
    rel = {}
    for lost in peel:
        y = cm.recover(plan, out, survivors(lost))
        rel[lost] = float((y.double() - y64).abs().max()) / scale
        del y
    torch.cuda.synchronize()
    k1, k3 = coded_matmul_cuda.launches, lt_decode_plan_cuda.launches
    one = cm.run(plan, a, x)
    bitwise = bool(torch.equal(out, one))
    diff = float((out - one).abs().max())
    del one
    worst = max(rel.values())
    phase("shard-data-plane", shape=f"{MAIN['rows']}x{MAIN['k_dim']}x{MAIN['n_dim']}",
          shards=n, devices=",".join(str(d) for d in grid.axis_devices("model")),
          k1_launches=k1, k3_launches=k3, peeling_losses=len(peel),
          bitwise_one_launch=bitwise, max_abs_diff_one_launch=f"{diff:.3e}",
          worst_rel_err_fp64=f"{worst:.3e}",
          rel_errs=",".join(f"{rel[s]:.3e}" for s in peel))
    if k1 != n:
        raise AssertionError(f"the sharded run launched K1 {k1} times for {n} shards")
    if k3 != len(peel):
        raise AssertionError(f"the collector launched K3 {k3} times for {len(peel)} peeling "
                             "recoveries")
    if not diff <= 1e-4:
        raise AssertionError(f"the sharded output differs from the one launch by {diff:.3e}")
    if not worst <= 1e-4:
        raise AssertionError(f"recovery error {worst:.3e} > 1e-4 against A X in fp64")
    # Each shard's launch (C=5 blocks of 256 rows) by events, beside its
    # bound: A (all of it, as K1's bound counts), X and the shard's output
    # once, and its products as three TF32 products.
    idx, w = cm.device_blocks(plan, a)
    per, d_max = idx.shape[0] // n, idx.shape[1]
    (k, n_dim), R = x.shape, a.shape[0] // plan.bm
    shard_ms = []
    for s in range(n):
        idx_s, w_s = idx[s * per:(s + 1) * per].contiguous(), w[s * per:(s + 1) * per].contiguous()
        ms = time_ms(lambda: coded_matmul_cuda(a, x, idx_s, w_s, plan.bm), 10)
        products, nbytes = coded_matmul_costs(R, plan.bm, k, n_dim, per, d_max, 4)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 3 * products / TF32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        shard_ms.append(ms)
        phase("shard-data-plane", shard=s, C=per, parity_blocks=int(((w_s != 0).sum(1) > 1).sum()),
              k1_ms=f"{ms:.4f}", bound_ms=f"{bound:.4f}",
              bound_by="bytes" if t_bytes >= t_ops else "operations",
              share_of_bound=f"{bound / ms:.3f}")
    sharded_ms = time_ms(lambda: cm.run(plan, a, x, mesh=grid), 5)
    one_ms = time_ms(lambda: cm.run(plan, a, x), 5)
    phase("shard-data-plane", sum_of_shards_ms=f"{sum(shard_ms):.4f}",
          sharded_run_ms=f"{sharded_ms:.4f}", one_launch_run_ms=f"{one_ms:.4f}",
          ratio=f"{sharded_ms / one_ms:.3f}")
    del a, x, y64, out
    torch.cuda.empty_cache()
    return dict(k1=k1, k3=k3)


def engine_shard(dev) -> None:
    """``Engine(shard=True, devices=[dev] * 4)`` at FIG3[1] with 202 reps
    (padded to 204, then dropped) for CCP and rateless CCP, and
    ``run_fleet(shard=True)`` at tests/test_fleet.py:436's config with 11
    reps: every result bit for bit the unsharded run's on the card (NaN
    equal to NaN), each run's wall time on the host's clock."""
    import torch
    from repro_torch.configs.ccp_paper import FIG3
    from repro_torch.core import engine, fleet, simulator

    c = ENGINE_SHARD
    devs = [dev] * c["slices"]
    before = _kernel_launches()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def check(label, one, sharded):
        d1, d2 = one.as_dict(), sharded.as_dict()
        if d1["M"] != d2["M"] or sorted(d1) != sorted(d2):
            raise AssertionError(f"{label}: M or keys differ between the sharded and one run")
        _equal_or_raise(label, {k: v for k, v in d2.items() if k != "M"},
                        {k: v.cpu() for k, v in d1.items() if k != "M"},
                        [k for k in d1 if k != "M"])

    for pol in c["policies"]:
        one, wall_one = timed(lambda: engine.Engine(device=dev).run(FIG3[1], pol, c["reps"],
                                                                    c["R"]))
        sharded, wall_sh = timed(lambda: engine.Engine(device=dev, shard=True, devices=devs).run(
            FIG3[1], pol, c["reps"], c["R"]))
        check(f"engine-shard {pol}", one, sharded)
        phase("engine-shard", cfg="FIG3[1]", policy=pol, R=c["R"], reps=c["reps"],
              slices=c["slices"], M=sharded.M, bitwise=True, all_valid=bool(sharded.valid.all()),
              T_mean=f"{float(sharded.T.mean()):.6f}", wall_one_s=f"{wall_one:.3f}",
              wall_sharded_s=f"{wall_sh:.3f}")
    ch = simulator.ChurnConfig(period=5.0, p_down=0.15, p_slow=0.25, drop_prob=0.05,
                               ge_p_bad=0.03, ge_p_good=0.25, ge_loss_bad=0.5,
                               rtt_dist="fixed", rtt_mean=0.5, max_backoff=8.0)
    cfg = simulator.ScenarioConfig(N=6, scenario=1, churn=ch)
    fc = fleet.FleetConfig(n_tasks=3, placement="striped", helpers_per_task=3)
    eng = engine.Engine(device=dev, devices=devs)
    one, wall_one = timed(lambda: eng.run_fleet(cfg, "ccp", c["fleet_reps"], c["fleet_R"],
                                                fleet=fc))
    sharded, wall_sh = timed(lambda: eng.run_fleet(cfg, "ccp", c["fleet_reps"], c["fleet_R"],
                                                   fleet=fc, shard=True))
    check("engine-shard fleet", one, sharded)
    _no_kernel_between(before, "engine-shard")
    phase("engine-shard", cfg="test_fleet.py:436 (N=6, 3 striped tenants, churn)", policy="ccp",
          R=c["fleet_R"], reps=c["fleet_reps"], slices=c["slices"], M=sharded.M, bitwise=True,
          wall_one_s=f"{wall_one:.3f}", wall_sharded_s=f"{wall_sh:.3f}")


def _ranks_train_rank(rank: int, world: int, store: str, device: str) -> dict:
    """One rank of [ranks-train] on ``device``: returns its backend, the
    comparisons (rank 0), the all-reduce's seconds, each step's loss and
    seconds, and K4's launches in the data-parallel and coded steps."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import _device
    from repro_torch.configs import get_config
    from repro_torch.core import gradient_coding
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.launch import mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives
    from repro_torch.runtime.train_loop import (accumulate_grads, make_coded_train_step,
                                                make_train_step)

    c = RANKS_TRAIN
    dev = torch.device(device)
    _device.full_fp32_matmuls(dev)
    group = mesh.init_ranks(rank, world, device=dev, store_path=store, timeout_s=c["timeout_s"])
    cfg = get_config(TRAIN["arch"], n_layers=c["n_layers"])
    model = build_model(cfg, remat=True)
    opt = adamw.AdamWConfig(lr=c["lr"], warmup_steps=0, schedule="constant", weight_decay=0.0)
    data = SyntheticLM(cfg.vocab, c["seq"], c["batch"], n_micro=1, seed=c["seed"])
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in data.batch(s).items()}
               for s in range(c["steps"])]

    def as_workers(b):  # (1, 4, T) -> the coded step's (R, 1, T)
        return {k: v.reshape(world, -1, v.shape[-1]) for k, v in b.items()}

    def sync():
        torch.cuda.synchronize(dev)
        dist.barrier(group)

    out = dict(rank=rank, backend=dist.get_backend(group), params=cfg.n_params(),
               layers=cfg.n_layers)
    # Each all-reduce the steps make (collectives.all_reduce_tree), timed on
    # the host's clock between two synchronisations.
    ar_s, all_reduce_tree = [], collectives.all_reduce_tree

    def timed_all_reduce(tree, group=None, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        all_reduce_tree(tree, group, **kw)
        torch.cuda.synchronize(dev)
        ar_s.append(time.perf_counter() - t0)
        return tree

    collectives.all_reduce_tree = timed_all_reduce
    dp = make_train_step(model, opt, 1, pre_shaped=True, device=dev, group=group)
    coded, code, (pats, ws) = make_coded_train_step(model, opt, world, n_parity=c["n_parity"],
                                                    seed=0, device=dev, group=group)
    # 1. Gradients at the init: the DP mean against the one-process step on
    # the whole batch (rank 0), the coded sum against R times the DP mean.
    params = model.init(c["seed"], device=dev)
    g_dp, l_dp = dp.grads(params, batches[0])
    if rank == 0:
        g_one, l_one = accumulate_grads(model, params, batches[0])
        out["loss_dp"], out["loss_one"] = float(l_dp), float(l_one)
        out["grad_err"] = max(float((a - b).abs().max()) / float(b.abs().max())
                              for a, b in zip(tree_leaves(g_dp), tree_leaves(g_one)))
        del g_one
    # The coded sum with no straggler (the parity weights 0) and with one
    # (a worker's own gradient dropped, the parity's decode weight in).
    w_one = _one_straggler(code, pats, ws, world)
    for name, wv in (("sum_err", ws[0]), ("sum_err_one", w_one)):
        g_c, l_c = coded.grads(params, as_workers(batches[0]), wv)
        out[name] = max(float((a - world * b).abs().max()) / float((world * b).abs().max())
                        for a, b in zip(tree_leaves(g_c), tree_leaves(g_dp)))
        out["grad_bytes"] = sum(g.numel() * g.element_size() for g in tree_leaves(g_c))
        del g_c
        torch.cuda.empty_cache()
    out["dropped"] = int(np.flatnonzero(w_one[:world] == 0)[0])
    del g_dp
    torch.cuda.empty_cache()
    # 2. The path: 2 DP steps, then 2 coded steps from the same init, K4's
    # counts reset just before each run.
    for name in ("dp", "coded"):
        if name == "coded":
            params = model.init(c["seed"], device=dev)
        state = adamw.init(params)
        sync()
        k4.flash_attention_cuda.launches = k4.flash_attention_bwd_cuda.launches = 0
        losses, secs, first_ar = [], [], len(ar_s)
        for s in range(c["steps"]):
            sync()
            t0 = time.perf_counter()
            if name == "dp":
                params, state, m = dp(params, state, batches[s])
            else:
                params, state, m = coded(params, state, as_workers(batches[s]), ws[0])
            losses.append(float(m["loss"]))
            torch.cuda.synchronize(dev)
            secs.append(time.perf_counter() - t0)
            if s == 0 and rank == 0:
                if name == "dp":
                    host = [p.to("cpu", copy=True) for p in tree_leaves(params)]
                else:
                    out["update_err"] = max(float((a.cpu() - b).abs().max())
                                            for a, b in zip(tree_leaves(params), host))
        out[name] = dict(losses=losses, step_s=secs, all_reduce_s=ar_s[first_ar:],
                         fwd=k4.flash_attention_cuda.launches,
                         bwd=k4.flash_attention_bwd_cuda.launches)
        del params, state
        torch.cuda.empty_cache()
    # 3. Outside the counted runs: one coded step from the init with one
    # straggler, against the first DP update.
    params = model.init(c["seed"], device=dev)
    params, state, _ = coded(params, adamw.init(params), as_workers(batches[0]), w_one)
    if rank == 0:
        out["update_err_one"] = max(float((a.cpu() - b).abs().max())
                                    for a, b in zip(tree_leaves(params), host))
        del host
    del params, state
    torch.cuda.empty_cache()
    # Worker `rank`'s parity (the first k with k % R == rank): its forwards.
    nbrs = [len(n) for k, n in enumerate(gradient_coding.parity_assignments(code))
            if k % world == rank][:1]
    out["coded_forwards"] = 1 + (nbrs[0] if nbrs else 0)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    dist.destroy_process_group()
    return out


def ranks_train(dev) -> dict:
    """Training across 4 ``torch.distributed`` ranks spawned on the one
    card (``launch.mesh.spawn_ranks``, a FileStore rendezvous), each with
    phi4-mini at full width and 1 layer: the backend each rank took, the
    DP gradient and loss against the one-process step, the coded gradient
    sum and update against the uncoded ones, 2 DP and 2 coded steps with
    their losses and times, the gradient all-reduce's time, and K4's
    forward and backward launches in each rank, which must be exact.
    Returns the launches summed over the ranks."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.launch import mesh

    c = RANKS_TRAIN
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh.spawn_ranks(_ranks_train_rank, c["world"], str(dev), timeout_s=c["timeout_s"])
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    L, steps = r0["layers"], c["steps"]
    loss_rel = abs(r0["loss_dp"] - r0["loss_one"]) / abs(r0["loss_one"])
    for r in ranks:
        ar = r["dp"]["all_reduce_s"] + r["coded"]["all_reduce_s"]
        phase("ranks-train", rank=r["rank"], backend=r["backend"],
              dp_losses=",".join(f"{v:.6f}" for v in r["dp"]["losses"]),
              dp_step_s=",".join(f"{v:.3f}" for v in r["dp"]["step_s"]),
              dp_all_reduce_s=",".join(f"{v:.3f}" for v in r["dp"]["all_reduce_s"]),
              coded_losses=",".join(f"{v:.6f}" for v in r["coded"]["losses"]),
              coded_step_s=",".join(f"{v:.3f}" for v in r["coded"]["step_s"]),
              coded_all_reduce_s=",".join(f"{v:.3f}" for v in r["coded"]["all_reduce_s"]),
              all_reduce_share=f"{sum(ar) / sum(r['dp']['step_s'] + r['coded']['step_s']):.3f}",
              all_reduce_gbps=f"{r['grad_bytes'] / min(ar) / 1e9:.2f}",
              k4_fwd=f"{r['dp']['fwd']}+{r['coded']['fwd']}",
              k4_bwd=f"{r['dp']['bwd']}+{r['coded']['bwd']}",
              coded_forwards=r["coded_forwards"], peak_gb=f"{r['peak_gb']:.2f}")
    phase("ranks-train", arch=TRAIN["arch"], layers=L, params=r0["params"], world=c["world"],
          backend=r0["backend"], staging="gloo's own (CUDA tensors given to all_reduce)",
          global_batch=f"{c['batch']}x{c['seq']}", grad_gb=f"{r0['grad_bytes'] / 1e9:.3f}",
          loss_dp=f"{r0['loss_dp']:.7f}", loss_one=f"{r0['loss_one']:.7f}",
          loss_rel_diff=f"{loss_rel:.3e}", worst_leaf_rel_diff=f"{r0['grad_err']:.3e}",
          coded_sum_rel_err=f"{max(r['sum_err'] for r in ranks):.3e}",
          coded_update_err=f"{r0['update_err']:.3e}", straggler=r0["dropped"],
          coded_sum_one_rel_err=f"{max(r['sum_err_one'] for r in ranks):.3e}",
          coded_update_one_err=f"{r0['update_err_one']:.3e}", wall_s=f"{wall:.3f}",
          loss_rtol=c["loss_rtol"], grad_tol=c["grad_tol"], sum_rtol=c["sum_rtol"],
          update_tol=c["update_tol"])
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError("ranks sharing one card must run gloo")
    if not loss_rel <= c["loss_rtol"]:
        raise AssertionError(f"the DP loss differs by {loss_rel:.3e} from the one-process one")
    if not r0["grad_err"] <= c["grad_tol"]:
        raise AssertionError(f"the DP gradient misses the one-process one by {r0['grad_err']:.3e}")
    for sfx, label in (("", "no straggler"), ("_one", "one straggler")):
        if not max(r["sum_err" + sfx] for r in ranks) <= c["sum_rtol"]:
            raise AssertionError(f"the coded gradient sum ({label}) misses R times the DP mean")
        if not r0["update_err" + sfx] <= c["update_tol"]:
            raise AssertionError(f"the coded update ({label}) misses the uncoded one by "
                                 f"{r0['update_err' + sfx]:.3e}")
    for r in ranks:
        if not all(np.isfinite(v) for v in r["dp"]["losses"] + r["coded"]["losses"]):
            raise AssertionError(f"rank {r['rank']}: a loss is not finite")
        if r["dp"]["losses"] != r0["dp"]["losses"] or r["coded"]["losses"] != r0["coded"]["losses"]:
            raise AssertionError(f"rank {r['rank']}'s losses differ from rank 0's")
        want = {"dp": L * steps, "coded": L * steps * r["coded_forwards"]}
        for name, calls in want.items():
            if (r[name]["fwd"], r[name]["bwd"]) != (2 * calls, k4.BWD_LAUNCHES * calls):
                raise AssertionError(
                    f"rank {r['rank']} {name}: K4 launched {r[name]['fwd']} forwards and "
                    f"{r[name]['bwd']} backward kernels, expected {2 * calls} and "
                    f"{k4.BWD_LAUNCHES * calls}")
    return dict(fwd=sum(r[n]["fwd"] for r in ranks for n in ("dp", "coded")),
                bwd=sum(r[n]["bwd"] for r in ranks for n in ("dp", "coded")))


# [tp-train]: the tensor-parallel LM (slice C5b) on 4 ranks of the one card
# (gloo), mesh (data 2, model 2): phi4-mini-3.8b at its published width,
# n_layers cut from 32 to 2 (params, gradients and ZeRO-1 m and v about 4.9
# GB a rank; four ranks share the card and gloo stages every collective
# through the host); a global batch of 4 x 512 synthetic tokens, 2 AdamW
# steps, remat on.  The first step's loss within 1e-5 relative of the
# one-process step's on the card from the same weights, and each gradient
# leaf within 1e-4 of its max |g| (the port's card-vs-CPU anchors); the
# second step's loss within 1e-4 relative (AdamW carries the first step's
# rounding).  K4's launches in each rank exact, on 12 q / 4 kv heads.
TP_TRAIN = dict(world=4, mesh=(2, 2), n_layers=2, batch=4, seq=512, steps=2, seed=5, lr=1e-3,
                loss_rtol=1e-5, loss2_rtol=1e-4, grad_tol=1e-4, timeout_s=600)
# [moe-a2a]: moonshot-v1-16b-a3b at its published width, 2 of its 48 layers
# (2.35 GB of fp32 a layer), mesh (1, 4): the forward and the loss with every
# MoE block through moe_a2a.moe_block_a2a, each rank its 16 experts and 4/4
# heads; against the one-process dense model on the same weights: one MoE
# block's output within 2e-5 of max|ref| and aux within 1e-4
# (tests/test_moe_a2a.py's bounds) with the dense block's capacity drops
# (one data rank: the global capacity), the logits within 1e-4 of max|ref|.
MOE_A2A = dict(arch="moonshot-v1-16b-a3b", world=4, mesh=(1, 4), n_layers=2, batch=2, seq=512,
               seed=7, block_tol=2e-5, aux_tol=1e-4, logit_tol=1e-4, loss_rtol=1e-5,
               timeout_s=600)
# [elastic]: ElasticTrainer on 4 ranks of the card, phi4-mini smoke (a save
# at full width writes ~63 s per 9.8 GB): (2, 2), 12 steps with a
# checkpoint every 5, one rank fails, (1, 2) restored from step 10, 8 more
# steps.  The losses those of the uninterrupted one-process run on the card
# (steps 0-11, then 10-17: the first within 1e-5 relative, every later one
# within 1e-4), the restored state the saved one bit for bit.
ELASTIC = dict(arch="phi4-mini-3.8b", world=4, batch=8, seq=16, steps_a=12, steps_b=8,
               every=5, lr=3e-3, warmup=5, total=200, first_rtol=1e-5, rtol=1e-4,
               dir=ROOT / "build" / "elastic-ckpt", timeout_s=300)


def _count_heads(k4):
    """Wrap K4's forward and backward wrappers (in every module that holds
    them) to record each launch's (Hq, Hkv); their counts stay theirs."""
    from repro_torch.kernels import flash_attention as fa_pkg
    from repro_torch.kernels.flash_attention import autograd as fa_auto
    from repro_torch.kernels.flash_attention import ops as fa_ops

    seen = set()
    fwd, bwd = k4.flash_attention_cuda, k4.flash_attention_bwd_cuda

    def fwd_spy(q, k, v, **kw):
        seen.add((int(q.shape[1]), int(k.shape[1])))
        return fwd(q, k, v, **kw)

    def bwd_spy(q, k, v, *rest, **kw):
        seen.add((int(q.shape[1]), int(k.shape[1])))
        return bwd(q, k, v, *rest, **kw)

    for mod in (fa_auto, fa_ops, fa_pkg):
        if hasattr(mod, "flash_attention_cuda"):
            mod.flash_attention_cuda = fwd_spy
        if hasattr(mod, "flash_attention_bwd_cuda"):
            mod.flash_attention_bwd_cuda = bwd_spy
    return seen


def _timed_collectives(dev):
    """Wrap dist.all_reduce and dist.all_gather with host-clock timers (the
    device synchronised before and after); returns the list of seconds."""
    import torch
    import torch.distributed as dist

    spent = []
    for name in ("all_reduce", "all_gather"):
        plain = getattr(dist, name)

        def timed(*a, _plain=plain, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = _plain(*a, **kw)
            torch.cuda.synchronize(dev)
            spent.append(time.perf_counter() - t0)
            return out

        setattr(dist, name, timed)
    return spent


def _placements_match(o_sh, state) -> tuple:
    """(leaves whose m and v placements both equal opt_state_shardings',
    leaves)."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.parallel import tensor as tp

    same = tree_map(lambda m, v, s: list(m.placements) == list(v.placements) == list(s[1]),
                    state.m, state.v, tp.shardings_like(o_sh, state.m))
    return sum(tree_leaves(same)), len(tree_leaves(same))


def _tp_train_rank(rank: int, world: int, store: str, device: str) -> dict:
    """One rank of [tp-train]: the gradients at the init against the
    one-process ones (rank 0), then the counted run of 2 steps."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import _device
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.launch import mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.parallel import tensor as tp
    from repro_torch.runtime.train_loop import accumulate_grads, make_train_step

    c = TP_TRAIN
    dev = torch.device(device)
    _device.full_fp32_matmuls(dev)
    mesh.init_ranks(rank, world, device=dev, store_path=store, timeout_s=c["timeout_s"])
    dmesh = mesh.make_device_mesh(*c["mesh"])
    heads = _count_heads(k4)
    cfg = get_config(TRAIN["arch"], n_layers=c["n_layers"])
    model = build_model(cfg, remat=True)
    opt = adamw.AdamWConfig(lr=c["lr"], warmup_steps=0, schedule="constant", weight_decay=0.0)
    data = SyntheticLM(cfg.vocab, c["seq"], c["batch"], n_micro=1, seed=c["seed"])
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in data.batch(s).items()}
               for s in range(c["steps"])]
    full, axes = model.init(c["seed"], device=dev, with_axes=True)
    rules = sharding.make_rules(cfg, dmesh)
    o_sh = sharding.opt_state_shardings(dmesh, axes, rules, full)
    params = tp.place_tree(full, sharding.param_shardings(dmesh, axes, rules))
    if rank != 0:
        del full
    torch.cuda.empty_cache()
    step = make_train_step(model, opt, 1, pre_shaped=True, device=dev, mesh=dmesh)
    out = dict(rank=rank, backend=dist.get_backend(), params=cfg.n_params(), layers=cfg.n_layers,
               coord=tuple(dmesh.get_coordinate()), rules={k: v for k, v in rules.items() if v})

    # 1. Outside the counted run: the gradients at the init, gathered whole,
    # against the one-process ones on the whole batch (rank 0).
    g, loss = step.grads(params, batches[0])
    g = tp.gather_tree(g)
    if rank == 0:
        g1, l1 = accumulate_grads(model, full, batches[0])
        out["loss_tp"], out["loss_one"] = float(loss), float(l1)
        out["grad_err"] = max(float((a - b).abs().max()) / float(b.abs().max())
                              for a, b in zip(tree_leaves(g), tree_leaves(g1)))
        del g1
    del g
    torch.cuda.empty_cache()

    # 2. The counted run: 2 steps, K4's and the collectives' counts reset
    # just before.
    state = adamw.init(params, o_sh)
    spent = _timed_collectives(dev)
    torch.cuda.synchronize(dev)
    dist.barrier()
    k4.flash_attention_cuda.launches = k4.flash_attention_bwd_cuda.launches = 0
    tp.reset_counts()
    heads.clear()
    losses, secs, coll = [], [], []
    for s in range(c["steps"]):
        n0 = len(spent)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[s])
        losses.append(float(m["loss"]))
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        coll.append(sum(spent[n0:]))
    out.update(losses=losses, step_s=secs, coll_s=coll, counts=tp.counts(),
               fwd=k4.flash_attention_cuda.launches, bwd=k4.flash_attention_bwd_cuda.launches,
               heads=sorted(heads), placements=_placements_match(o_sh, state),
               embed_m=str(list(state.m["embed"].placements)),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del params, state
    torch.cuda.empty_cache()
    # 3. The one-process run on rank 0 from the same weights.
    dist.barrier()
    if rank == 0:
        one = make_train_step(model, opt, 1, pre_shaped=True, device=dev)
        st = adamw.init(full)
        ref = []
        for s in range(c["steps"]):
            full, st, m = one(full, st, batches[s])
            ref.append(float(m["loss"]))
        out["losses_one"] = ref
        del full, st
    dist.barrier()
    out["finite"] = bool(np.all(np.isfinite(losses)))
    dist.destroy_process_group()
    return out


def tp_train(dev) -> dict:
    """[tp-train] (see TP_TRAIN): returns K4's launches summed over the
    ranks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.launch import mesh

    c = TP_TRAIN
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh.spawn_ranks(_tp_train_rank, c["world"], str(dev), timeout_s=c["timeout_s"])
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    cfg = get_config(TRAIN["arch"])
    cfg_heads = (cfg.n_heads // c["mesh"][1], cfg.n_kv_heads // c["mesh"][1])
    for r in ranks:
        kinds = ";".join(f"{k}:{n}x{b / 1e6:.3f}MB" for k, (n, b) in r["counts"].items())
        phase("tp-train", rank=r["rank"], coord=r["coord"], backend=r["backend"],
              losses=",".join(f"{v:.6f}" for v in r["losses"]),
              step_s=",".join(f"{v:.3f}" for v in r["step_s"]),
              collective_s=",".join(f"{v:.3f}" for v in r["coll_s"]),
              collective_share=f"{sum(r['coll_s']) / sum(r['step_s']):.3f}",
              k4_fwd=r["fwd"], k4_bwd=r["bwd"], heads=r["heads"],
              zero1_placements=f"{r['placements'][0]}/{r['placements'][1]}",
              embed_m=repr(r["embed_m"]), peak_gb=f"{r['peak_gb']:.2f}", collectives=kinds)
    loss_rel = abs(r0["loss_tp"] - r0["loss_one"]) / abs(r0["loss_one"])
    rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], r0["losses_one"])]
    phase("tp-train", arch=TRAIN["arch"], layers=r0["layers"], params=r0["params"],
          mesh=f"{c['mesh'][0]}x{c['mesh'][1]}", rules=repr(r0["rules"]),
          global_batch=f"{c['batch']}x{c['seq']}", loss_tp=f"{r0['loss_tp']:.7f}",
          loss_one=f"{r0['loss_one']:.7f}", loss_rel_diff=f"{loss_rel:.3e}",
          worst_leaf_rel_diff=f"{r0['grad_err']:.3e}",
          losses_one=",".join(f"{v:.6f}" for v in r0["losses_one"]),
          step_loss_rel_diff=",".join(f"{v:.3e}" for v in rel), wall_s=f"{wall:.3f}")
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError("ranks sharing one card must run gloo")
    if not loss_rel <= c["loss_rtol"] or not rel[0] <= c["loss_rtol"]:
        raise AssertionError(f"the TP loss differs by {loss_rel:.3e} from the one-process one")
    if not all(v <= c["loss2_rtol"] for v in rel):
        raise AssertionError(f"the TP losses differ from the one-process run's: {rel}")
    if not r0["grad_err"] <= c["grad_tol"]:
        raise AssertionError(f"a TP gradient misses the one-process one by {r0['grad_err']:.3e}")
    calls = c["n_layers"] * c["steps"]
    for r in ranks:
        if not r["finite"] or r["losses"] != r0["losses"]:
            raise AssertionError(f"rank {r['rank']}'s losses: {r['losses']}")
        if (r["fwd"], r["bwd"]) != (2 * calls, k4.BWD_LAUNCHES * calls):
            raise AssertionError(f"rank {r['rank']}: K4 launched {r['fwd']} forwards and "
                                 f"{r['bwd']} backward kernels, expected {2 * calls} and "
                                 f"{k4.BWD_LAUNCHES * calls}")
        if r["heads"] != [cfg_heads]:
            raise AssertionError(f"rank {r['rank']}: K4 ran on heads {r['heads']}")
        if r["placements"][0] != r["placements"][1] or r["placements"][1] == 0:
            raise AssertionError(f"rank {r['rank']}: m/v placements differ from "
                                 "opt_state_shardings")
        if "tp_gather" in r["counts"] or "gather_full" in r["counts"]:
            raise AssertionError(f"rank {r['rank']}: a step gathered weights whole "
                                 f"({r['counts']})")
        ce_calls, ce_bytes = r["counts"]["ce_all_reduce"]
        if ce_bytes > ce_calls * 4 * c["batch"] * c["seq"]:
            raise AssertionError(f"rank {r['rank']}: the loss's collectives carried "
                                 f"{ce_bytes} bytes: logits gathered?")
    return dict(fwd=sum(r["fwd"] for r in ranks), bwd=sum(r["bwd"] for r in ranks))


def _moe_a2a_rank(rank: int, world: int, store: str, device: str) -> dict:
    """One rank of [moe-a2a]."""
    import torch
    import torch.distributed as dist
    from repro_torch import _device
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.launch import mesh
    from repro_torch.models import build_model, moe
    from repro_torch.models.moe_a2a import moe_block_a2a
    from repro_torch.parallel import sharding
    from repro_torch.parallel import tensor as tp

    c = MOE_A2A
    dev = torch.device(device)
    _device.full_fp32_matmuls(dev)
    mesh.init_ranks(rank, world, device=dev, store_path=store, timeout_s=c["timeout_s"])
    dmesh = mesh.make_device_mesh(*c["mesh"])
    heads = _count_heads(k4)
    cfg = get_config(c["arch"], n_layers=c["n_layers"])
    model = build_model(cfg)
    full, axes = model.init(c["seed"], device=dev, with_axes=True)
    rules = sharding.make_rules(cfg, dmesh)
    params = tp.place_tree(full, sharding.param_shardings(dmesh, axes, rules))
    if rank != 0:
        del full
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(c["seed"])
    tok = torch.randint(0, cfg.vocab, (c["batch"], c["seq"]), device=dev, generator=gen)
    x = torch.randn(c["batch"], c["seq"], cfg.d_model, device=dev, generator=gen) * 0.5
    out = dict(rank=rank, rules={k: v for k, v in rules.items() if v})

    # 1. One MoE block on the same x: a2a (this rank's 16 experts) against
    # the dense block (rank 0), and the capacity drops of each.
    moe.set_moe_opts(count_drops=True)
    moe_block_a2a.dropped = 0
    with torch.no_grad():
        y, aux = moe_block_a2a(params["blocks"][0]["mlp"], x, cfg, dmesh)
    drops = torch.as_tensor(moe_block_a2a.dropped, device=dev).reshape(1).clone()
    dist.all_reduce(drops)
    out["a2a_dropped"] = int(drops)
    if rank == 0:
        moe.moe_block.dropped = 0
        with torch.no_grad():
            ref, aux_ref = moe.moe_block(full["blocks"][0]["mlp"], x, cfg)
        out["dense_dropped"] = int(moe.moe_block.dropped)
        out["block_err"] = float((y - ref).abs().max()) / float(ref.abs().max())
        out["aux_err"] = abs(float(aux) - float(aux_ref))
        del ref
    moe.set_moe_opts()
    del y

    # 2. The counted run: the forward and the loss of the 2-layer model with
    # every MoE block through moe_block_a2a.
    moe.set_moe_opts(a2a_mesh=dmesh)
    torch.cuda.synchronize(dev)
    dist.barrier()
    k4.flash_attention_cuda.launches = 0
    tp.reset_counts()
    heads.clear()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model.forward(params, tok)
        loss = model.loss_fn(params, {"tokens": tok, "labels": tok})
    torch.cuda.synchronize(dev)
    out.update(fwd_s=time.perf_counter() - t0, fwd=k4.flash_attention_cuda.launches,
               heads=sorted(heads), counts=tp.counts(), loss=float(loss),
               logits_sharded=tp.is_dtensor(logits))
    moe.set_moe_opts()
    logits = tp.full_tensor(logits)
    if rank == 0:
        with torch.no_grad():
            ref = model.forward(full, tok)
            loss_ref = model.loss_fn(full, {"tokens": tok, "labels": tok})
        out["logit_err"] = float((logits - ref).abs().max()) / float(ref.abs().max())
        out["loss_ref"] = float(loss_ref)
        del ref
    del logits, params
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    dist.barrier()
    dist.destroy_process_group()
    return out


def moe_a2a_phase(dev) -> int:
    """[moe-a2a] (see MOE_A2A): returns K4's launches summed over the
    ranks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh

    c = MOE_A2A
    cfg = get_config(c["arch"])
    heads = (cfg.n_heads // c["mesh"][1], cfg.n_kv_heads // c["mesh"][1])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh.spawn_ranks(_moe_a2a_rank, c["world"], str(dev), timeout_s=c["timeout_s"])
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        kinds = ";".join(f"{k}:{n}x{b / 1e6:.3f}MB" for k, (n, b) in r["counts"].items())
        phase("moe-a2a", rank=r["rank"], k4_fwd=r["fwd"], heads=r["heads"],
              forward_s=f"{r['fwd_s']:.3f}", loss=f"{r['loss']:.7f}",
              peak_gb=f"{r['peak_gb']:.2f}", collectives=kinds)
    loss_rel = abs(r0["loss"] - r0["loss_ref"]) / abs(r0["loss_ref"])
    phase("moe-a2a", arch=c["arch"], layers=c["n_layers"], mesh=f"{c['mesh'][0]}x{c['mesh'][1]}",
          rules=repr(r0["rules"]), tokens=f"{c['batch']}x{c['seq']}",
          block_rel_err=f"{r0['block_err']:.3e}", aux_err=f"{r0['aux_err']:.3e}",
          dropped_a2a=r0["a2a_dropped"], dropped_dense=r0["dense_dropped"],
          logit_rel_err=f"{r0['logit_err']:.3e}", loss_ref=f"{r0['loss_ref']:.7f}",
          loss_rel_diff=f"{loss_rel:.3e}", wall_s=f"{wall:.3f}")
    if not r0["block_err"] <= c["block_tol"] or not r0["aux_err"] <= c["aux_tol"]:
        raise AssertionError("moe_block_a2a misses the dense block")
    if r0["a2a_dropped"] != r0["dense_dropped"]:
        raise AssertionError("moe_block_a2a dropped other assignments than the dense block")
    if not r0["logit_err"] <= c["logit_tol"] or not loss_rel <= c["loss_rtol"]:
        raise AssertionError("the a2a model's logits or loss miss the dense model's")
    for r in ranks:
        if r["fwd"] != 2 * c["n_layers"] or r["heads"] != [heads]:
            raise AssertionError(f"rank {r['rank']}: K4 launched {r['fwd']} times on heads "
                                 f"{r['heads']}, expected {2 * c['n_layers']} on {heads}")
        n, b = r["counts"].get("tp_gather", (1, 0))
        if not r["logits_sharded"] or b / n > 64e6:
            raise AssertionError(f"rank {r['rank']}: gathered the logits or a large weight "
                                 f"({r['counts']})")
        if r["loss"] != r0["loss"]:
            raise AssertionError(f"rank {r['rank']}'s loss differs from rank 0's")
    return sum(r["fwd"] for r in ranks)


def _elastic_rank(rank: int, world: int, store: str, device: str, batches) -> dict:
    """One rank of [elastic]."""
    import torch
    import torch.distributed as dist
    from repro_torch import _device
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.launch import mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.parallel import tensor as tp
    from repro_torch.runtime.elastic import ElasticConfig, ElasticTrainer
    from repro_torch.runtime.train_loop import make_train_step

    c = ELASTIC
    dev = torch.device(device)
    _device.full_fp32_matmuls(dev)
    mesh.init_ranks(rank, world, device=dev, store_path=store, timeout_s=c["timeout_s"])
    cfg = get_config(c["arch"], smoke=True)
    model = build_model(cfg, remat=True)
    opt = adamw.AdamWConfig(lr=c["lr"], warmup_steps=c["warmup"], total_steps=c["total"],
                            weight_decay=0.0)

    def build(dmesh):
        params, axes = model.init(0, device=dev, with_axes=True)
        rules = sharding.make_rules(cfg, dmesh)
        o_sh = sharding.opt_state_shardings(dmesh, axes, rules, params)
        p = tp.place_tree(params, sharding.param_shardings(dmesh, axes, rules))
        step = make_train_step(model, opt, 1, pre_shaped=True, device=dev, mesh=dmesh)

        def step_fn(state, batch):
            p, o, m = step(state[0], state[1], batch)
            return (p, o), m

        return (p, adamw.init(p, o_sh)), step_fn, None

    tr = ElasticTrainer(ElasticConfig(ckpt_dir=str(c["dir"]), ckpt_every=c["every"]), build)
    saved = {}

    def batch_fn(step, dmesh):
        if step == 10 and not saved:  # the state the step-10 checkpoint holds
            saved["state"] = tp.gather_tree(tr.state)
        return {k: torch.as_tensor(v, device=dev) for k, v in batches[step].items()}

    k4.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    tr.rebuild(model_axis=2)
    mesh_a = tuple(tr.mesh.mesh.shape)
    losses_a = tr.run(c["steps_a"], batch_fn)
    before = tr.step
    tr.fail_device(world - 1, model_axis=2)
    restored = tp.gather_tree(tr.state) if tr.in_mesh() else None
    after = tr.step
    losses_b = tr.run(c["steps_b"], batch_fn)
    torch.cuda.synchronize(dev)
    out = dict(rank=rank, mesh_a=mesh_a, mesh_b=tuple(tr.mesh.mesh.shape), in_mesh=tr.in_mesh(),
               losses_a=losses_a, losses_b=losses_b, before=before, after=after,
               wall_s=time.perf_counter() - t0, fwd=k4.flash_attention_cuda.launches)
    if restored is not None and "state" in saved:
        out["bitwise"] = all(tree_leaves(tree_map(
            lambda a, b: bool(torch.equal(a, b)) if isinstance(a, torch.Tensor) else a == b,
            saved["state"], restored)))
    dist.barrier()
    dist.destroy_process_group()
    return out


def elastic_phase(dev) -> int:
    """[elastic] (see ELASTIC): returns K4's launches summed over the ranks."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import make_train_step

    c = ELASTIC
    shutil.rmtree(c["dir"], ignore_errors=True)
    cfg = get_config(c["arch"], smoke=True)
    data = SyntheticLM(cfg.vocab, c["seq"], c["batch"], n_micro=1, seed=0)
    n = c["steps_a"] + c["steps_b"] - 2
    batches = [data.batch(s) for s in range(n)]
    # the uninterrupted one-process run on the card
    model = build_model(cfg, remat=True)
    params = model.init(0, device=dev)
    opt = adamw.AdamWConfig(lr=c["lr"], warmup_steps=c["warmup"], total_steps=c["total"],
                            weight_decay=0.0)
    step, state, want = make_train_step(model, opt, 1, pre_shaped=True, device=dev), \
        adamw.init(params), []
    for b in batches:
        params, state, m = step(params, state, {k: torch.as_tensor(v, device=dev)
                                                for k, v in b.items()})
        want.append(float(m["loss"]))
    del params, state
    t0 = time.perf_counter()
    ranks = mesh.spawn_ranks(_elastic_rank, c["world"], str(dev), batches,
                             timeout_s=c["timeout_s"])
    wall = time.perf_counter() - t0
    shutil.rmtree(c["dir"], ignore_errors=True)
    r0 = ranks[0]
    rel_a = [abs(a - b) / abs(b) for a, b in zip(r0["losses_a"], want)]
    rel_b = [abs(a - b) / abs(b) for a, b in zip(r0["losses_b"], want[r0["after"]:])]
    phase("elastic", arch=c["arch"] + " smoke", mesh_a=r0["mesh_a"], mesh_b=r0["mesh_b"],
          steps_before=r0["before"], restored_step=r0["after"], bitwise=r0.get("bitwise"),
          worst_rel_a=f"{max(rel_a):.3e}", worst_rel_b=f"{max(rel_b):.3e}",
          first_rel=f"{rel_a[0]:.3e}", in_mesh=",".join(str(int(r["in_mesh"])) for r in ranks),
          k4_fwd=",".join(str(r["fwd"]) for r in ranks), rank_s=f"{r0['wall_s']:.3f}",
          wall_s=f"{wall:.3f}")
    if r0["mesh_a"] != (2, 2) or r0["mesh_b"] != (1, 2) or r0["after"] != 10:
        raise AssertionError("the elastic run did not shrink to (1, 2) from step 10")
    if r0.get("bitwise") is not True:
        raise AssertionError("the restored state differs from the saved one")
    if not rel_a[0] <= c["first_rtol"] or not max(rel_a + rel_b) <= c["rtol"]:
        raise AssertionError(f"the elastic losses miss the uninterrupted run's: {rel_a} {rel_b}")
    for r in ranks:
        if r["in_mesh"] != (r["rank"] < 2) or len(r["losses_a"]) != c["steps_a"]:
            raise AssertionError(f"rank {r['rank']} in the wrong mesh")
        if r["in_mesh"] and r["losses_b"] != r0["losses_b"] or not np.all(
                np.isfinite(r["losses_a"])):
            raise AssertionError(f"rank {r['rank']}'s losses differ from rank 0's")
    return sum(r["fwd"] for r in ranks)



# ---------------------------------------------------------------------------
# The dry run's train cells (slice C6a)
# ---------------------------------------------------------------------------

# Two train_4k cells of launch/dryrun through its command line, on shape-only
# tensors (no card: meta tensors), and one production rank of each stepped
# for real: rank 0 of a fake world of 256 or 512 ranks on card 0, the cell's
# config at full width and 1 group with the cell's n_micro, its parameters
# placed by the production rules.  gemma2-27b on (16, 16): K4 at 2/1 heads a
# rank, T 4096, softcap 50; qwen3-235b on (2, 16, 16): the pod axis, the
# experts' ff FSDP over 'data', K4 with the q heads split and the kv heads
# whole.  The real step's FLOPs and bytes (utils.trace.StepCosts) must equal
# the shape-only steps' (meta, and fake CUDA tensors) exactly, K4's launches
# the calls they counted, and its peak (torch.cuda.max_memory_allocated, the
# placed state in it) lie within PEAK_RATIO of the shape-only peak.
DRYRUN = dict(cells=[("gemma2-27b", "single"), ("qwen3-moe-235b-a22b", "multi")],
              shape="train_4k", peak_ratio=(0.8, 1.25), timeout_s=240,
              out=ROOT / "build" / "repro_torch" / "dryrun-chip")


def _dryrun_rank(rank: int, world: int, store: str, cells, shape: str) -> list:
    """[dryrun-rank]'s process: check_rank of each cell (``world`` is this
    spawn's one process; the fake world is started inside)."""
    from repro_torch.launch import dryrun

    return [dict(arch=a, mesh=m, **dryrun.check_rank(a, m == "multi", shape, device="cuda"))
            for a, m in cells]


def dryrun_phases(dev) -> dict:
    """[dryrun-cells] and [dryrun-rank] (see DRYRUN), run at once: the two
    cells' command lines in subprocesses, the real ranks in a spawned
    process.  Returns K4's real launches (forward, backward) summed over
    the ranks."""
    import os

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh

    c = DRYRUN
    torch.cuda.empty_cache()
    c["out"].mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    logs = [c["out"] / f"{arch}__{m}.log" for arch, m in c["cells"]]
    procs, ends = [], {}
    for (arch, m), log in zip(c["cells"], logs):
        with open(log, "w") as f:  # the card hidden: the cells need none
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                 c["shape"], "--mesh", m, "--force", "--out", str(c["out"])],
                env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
    waiters = [threading.Thread(target=lambda i=i, p=p: (p.wait(), ends.setdefault(
        i, time.perf_counter() - t0))) for i, p in enumerate(procs)]
    for w in waiters:
        w.start()
    try:
        ranks = mesh.spawn_ranks(_dryrun_rank, 1, c["cells"], c["shape"],
                                 timeout_s=c["timeout_s"])[0]
        rank_wall = time.perf_counter() - t0
        for w in waiters:
            w.join(timeout=max(1.0, c["timeout_s"] - rank_wall))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cells_wall = max(ends.values()) if len(ends) == len(procs) else float("nan")
    for (arch, m), p, log in zip(c["cells"], procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"the dry run of {arch} on {m} failed:\n"
                                 f"{log.read_text()[-4000:]}")
        res = json.loads((c["out"] / f"{arch}__{c['shape']}__{m}.json").read_text())
        cfg = get_config(arch)
        roof, mem, bk = res["roofline"], res["memory"], res["by_kernel"]
        phase("dryrun-cells", arch=arch, mesh=m, status=res["status"], n_micro=res["n_micro"],
              devices=res["n_devices"], trace_s=res["trace_s"],
              param_bytes_dev=f"{mem['param_bytes_per_device_est']:.6e}",
              peak_bytes_dev=f"{mem['peak_bytes_per_device']:.6e}",
              flops_dev=f"{roof['flops']:.6e}", hbm_bytes_dev=f"{roof['hbm_bytes']:.6e}",
              wire_dev=f"{roof['wire_bytes']:.6e}", once_wire=f"{res['once_wire']:.6e}",
              useful_flops_ratio=f"{roof['useful_flops_ratio']:.4f}",
              bound_s=f"{max(roof['compute_s'], roof['memory_s'], roof['collective_s']):.4f}",
              dominant=roof["dominant"], k4_calls=int(bk["flash_attention"]["calls"]),
              k4_bwd_calls=int(bk["flash_attention_bwd"]["calls"]),
              collectives=",".join(sorted(res["collectives"])), rules=repr(
                  {k: v for k, v in res["rules"].items() if v}))
        want = cfg.n_layers * res["n_micro"]
        if res["status"] != "ok" or bk["flash_attention"]["calls"] != 2 * want or \
                bk["flash_attention_bwd"]["calls"] != want:
            raise AssertionError(f"{arch} on {m}: {res['status']}, K4 {bk}")
        if arch.startswith("qwen3") and ("fsdp_gather" not in res["collectives"]
                                          or res["rules"]["ff"] != "data"):
            raise AssertionError("qwen3-235b's experts are not FSDP over 'data'")
    fwd = bwd = 0
    lo, hi = c["peak_ratio"]
    for r in ranks:
        real, meta, fake = r["real"], r["meta"], r["fake"]
        ratio = real["peak_bytes"] / fake["peak_bytes"]
        kinds = ";".join(f"{k.split('/')[1]}:{int(real[k])}" for k in sorted(real)
                         if k.startswith("coll/") and k.endswith("/calls"))
        phase("dryrun-rank", arch=r["arch"], mesh=r["mesh"], groups=1, n_micro=r["n_micro"],
              k4_launches=real["launches"]["flash_attention"],
              k4_bwd_launches=real["launches"]["flash_attention_bwd"],
              k4_calls_fake=int(fake["kernel/flash_attention/calls"]),
              k4_bwd_calls_fake=int(fake["kernel/flash_attention_bwd/calls"]),
              flops_real=f"{real['flops']:.0f}", flops_fake=f"{fake['flops']:.0f}",
              flops_meta=f"{meta['flops']:.0f}", bytes_real=real["bytes"],
              bytes_fake=fake["bytes"], bytes_meta=meta["bytes"],
              peak_real_gb=f"{real['peak_bytes'] / 1e9:.4f}",
              peak_fake_gb=f"{fake['peak_bytes'] / 1e9:.4f}",
              peak_meta_gb=f"{meta['peak_bytes'] / 1e9:.4f}",
              live_real_gb=f"{real['live_peak_bytes'] / 1e9:.4f}", peak_ratio=f"{ratio:.4f}",
              step_s=f"{real['step_s']:.3f}", collectives=kinds)
        for shape_only in (meta, fake):
            if (real["launches"]["flash_attention"]
                    != shape_only["kernel/flash_attention/calls"]
                    or real["launches"]["flash_attention_bwd"]
                    != 2 * shape_only["kernel/flash_attention_bwd/calls"]):
                raise AssertionError(f"{r['arch']}: K4's launches differ from the counted calls")
            if real["flops"] != shape_only["flops"] or real["bytes"] != shape_only["bytes"]:
                raise AssertionError(f"{r['arch']}: the real step's StepCosts differ from the "
                                     "shape-only step's")
        if not lo <= ratio <= hi:
            raise AssertionError(f"{r['arch']}: real peak / shape-only peak {ratio:.3f}")
        fwd += real["launches"]["flash_attention"]
        bwd += real["launches"]["flash_attention_bwd"]
    phase("dryrun-cells", cells=len(c["cells"]), wall_s=f"{cells_wall:.3f}",
          beside="dryrun-rank")
    phase("dryrun-rank", cells=len(ranks), wall_s=f"{rank_wall:.3f}")
    return dict(fwd=fwd, bwd=bwd)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "one CUDA card", file=sys.stderr)
        return 1
    from repro_torch import quickstart
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.coded_matmul import coded_matmul_cuda
    from repro_torch.kernels.coded_matmul import kernel as k1
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.lt_decode import kernel as k3
    from repro_torch.kernels.lt_encode import kernel as k2

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    print(smi.strip(), flush=True)
    phase("env", device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])

    # 2. Build every kernel (one nvcc per source, all at once) and load them.
    t0 = time.perf_counter()
    libs = _nvcc.build_all(_nvcc.sources())
    for k in (k1, k2, k3, k4):
        k._lib()
    k4._bwd_lib()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          sources=",".join(libs))
    for name, lib in libs.items():
        fn = ""
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for", 1)[1].strip()
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                phase("ptxas", source=name, function=fn[-96:], info=repr(line.strip()))
    tensor_core_sass(libs["coded_matmul.cu"], "coded_matmul_wgmma_kernel")
    tensor_core_sass(libs["flash_attention.cu"], "flash_attention_wgmma_kernel")
    tensor_core_sass(libs["flash_attention_bwd.cu"], "attention_bwd_dq_wgmma_kernel",
                     "attention_bwd_dkdv_wgmma_kernel")
    # What the card gives library calls, beside the data sheet's peaks.
    ceilings(dev)

    # 3.-4. K1, K2 and K3 against their plain versions, then K1 at the main
    # path's shape.
    check_kernel_against_plain(dev)
    check_lt_kernels_against_plain(dev)
    main_shape = kernel_at_main_shape(dev)
    torch.cuda.empty_cache()

    # 5.-6. The main path through the entry points a user calls: K1 for the
    # helpers' products, K3 for the collector's peeling recoveries.
    coded_matmul_cuda.launches = k3.lt_decode_plan_cuda.launches = 0
    data = quickstart.coded_offload(device=dev, **MAIN)
    torch.cuda.synchronize()
    launches_data = coded_matmul_cuda.launches
    launches_collector = k3.lt_decode_plan_cuda.launches
    worst = max(data["rel_err"])
    phase("data-plane", shape=f"{MAIN['rows']}x{MAIN['k_dim']}x{MAIN['n_dim']}",
          survivor_sets=len(data["rel_err"]), k1_launches=launches_data,
          k3_launches=launches_collector, worst_rel_err=f"{worst:.3e}",
          rel_errs=",".join(f"{e:.3e}" for e in data["rel_err"]))
    if launches_data < 1:
        raise AssertionError("the data plane did not launch K1")
    if launches_collector != peeling_losses():
        raise AssertionError(f"the collector launched K3 {launches_collector} times for "
                             f"{peeling_losses()} peeling recoveries")
    if not worst <= 1e-4:
        raise AssertionError(f"recovery error {worst:.3e} > 1e-4")

    ctrl = quickstart.ccp_vs_best(device=dev, R=2000, reps=200)
    torch.cuda.synchronize()
    launches = coded_matmul_cuda.launches
    phase("control-plane", cfg="FIG3[1]", R=2000, reps=200,
          T_ccp=f"{ctrl['T_ccp']:.6f}", T_best=f"{ctrl['T_best']:.6f}",
          T_opt=f"{ctrl['T_opt']:.6f}", efficiency=f"{ctrl['efficiency']:.6f}",
          all_valid=ctrl["valid"], M=ctrl["M"], wall_s=f"{ctrl['wall_s']:.3f}")
    if not ctrl["valid"]:
        raise AssertionError("uncertified reps in the control plane")
    if not ctrl["T_ccp"] <= 1.10 * ctrl["T_best"]:
        raise AssertionError("T_ccp > 1.10 T_best")
    if not ctrl["efficiency"] > 0.99:
        raise AssertionError("mean CCP efficiency <= 0.99")
    # The block baselines beside CCP, then the paper's figures at their full
    # sweeps (the control plane: no kernel).
    baselines_control_plane(dev)
    figures_on_card(dev)
    collector_times(dev)
    engine_cpu_vs_card(dev)
    k1_second_shape(dev)

    # 7.-8. The rateless path: the LT payload round trip on K2 and K3 (their
    # launch counts are reset inside, just before each shape's round trip),
    # then the rateless control plane with the decoder in the loop.
    lt = rateless_data_plane(dev)
    lt["lt_decode"]["launches_by_path"] = {"rateless-data-plane": lt["lt_decode"]["launches"],
                                           "data-plane": launches_collector}
    lt["lt_decode"]["launches"] += launches_collector  # K3 on both paths
    rateless_control_plane(dev)

    # 8b. Churn (the control plane, no kernel): the loop on the card against
    # the CPU, the churn figures at their full defaults, and one run a
    # policy at the burst endpoint.
    churn_card_vs_cpu(dev)
    churn_figures_on_card(dev)
    churn_control_plane(dev)

    # 8c. Transport and fleet (the control plane, no kernel): the transport
    # loop and the fleet loop on the card against the CPU, and fig_transport
    # and fig_fleet at the reference figure scripts' defaults.
    transport_card_vs_cpu(dev)
    transport_figure_on_card(dev)
    fleet_card_vs_cpu(dev)
    fleet_figure_on_card(dev)

    # 9.-11. LM serving: K4 against its plain version, K4 at the serving
    # path's shapes, then phi4-mini-3.8b at full size through the engine
    # (K4's launches reset just before generate), CCP dispatch over two
    # replicas, and the card against the CPU at two layers.
    check_flash_attention_against_plain(dev)
    fa = flash_attention_at_path_shapes(dev)
    fa["launches"] = serve_main_path(dev)
    serve_card_vs_cpu(dev)

    # 12. LM training: K4's backward against its plain version and at the
    # training shape, then phi4-mini at full width (8 layers) through
    # launch/train (both kernels' launches reset just before the run), one
    # step under the profiler, the card against the CPU, and coded DP.
    check_flash_attention_bwd(dev)
    fa_bwd = flash_attention_bwd_at_train_shape(dev)
    train_launches = train_main_path(dev)
    fa_bwd["launches"] = train_launches["bwd"]
    profile_train_step(dev)
    train_card_vs_cpu(dev)
    coded_dp_train(dev)

    # 12b. Checkpointing (slice C4): training saved mid-run and resumed
    # through launch/train (K4's launches reset just before each run), then
    # the roofline of one training step (the decode step's came with
    # [serve]).
    ckpt_launches = ckpt_train(dev)
    roofline_train_step(dev)

    # 13. The other model families (slice C3): K4 and its backward at their
    # attention shapes, each family's serving path at its published width
    # (K4's launches reset just before each generate run), then the card
    # against the CPU, logits and gradients.
    fa_family = k4_family_shapes(dev)
    fa_bwd_family = k4_bwd_family_shape(dev)
    family_launches = {spec["name"]: serve_family(dev, spec) for spec in FAMILY_SERVE}
    families_card_vs_cpu(dev)
    families_train_card(dev)
    fa["launches_by_path"] = {"serve": fa["launches"], **family_launches,
                              "ckpt-train": ckpt_launches["fwd"]}
    fa["family_shapes"] = fa_family
    fa_bwd["launches_by_path"] = {"train": fa_bwd["launches"],
                                  "ckpt-train": ckpt_launches["bwd"]}
    fa_bwd["family_shapes"] = [fa_bwd_family]

    # 14. The C3P paths over several devices and ranks (slice C5a): MAIN's
    # coded matmul over 8 shards of the card (K1's and K3's counts reset
    # just before the run), the sharded engine and fleet (no kernel), then
    # training across 4 ranks on the card (K4's counts reset in each rank
    # just before its steps).
    shard_launches = shard_data_plane(dev)
    engine_shard(dev)
    rank_launches = ranks_train(dev)
    lt["lt_decode"]["launches_by_path"]["shard-data-plane"] = shard_launches["k3"]
    fa["launches_by_path"]["ranks-train"] = rank_launches["fwd"]
    fa_bwd["launches_by_path"]["ranks-train"] = rank_launches["bwd"]

    # 15. The tensor-parallel LM across ranks (slice C5b), 4 ranks on the
    # card each time (K4's counts reset in each rank just before its counted
    # run): phi4-mini trained on a (2, 2) mesh, moonshot's forward through
    # the all-to-all MoE on (1, 4), and the elastic shrink-and-restore.
    tp_launches = tp_train(dev)
    fa["launches_by_path"]["tp-train"] = tp_launches["fwd"]
    fa_bwd["launches_by_path"]["tp-train"] = tp_launches["bwd"]
    fa["launches_by_path"]["moe-a2a"] = moe_a2a_phase(dev)
    fa["launches_by_path"]["elastic"] = elastic_phase(dev)

    # 16. The dry run's train cells on the production meshes (slice C6a): two
    # cells on shape-only tensors, and one production rank of each stepped
    # on the card (K4's counts taken just around that step).
    dry = dryrun_phases(dev)
    fa["launches_by_path"]["dryrun-rank"] = dry["fwd"]
    fa_bwd["launches_by_path"]["dryrun-rank"] = dry["bwd"]

    # 17. Every kernel of the paths.
    print(json.dumps({"kernels": [
        dict(name="coded_matmul", route="cuda",
             source="src/repro_torch/csrc/coded_matmul.cu",
             replaces="src/repro/kernels/coded_matmul/kernel.py:71",
             launches=launches, launches_by_path={"data-plane": launches,
                                                  "shard-data-plane": shard_launches["k1"]},
             **main_shape),
        dict(name="lt_encode", route="cuda", source="src/repro_torch/csrc/lt_encode.cu",
             replaces="src/repro/kernels/lt_encode/kernel.py:41", **lt["lt_encode"]),
        dict(name="lt_decode", route="cuda", source="src/repro_torch/csrc/lt_decode.cu",
             replaces="src/repro/kernels/lt_decode/kernel.py:50", **lt["lt_decode"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:100", **fa),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention/ref.py:19", **fa_bwd),
    ]}), flush=True)
    for name, k in lt.items():
        if k["launches"] < 1:
            raise AssertionError(f"the rateless path did not launch {name}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
