"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version on the card, times it at the main path's
shape beside its bound, drives the main path (one C3P task: the coded
matmul data plane and the CCP control plane) through the port's entry
points, checks the results, and prints one line per phase.  The line before
the last is a JSON object with every kernel's launches on the main path,
error and times; the last line is ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; so does a machine without a CUDA card,
or a directory without the repository's ``src/``.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # CUDA cores, outside the tensor cores

# The sweep shapes of tests/test_kernels_coded_matmul.py: (R, K, bm, k, n).
SWEEP = [(4, 2, 8, 16, 16), (6, 3, 16, 64, 32), (8, 4, 8, 128, 128),
         (3, 2, 32, 48, 24), (10, 5, 8, 32, 8)]
# The main path's shape (the first "production-ish" shape of the reference's
# kernel benchmark): A 8192x4096, X 4096x4096, 8 shards, 25% overhead.
MAIN = dict(rows=8192, k_dim=4096, n_dim=4096, n_shards=8, overhead=0.25, bm=256)


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def tolerance(dtype, ref) -> float:
    """f32: 1e-5 (the reference suite's kernel tolerance), bf16: 2e-2, both
    scaled by 1 + max|ref|."""
    import torch
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    return rel * (1.0 + float(ref.float().abs().max()))


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
    for name, R, K, bm, k, n, dt, operand in cases:
        code = fountain.make_lt_code(R=R, K=K, seed=R * 31 + K)
        a = torch.randn((R * bm, k), generator=gen, device=dev).to(dt)
        x = torch.randn((k, n), generator=gen, device=dev).to(dt)
        idx = torch.as_tensor(code.idx, device=dev)
        mask = torch.as_tensor(code.mask if operand == "mask" else code.weights,
                               device=dev)
        out = coded_matmul(a, x, idx, mask, bm=bm)
        ref = coded_matmul_ref(a, x, idx, mask, bm)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = tolerance(dt, ref)
        phase("k1-vs-plain", case=name, shape=f"R{R}K{K}bm{bm}k{k}n{n}",
              max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}")
        if not (out.shape == ref.shape and err <= tol):
            raise AssertionError(f"K1 disagrees with its plain version on {name}")
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
    ms = time_ms(lambda: coded_matmul_cuda(a, x, idx, w, bm), 10)
    plain_ms = time_ms(lambda: coded_matmul_ref(a, x, idx, w, bm), 5)
    lib_ms = time_ms(lambda: torch.matmul(a_enc, x), 10)
    # Bound: each input read once and the output written once, against the
    # product plus this plan's nonzero-weight encode FMAs, in fp32.
    nnz = int((w != 0).sum())
    nbytes = sum(t.numel() * t.element_size() for t in (a, x, idx, w, out))
    ops = 2.0 * C * bm * k * n + 2.0 * nnz * bm * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    phase("k1-main-shape", A=f"{MAIN['rows']}x{k}", X=f"{k}x{n}", C=C, bm=bm,
          max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}", k1_ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", torch_matmul_ms=f"{lib_ms:.4f}",
          bound_ms=f"{bound_ms:.4f}", bytes=nbytes, ops=f"{ops:.4e}",
          k1_tflops=f"{ops / ms / 1e9:.2f}")
    # Where K1's time goes: systematic blocks (one neighbour, a plain GEMM)
    # against parity blocks (d neighbours to encode per tile).
    degree = (w != 0).sum(dim=1)
    for kind, sel in (("systematic", degree == 1), ("parity", degree > 1)):
        idx_s, w_s = idx[sel].contiguous(), w[sel].contiguous()
        ms_s = time_ms(lambda: coded_matmul_cuda(a, x, idx_s, w_s, bm), 10)
        phase("k1-split", blocks=kind, C=idx_s.shape[0], ms=f"{ms_s:.4f}",
              product_tflops=f"{2.0 * idx_s.shape[0] * bm * k * n / ms_s / 1e9:.2f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def engine_cpu_vs_card(dev) -> None:
    """The engine on the card against the same engine on the CPU, from one
    set of tables (N=20, R=400, M=256): completion times and efficiencies
    agree to float32 rounding."""
    import torch
    from repro_torch.core import engine, simulator

    cfg = simulator.ScenarioConfig(N=20, scenario=1)
    tables = engine.draw_tables(torch.Generator().manual_seed(3), cfg, 4, 400, 256)
    on_card = engine.Tables(*(getattr(tables, f.name).to(dev)
                              for f in dataclasses.fields(tables)))
    for policy in ("ccp", "best"):
        cpu = engine.simulate(tables, cfg, 400, policy)
        gpu = engine.simulate(on_card, cfg, 400, policy)
        torch.testing.assert_close(gpu["T"].cpu(), cpu["T"], rtol=1e-6, atol=0)
        torch.testing.assert_close(gpu["efficiency"].cpu(), cpu["efficiency"],
                                   rtol=1e-6, atol=1e-7, equal_nan=True)
        if not torch.equal(gpu["r_n"].cpu(), cpu["r_n"]):
            raise AssertionError(f"{policy}: r_n differs between card and CPU")
    phase("engine-card-vs-cpu", policies="ccp,best", reps=4, N=20, R=400, M=256,
          agree="yes")


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

    # 2. Build every kernel (one nvcc per source, all at once) and load K1.
    t0 = time.perf_counter()
    libs = _nvcc.build_all(_nvcc.sources())
    k1._lib()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          sources=",".join(libs))
    for name, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                phase("ptxas", source=name, info=repr(line.strip()))

    # 3.-4. K1 against its plain version, then at the main path's shape.
    check_kernel_against_plain(dev)
    main_shape = kernel_at_main_shape(dev)
    torch.cuda.empty_cache()

    # 5.-6. The main path through the entry points a user calls.
    coded_matmul_cuda.launches = 0
    data = quickstart.coded_offload(device=dev, **MAIN)
    torch.cuda.synchronize()
    launches_data = coded_matmul_cuda.launches
    worst = max(data["rel_err"])
    phase("data-plane", shape=f"{MAIN['rows']}x{MAIN['k_dim']}x{MAIN['n_dim']}",
          survivor_sets=len(data["rel_err"]), k1_launches=launches_data,
          worst_rel_err=f"{worst:.3e}",
          rel_errs=",".join(f"{e:.3e}" for e in data["rel_err"]))
    if launches_data < 1:
        raise AssertionError("the data plane did not launch K1")
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
    engine_cpu_vs_card(dev)

    # 7. Every kernel of the path.
    print(json.dumps({"kernels": [dict(
        name="coded_matmul", route="cuda",
        source="src/repro_torch/csrc/coded_matmul.cu",
        replaces="src/repro/kernels/coded_matmul/kernel.py:71",
        launches=launches, **main_shape)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
