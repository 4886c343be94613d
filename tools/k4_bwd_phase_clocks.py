"""Where K4's tensor-core backward spends its cycles, on the card.

    python3 tools/k4_bwd_phase_clocks.py

Copies ``src/repro_torch/csrc/flash_attention_bwd.cu`` into the git-ignored
``build/k4_bwd_phase_clocks/``, inserts clock64() marks at the phase
boundaries of the loops of ``attention_bwd_dq_wgmma_kernel`` and
``attention_bwd_dkdv_wgmma_kernel`` (thread 0 of each warpgroup sums, per
phase, the cycles since the previous mark), builds it with nvcc, runs the
backward at chip_smoke.py's training shape (``FA_BWD_SHAPE``) and prints,
for each launch and warpgroup, the mean cycles a tile spends in each phase,
and the instrumented kernels' device time.  The marks are inserted at lines
of the source found by their text: an edit to those lines stops the script
with the line it could not find.  Needs a card and the CUDA toolkit;
imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "k4_bwd_phase_clocks"
# Per kernel: (the text its body starts with, its loop's first line, the
# line after its loop, and [(a line of the loop, phase ended just before
# it)]).  The first phase of each list is the last tile's, closed at the
# next tile's top or after the loop.
KERNELS = {
    "dq": ("attention_bwd_dq_wgmma_kernel(const", "    for (int it = 0; it < n_kt; ++it) {\n",
           "    float* dqg = static_cast<float*>(a.dq);\n", [
               ("        mbar_wait(&kv_full, it & 1);\n", "dQ product"),
               ("        __syncthreads();  // both warpgroups are done with the last tile's K^T"
                " planes\n", "TMA wait"),
               ("        split_tile(sK, sKThi, sKTlo, tid);\n", "barrier"),
               ("        fence_proxy_async();  // the planes are wgmma's operands\n", "split"),
               ("        rows_product(s, sQ, sK, r_lo, t);\n", "barrier"),
               ("        __syncthreads();  // both warpgroups' products have read K and V\n",
                "S and dP"),
               ("        if (it + 1 < n_kt) load_kv_box(k0 + Q_KEYS);\n", "barrier"),
               ("        // dS = P (dP - D) dtanh by selects", "TMA issue"),
               ("        acc_product(dq, dsb, dss, sKThi, sKTlo);\n", "dS"),
           ]),
    "dkdv": ("attention_bwd_dkdv_wgmma_kernel(const",
             "    for (int it = 0; it < n_tiles; ++it) {\n",
             "    // Keys at or beyond tk_valid (and below Tk) get zeros", [
                 ("        mbar_wait(&rows_full, it & 1);\n", "dV or dK product"),
                 ("        __syncthreads();  // the last tile's planes, weights, lse and D are"
                  " read\n", "TMA wait"),
                 ("        split_tile(sQ, sQThi, sQTlo, tid);\n", "barrier"),
                 ("        fence_proxy_async();  // the planes are wgmma's operands\n", "split"),
                 ("        rows_product(s, sA, sB, r_lo, t);\n", "barrier"),
                 ("        // s[4j + e]: key k0", "S^T or dP^T"),
                 ("        __syncthreads();  // the weights are written", "P and w"),
                 ("        uint32_t big[16], small[16];\n", "barrier, TMA, lse and D issue"),
                 ("        acc_product(acc, big, small, sThi, sTlo);\n", "dS and split"),
             ]),
}


def instrumented() -> str:
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    if "namespace {\n\nusing namespace hopper;\n" not in src:
        raise SystemExit("k4_bwd_phase_clocks: the namespace line is not found")
    decls = "".join(f"__device__ unsigned long long g_clk_{name}[2 * {len(marks) + 2}];\n"
                    for name, (_, _, _, marks) in KERNELS.items())
    src = src.replace("namespace {\n\nusing namespace hopper;\n",
                      decls + "namespace {\n\nusing namespace hopper;\n", 1)
    for name, (head, loop, after, marks) in KERNELS.items():
        start = src.find(head)
        end = src.find(after, start)
        if start < 0 or end < 0:
            raise SystemExit(f"k4_bwd_phase_clocks: {name}'s kernel or its end is not found")
        body = src[start:end]
        n = len(marks) + 1

        def sub(a: str, b: str) -> None:
            nonlocal body
            if a not in body:
                raise SystemExit(f"k4_bwd_phase_clocks: line not found in {name}: {a!r}")
            body = body.replace(a, b, 1)

        sub(loop, f"    unsigned long long clk[{n}] = {{}};\n    long long t_prev = clock64();\n"
            + loop)
        for i, (line, _) in enumerate(marks):
            sub(line, f"        {{ const long long x = clock64(); clk[{i}] += x - t_prev; "
                "t_prev = x; }\n" + line)
        tiles = "n_kt" if name == "dq" else "n_tiles"
        body += (f"    {{ const long long x = clock64(); clk[{n - 1}] += x - t_prev; }}\n"
                 "    if ((tid & 127) == 0) {\n"
                 f"        for (int i = 0; i < {n}; ++i) "
                 f"atomicAdd(&g_clk_{name}[{n + 1} * (tid >> 7) + i], clk[i]);\n"
                 f"        atomicAdd(&g_clk_{name}[{n + 1} * (tid >> 7) + {n}], "
                 f"(unsigned long long){tiles});\n    }}\n")
        src = src[:start] + body + src[end:]
    reads = "".join(
        f"int clk_read_{name}(unsigned long long* h) {{\n"
        f"    return (int)cudaMemcpyFromSymbol(h, g_clk_{name}, sizeof(g_clk_{name}));\n}}\n"
        f"int clk_zero_{name}() {{\n    unsigned long long z[sizeof(g_clk_{name}) / 8] = {{}};\n"
        f"    return (int)cudaMemcpyToSymbol(g_clk_{name}, z, sizeof(z));\n}}\n"
        for name in KERNELS)
    return src.replace('extern "C" {\n', 'extern "C" {\n' + reads, 1)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("k4_bwd_phase_clocks: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.flash_attention.autograd import kernel_forward

    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    src = OUT / "flash_attention_bwd.cu"
    src.write_text(instrumented())
    lib = OUT / "flash_attention_bwd_clocks.so"
    build = subprocess.run([_nvcc._nvcc(), *_nvcc.FLAGS, "-o", str(lib), str(src)],
                           capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    so = ctypes.CDLL(str(lib))
    for fn in ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        launch = getattr(so, f"{fn}_launch")
        launch.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 27
                           + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        launch.restype = ctypes.c_int
        err = getattr(so, f"{fn}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    k4._bwd_lib = lambda: so

    dev = torch.device("cuda", 0)
    c = cs.FA_BWD_SHAPE
    q, k, v, do = cs._fa_bwd_inputs(dev, torch.Generator(device=dev).manual_seed(8), c["B"],
                                    c["Hq"], c["Hkv"], c["T"], c["T"], c["D"], torch.float32,
                                    None)
    out, lse = kernel_forward(q, k, v, causal=True, window=None, softcap=None, q_offset=0,
                              kv_len=None)

    def call():
        return k4.flash_attention_bwd_cuda(q, k, v, out, do, lse, causal=True)

    call()
    torch.cuda.synchronize()
    for name in KERNELS:
        getattr(so, f"clk_zero_{name}")()
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for name, (_, _, _, marks) in KERNELS.items():
        n = len(marks) + 1
        raw = (ctypes.c_ulonglong * (2 * (n + 1)))()
        getattr(so, f"clk_read_{name}")(raw)
        names = [label for _, label in marks[1:]] + [marks[0][1]]
        for wg in range(2):
            tiles = max(raw[wg * (n + 1) + n], 1)
            cyc = [raw[wg * (n + 1) + i] / tiles for i in range(n)]
            cyc[-1] += cyc[0]  # the last phase of a tile: at the next tile's top or after the loop
            print(f"[k4-bwd-phase-clocks] launch={name} warpgroup={wg} tiles={tiles} "
                  f"cycles_per_tile={sum(cyc[1:]):.0f} "
                  + " ".join(f"{label.replace(' ', '_')}={x:.0f}"
                             for label, x in zip(names, cyc[1:])))
    ms = cs.kernel_device_ms(call, 10, dict(dq="attention_bwd_dq_wgmma_kernel",
                                            dkdv="attention_bwd_dkdv_wgmma_kernel"))
    print(f"[k4-bwd-phase-clocks] instrumented_dq_ms={ms['dq']:.4f} "
          f"instrumented_dkdv_ms={ms['dkdv']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
