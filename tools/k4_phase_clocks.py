"""Where K4's tensor-core prefill spends its cycles, on the card.

    python3 tools/k4_phase_clocks.py

Copies ``src/repro_torch/csrc/flash_attention.cu`` into the git-ignored
``build/k4_phase_clocks/``, inserts clock64() marks at the phase boundaries
of ``flash_attention_wgmma_kernel`` (thread 0 of each warpgroup sums, per
phase, the cycles since the previous mark), builds it with nvcc, runs it at
chip_smoke.py's prefill shape (``FA_PREFILL``) and prints the mean cycles a
key tile spends in each phase, for each warpgroup, and the instrumented
kernel's device time.  The marks are inserted at lines of the source found
by their text: an edit to those lines stops the script with the line it
could not find.  Needs a card and the CUDA toolkit; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "k4_phase_clocks"
# (a line of the kernel's loop, phase ended just before it)
MARKS = [
    ("        mbar_wait(&v_full, it & 1);\n", "P V (the last tile's)"),
    ("        __syncthreads();  // both warpgroups are done with the last tile's planes\n",
     "TMA waits"),
    ("        split_k(sK, sKlo, tid);\n", "barrier"),
    ("        if (tid == 0 && it + 1 < n_kt) load_v(k0 + BK);\n", "split + barrier"),
    ("        __syncthreads();  // both warpgroups' score products have read K\n", "scores"),
    ("        if (tid == 0 && it + 1 < n_kt) load_k(k0 + BK);\n", "barrier"),
    ("        // Online softmax in base 2 over the valid keys,", "K load issue + score check"),
    ("        // P's A fragments: step j's are", "softmax"),
    ("        // o += P V, 64 output columns at a time", "P split"),
]


def instrumented() -> str:
    src = (CSRC / "flash_attention.cu").read_text()

    def sub(a: str, b: str) -> None:
        nonlocal src
        if a not in src:
            raise SystemExit(f"k4_phase_clocks: line not found in flash_attention.cu: {a!r}")
        src = src.replace(a, b, 1)

    n = len(MARKS) + 1
    sub("namespace {\n\nusing namespace hopper;\n",
        f"__device__ unsigned long long g_clk[2 * {n + 1}];\nnamespace {{\n\n"
        "using namespace hopper;\n")
    sub("    for (int it = 0; it < n_kt; ++it) {\n",
        f"    unsigned long long clk[{n}] = {{}};\n    long long t_prev = clock64();\n"
        "    for (int it = 0; it < n_kt; ++it) {\n")
    for i, (line, _) in enumerate(MARKS):
        sub(line, f"        {{ const long long x = clock64(); clk[{i}] += x - t_prev; t_prev = x; }}\n"
            + line)
    sub("    float* out = static_cast<float*>(a.out);\n",
        f"    {{ const long long x = clock64(); clk[{n - 1}] += x - t_prev; }}\n"
        "    if ((tid & 127) == 0) {\n"
        f"        for (int i = 0; i < {n}; ++i) atomicAdd(&g_clk[{n + 1} * (tid >> 7) + i], clk[i]);\n"
        f"        atomicAdd(&g_clk[{n + 1} * (tid >> 7) + {n}], (unsigned long long)n_kt);\n"
        "    }\n    float* out = static_cast<float*>(a.out);\n")
    sub('extern "C" {\n',
        'extern "C" {\n'
        "int clk_read(unsigned long long* h) {\n"
        "    return (int)cudaMemcpyFromSymbol(h, g_clk, sizeof(g_clk));\n}\n"
        "int clk_zero() {\n    unsigned long long z[sizeof(g_clk) / 8] = {};\n"
        "    return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));\n}\n")
    return src


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("k4_phase_clocks: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.flash_attention import kernel as k4

    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    src = OUT / "flash_attention.cu"
    src.write_text(instrumented())
    lib = OUT / "flash_attention_clocks.so"
    build = subprocess.run([_nvcc._nvcc(), *_nvcc.FLAGS, "-o", str(lib), str(src)],
                           capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    so = ctypes.CDLL(str(lib))
    so.flash_attention_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 23
                                          + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    so.flash_attention_launch.restype = ctypes.c_int
    so.flash_attention_error_string.argtypes = [ctypes.c_int]
    so.flash_attention_error_string.restype = ctypes.c_char_p
    k4._lib = lambda: so

    dev = torch.device("cuda", 0)
    c = cs.FA_PREFILL
    q, k, v = cs._qkv(dev, torch.Generator(device=dev).manual_seed(6), c["B"], c["Hq"],
                      c["Hkv"], c["Tq"], c["buf"], c["D"], torch.float32)

    def call():
        return k4.flash_attention_cuda(q, k, v, causal=True, tk_valid=c["tk_valid"])

    call()
    torch.cuda.synchronize()
    so.clk_zero()
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    n = len(MARKS) + 1
    raw = (ctypes.c_ulonglong * (2 * (n + 1)))()
    so.clk_read(raw)
    names = [name for _, name in MARKS[1:]] + ["P V"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for wg in range(2):
        tiles = max(raw[wg * (n + 1) + n], 1)
        cyc = [raw[wg * (n + 1) + i] / tiles for i in range(n)]
        cyc[-1] += cyc[0]  # P V of a tile: at the next tile's top, or after the loop
        print(f"[k4-phase-clocks] warpgroup={wg} tiles={tiles} cycles_per_tile="
              f"{sum(cyc[1:]):.0f} " + " ".join(f"{name.replace(' ', '_')}={x:.0f}"
                                                for name, x in zip(names, cyc[1:])))
    ms = cs.kernel_device_ms(call, 10, dict(k4="flash_attention_wgmma_kernel"))["k4"]
    print(f"[k4-phase-clocks] instrumented_k4_ms={ms:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
