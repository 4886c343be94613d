// Flash attention backward for Hopper (sm_90a): float32 on the tensor cores
// (3xTF32 wgmma), bfloat16 and the rest in fp32 FMA on the CUDA cores.
//
// No TPU kernel is replaced: the Pallas kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py) has no custom_vjp, and the
// reference trains through its jnp oracle (`use_pallas=False`), so its
// gradient is jax.vjp of `attention_ref`.  That gradient is what this kernel
// computes, for the forward in flash_attention.cu (K4), from q, k, v, the
// forward's output o, the output's gradient dO and the forward's per-row
// log-sum-exp lse (kernels/flash_attention/ref.py, attention_bwd_ref, is its
// plain version): with s = softcap(q . k * scale) on the valid pairs (the
// forward's mask: k_pos < tk_valid, causal, window),
//
//     P = exp(s - lse)   D_i = sum_d dO_id O_id   dS = P (dO V^T - D)
//     dS_raw = dS (1 - tanh^2(s_raw / softcap))   (no softcap: dS_raw = dS)
//     dQ = dS_raw K scale   dK = dS_raw^T Q scale   dV = P^T dO
//
// in fp32 whatever the input type (fp32 or bf16, which the outputs take).
// GQA: dK and dV sum over each KV head's group of query heads.  A row with no
// valid key (lse = -inf) gets P = 0 by a select, so zero gradients, not NaN.
//
// What bounds it on this card.  Per valid (query, key) pair the backward
// needs five D-long dot products (S, dP, dQ, dK, dV: 10 D FLOP) for 3 inputs
// and 3 outputs of D per row: bound by operations.  At the training shape
// (B 4, 24/8 heads, T 1024, D 128, causal: 524,800 pairs a head) that is
// 6.45e10 FLOP: 0.39 ms as three TF32 products on the tensor cores (495
// TFLOP/s), 0.96 ms at the CUDA cores' 67 TFLOP/s in fp32, against 0.08 ms
// of bytes.  One TF32 product misses the fp32 tolerance by about 10x (the
// plain model below, tests/test_torch_kernels_flash_attention_bwd.py), so
// the tensor cores run 3xTF32.
//
// Both instances: two launches, no atomics, so a result repeats bit for bit.
// Launch 1 computes D and dQ over query tiles, one CTA per (packed (t, g)
// rows, KV head, b), the forward's packing, so a K/V tile is read once for
// the group's heads; it walks the key tiles its rows can see (the window's
// horizon to the causal frontier, below tk_valid).  Launch 2 computes dK and
// dV over key tiles, one CTA per (keys, KV head, b), key tile 0 first
// (under a causal mask it sees the most queries), walking the query rows of
// the group's heads whose positions see its keys.  Both recompute S and dP
// (7 D-long products a pair against the bound's 5: the two-launch floor is
// 7/5 of the bound), the price of no atomics on dQ.  Keys at or beyond
// tk_valid get zeros and are never read.
//
// Which calls take which instance (kernels/flash_attention/kernel.py,
// bwd_plan, mirrors `tensor_cores` below): float32 with D <= 128 and 16-byte
// rows and strides (vec) runs on the tensor cores; bfloat16, D > 128 and
// unaligned rows on the CUDA cores.  Shape, type and alignment decide, never
// the values.
//
// Tensor-core design (attention_bwd_dq_wgmma_kernel,
// attention_bwd_dkdv_wgmma_kernel; ref.attention_bwd_3xtf32 is the plain
// model of their arithmetic and tiles):
//  * Every product is 3xTF32 on wgmma: each operand split into TF32 big and
//    small parts by truncation (tma.cuh's split_tf32), small.big +
//    big.small + big.big summed in each k8 step; each tile's product over
//    keys or rows goes into a fresh accumulator that the CUDA cores add in
//    fp32 (a long sum inside the tensor cores drops low bits, as
//    flash_attention.cu and coded_matmul.cu set out).  wgmma reads a TF32
//    operand's top 19 bits, the truncation: a raw tile that arrived by TMA
//    serves as its own big plane (the results are bit for bit those of an
//    explicit big plane on the card), so only the small planes are written.
//  * Operand layout.  A TF32 wgmma takes its shared-memory operand (B) only
//    K-major.  The products over D take B as it arrives by TMA (K, V, Q or
//    dO rows in the 128-byte swizzle, four boxes of 32 columns), each box's
//    32 raw rows followed by their 32 small rows: S = Q K^T and dP = dO V^T
//    in launch 1, S^T = K Q^T and dP^T = V dO^T in launch 2, with A from
//    registers (the staged rows, split as the k8 steps go).  Each k8 step
//    is one wgmma.m64n64k8, big.[big; small] over the box's 64 rows, and
//    one m64n32k8, small.big, into three sums added in fp32 at the end:
//    three 32-wide products a step took about 25 cycles each on the card
//    against 16 at peak.  The products over keys or rows take B transposed: dQ +=
//    dS K needs K^T, dV += P^T dO needs dO^T, dK += dS^T Q needs Q^T.  One
//    pass over each arriving 32-row tile (split_tile) writes its small plane
//    and its transpose's big and small planes, D rows of 32 in the 128-byte
//    swizzle with each group of 8 source rows holding its even rows first,
//    so that the accumulator's registers are the A fragments as they stand
//    (flash_attention.cu does the same for V^T); these run on
//    wgmma.m64n64k8 in two 64-column halves, both issued before either is
//    waited for.
//  * Launch 1: 128 packed rows a CTA in two warpgroups of 64 (256 threads),
//    key tiles of 32 loaded by TMA from maps whose key extent is tk_valid
//    (keys beyond read as zeros), Q and dO staged raw once for the A
//    fragments.  dS = P (dP - D) dtanh by selects, P by ex2.approx, so an
//    invalid pair is exactly 0.  Shared memory: Q and dO 128 KB, K and V
//    with their small rows and K^T's big and small planes 96 KB: 225 KB
//    with the alignment, one CTA an SM.  The next tile's eight boxes are issued by one lane of each warp
//    (one thread issuing all held its warpgroup's next wgmma back by
//    hundreds of cycles) once both warpgroups' S and dP are done.
//  * Launch 2: 64 keys a CTA, K and V staged raw once, query tiles of 32
//    positions of one head (Q and dO by TMA, positions beyond Tq read as
//    zeros; lse and D loaded a tile ahead).  Warpgroup 0 forms S^T, P and
//    the weights w = P dtanh, which it passes through shared memory;
//    warpgroup 1 forms dP^T and dS^T = w (dP^T - D).  Then warpgroup 0 adds
//    P^T dO to dV on dO^T's planes while warpgroup 1 adds dS^T Q to dK on
//    Q^T's: the seven products split evenly, each warpgroup holding one
//    accumulator.  The two run the same code on operands chosen by selects.
//    Shared memory: Q and dO with their small rows and their transposes'
//    planes 128 KB, K and V 64 KB, the weights 16 KB: 209 KB, one CTA an SM.
//  * No wgmma sits in a divergent branch (ptxas would serialize every wgmma
//    of the kernel): masked pairs are computed and zeroed by selects.
//  * Non-finite input within the valid prefix: the split turns an inf into
//    big = inf, small = NaN, so the gradients it reaches come out NaN (the
//    plain version's are inf or NaN there).
//
// CUDA-core design (attention_bwd_dq_kernel, attention_bwd_dkdv_kernel:
// bfloat16, D > 128, unaligned rows):
//  * Launch 1 forms S and dP in registers, dS in shared memory and dQ += dS
//    K in registers; launch 2 holds its K and V tiles and forms S^T and dP^T
//    in registers, P^T and dS^T in shared memory, and dV += P^T dO and dK +=
//    dS^T Q in registers.
//  * A thread owns RT rows (keys in launch 2) and, of a score tile, the
//    columns tx + 16 j; of an output, the columns 4 tx + 64 jd + e.  Tiles
//    are staged as fp32 in dynamic shared memory with rows padded by 4
//    floats, so 16-byte reads of 8 lanes cover the 32 banks, as in K4's
//    CUDA-core instance: 152-170 KB at D = 128, one CTA an SM.
//  * Ragged Tq, Tk and D are masked here; q, k, v, o and dO are read through
//    their strides (last dimension contiguous); dq, dk and dv are written
//    contiguous.
//
// Bound with ctypes: a plain C interface, pointers and the stream passed as
// void*, the launch error returned from cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_rows.cuh"
#include "tma.cuh"

namespace {

using namespace hopper;
using attn::frag_slot;
using attn::load4;
using attn::load_frags;
using attn::stage_frag_rows;
using attn::stage_rows;
using tiles::from_f32;
using tiles::to_f32;

struct BwdArgs {
    const void* q;
    const void* k;
    const void* v;
    const void* o;
    const void* dout;
    const float* lse;  // (B, Hq, Tq), the forward's
    float* delta;      // (B, Hq, Tq): launch 1 writes D, launch 2 reads it
    void* dq;          // (B, Hq, Tq, D), contiguous
    void* dk;          // (B, Hkv, Tk, D), contiguous
    void* dv;          // (B, Hkv, Tk, D), contiguous
    int B, Hq, Hkv, Tq, Tk, D;
    long long qs_b, qs_h, qs_t, ks_b, ks_h, ks_t, vs_b, vs_h, vs_t;  // element strides
    long long os_b, os_h, os_t, gs_b, gs_h, gs_t;                    // of o and dO
    int q_offset, tk_valid, causal, window;  // window <= 0: none
    int vec;                                 // rows load as 4-element vectors
    float scale, softcap;                    // softcap <= 0: none
};

// acc[i][j] (+)= the dot products of rows a_row(i) of sA with rows b_row(j) of
// sB, over D in steps of 4 (columns >= D are zero in both).
template <int NA, int NB, int LD>
__device__ __forceinline__ void dot_tile(float (&acc)[NA][NB], const float* sA, int a0,
                                         int a_step, const float* sB, int b0, int b_step,
                                         int D) {
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
        float4 bv[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j)
            bv[j] = *reinterpret_cast<const float4*>(&sB[(b0 + b_step * j) * LD + d]);
#pragma unroll
        for (int i = 0; i < NA; ++i) {
            const float4 av = *reinterpret_cast<const float4*>(&sA[(a0 + a_step * i) * LD + d]);
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
                acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
                acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
                acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
            }
        }
    }
}

// out[i][4 jd + e] += sum_c w[row0 + i][c] * sX[c][64 jd + 4 tx + e] over c <
// n (a multiple of 4 covering the live columns; w is 0 beyond them).
template <int NR, int NJ, int LDW, int LDX>
__device__ __forceinline__ void weigh_rows(float (&out)[NR][NJ * 4], const float* sW, int row0,
                                           const float* sX, int n, int tx) {
    for (int c = 0; c < n; c += 4) {
        float4 w4[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i)
            w4[i] = *reinterpret_cast<const float4*>(&sW[(row0 + i) * LDW + c]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
            float4 xv[NJ];
#pragma unroll
            for (int jd = 0; jd < NJ; ++jd)
                xv[jd] = *reinterpret_cast<const float4*>(&sX[(c + cc) * LDX + 64 * jd + 4 * tx]);
#pragma unroll
            for (int i = 0; i < NR; ++i) {
                const float w = cc == 0 ? w4[i].x : cc == 1 ? w4[i].y : cc == 2 ? w4[i].z : w4[i].w;
#pragma unroll
                for (int jd = 0; jd < NJ; ++jd) {
                    out[i][4 * jd + 0] = fmaf(w, xv[jd].x, out[i][4 * jd + 0]);
                    out[i][4 * jd + 1] = fmaf(w, xv[jd].y, out[i][4 * jd + 1]);
                    out[i][4 * jd + 2] = fmaf(w, xv[jd].z, out[i][4 * jd + 2]);
                    out[i][4 * jd + 3] = fmaf(w, xv[jd].w, out[i][4 * jd + 3]);
                }
            }
        }
    }
}

// dS from a raw score x = q . k, its dP, the row's lse and D, and whether the
// pair is valid; p receives P.  Selects, never products, so that an invalid
// pair (or a row with lse = -inf) gives exactly 0 whatever its inputs.
__device__ __forceinline__ float grad_score(float x, float dp, float lse, float delta, bool valid,
                                            float scale, float softcap, float inv_cap, float& p) {
    x *= scale;
    float dtanh = 1.f;
    if (softcap > 0.f) {
        const float th = tanhf(x * inv_cap);
        x = softcap * th;
        dtanh = 1.f - th * th;
    }
    p = valid ? expf(x - lse) : 0.f;
    return valid ? p * (dp - delta) * dtanh : 0.f;
}

__device__ __forceinline__ bool pair_valid(int key, int key_end, int qpos, int causal,
                                           int window) {
    return key < key_end && (!causal || key <= qpos) && (window <= 0 || qpos - key < window);
}

template <int DMAX, int BQ, int BK>
constexpr size_t dq_smem() {
    return sizeof(float) * (2 * (size_t)BQ * (DMAX + 4) + 2 * (size_t)BK * (DMAX + 4) +
                            (size_t)BQ * (BK + 4));
}

// Launch 1: D and dQ over query tiles.
template <typename T, int DMAX, int BQ, int BK, int RT>
__global__ void __launch_bounds__(BQ / RT * 16)
attention_bwd_dq_kernel(const BwdArgs a) {
    constexpr int THREADS = BQ / RT * 16;
    constexpr int CT = BK / 16;     // score columns a thread
    constexpr int LD = DMAX + 4;    // Q, dO, K and V row stride (floats)
    constexpr int LDS = BK + 4;     // dS row stride
    constexpr int NJ = DMAX / 64;   // float4 output column groups a thread
    extern __shared__ float4 smem4[];
    float* sQ = reinterpret_cast<float*>(smem4);
    float* sdO = sQ + BQ * LD;
    float* sK = sdO + BQ * LD;
    float* sV = sK + BK * LD;
    float* sdS = sV + BK * LD;

    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int b = blockIdx.z, hk = blockIdx.y, i0 = blockIdx.x * BQ;
    const int group = a.Hq / a.Hkv, n_rows = group * a.Tq, D = a.D;
    const T* kg = static_cast<const T*>(a.k) + (size_t)b * a.ks_b + (size_t)hk * a.ks_h;
    const T* vg = static_cast<const T*>(a.v) + (size_t)b * a.vs_b + (size_t)hk * a.vs_h;
    const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;

    auto head_row = [&](const void* base, long long s_b, long long s_h, long long s_t,
                        int ig) -> const T* {
        const int t = ig / group, h = hk * group + (ig - t * group);
        return static_cast<const T*>(base) + (size_t)b * s_b + (size_t)h * s_h + (size_t)t * s_t;
    };
    stage_rows<T, DMAX, BQ, LD, THREADS>(sQ, D, a.vec, [&](int r) -> const T* {
        return i0 + r < n_rows ? head_row(a.q, a.qs_b, a.qs_h, a.qs_t, i0 + r) : nullptr;
    });
    stage_rows<T, DMAX, BQ, LD, THREADS>(sdO, D, a.vec, [&](int r) -> const T* {
        return i0 + r < n_rows ? head_row(a.dout, a.gs_b, a.gs_h, a.gs_t, i0 + r) : nullptr;
    });
    __syncthreads();

    // The thread's rows: their position, lse and D = sum_d dO O (a half-warp
    // of 16 lanes shares a row group; each lane sums its columns).
    int qpos[RT];
    bool row_ok[RT];
    float lse[RT], delta[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const int r = ty * RT + i, ig = i0 + r;
        row_ok[i] = ig < n_rows;
        const int t = row_ok[i] ? ig / group : 0;
        const int h = hk * group + (row_ok[i] ? ig - t * group : 0);
        qpos[i] = a.q_offset + t;
        float part = 0.f;
        if (row_ok[i]) {
            const T* orow = head_row(a.o, a.os_b, a.os_h, a.os_t, ig);
            for (int d = 4 * tx; d < D; d += 64)
#pragma unroll
                for (int e = 0; e < 4 && d + e < D; ++e)
                    part = fmaf(sdO[r * LD + d + e], to_f32(orow[d + e]), part);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        delta[i] = part;
        const size_t row = ((size_t)b * a.Hq + h) * a.Tq + t;
        lse[i] = row_ok[i] ? a.lse[row] : 0.f;
        if (row_ok[i] && tx == 0) a.delta[row] = part;
    }

    // Keys any row of this CTA can see, as in the forward.
    const int last = min(i0 + BQ, n_rows) - 1;
    const int p_lo = a.q_offset + i0 / group, p_hi = a.q_offset + last / group;
    const int k_lo = a.window > 0 ? max(0, p_lo - a.window + 1) : 0;
    const int k_hi = a.causal ? min(a.tk_valid, p_hi + 1) : a.tk_valid;

    float acc[RT][NJ * 4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < NJ * 4; ++c) acc[i][c] = 0.f;

    for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
        const int nk = min(BK, k_hi - k0);
        __syncthreads();  // the previous tile's K and dS reads are done
        stage_rows<T, DMAX, BK, LD, THREADS>(sK, D, a.vec, [&](int c) -> const T* {
            return c < nk ? kg + (size_t)(k0 + c) * a.ks_t : nullptr;
        });
        stage_rows<T, DMAX, BK, LD, THREADS>(sV, D, a.vec, [&](int c) -> const T* {
            return c < nk ? vg + (size_t)(k0 + c) * a.vs_t : nullptr;
        });
        __syncthreads();

        float s[RT][CT], dp[RT][CT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < CT; ++j) s[i][j] = dp[i][j] = 0.f;
        dot_tile<RT, CT, LD>(s, sQ, ty * RT, 1, sK, tx, 16, D);
        dot_tile<RT, CT, LD>(dp, sdO, ty * RT, 1, sV, tx, 16, D);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < CT; ++j) {
                const int key = k0 + tx + 16 * j;
                float p;
                sdS[(ty * RT + i) * LDS + tx + 16 * j] =
                    grad_score(s[i][j], dp[i][j], lse[i], delta[i],
                               row_ok[i] && pair_valid(key, k_hi, qpos[i], a.causal, a.window),
                               a.scale, a.softcap, inv_cap, p);
            }
        __syncthreads();
        weigh_rows<RT, NJ, LDS, LD>(acc, sdS, ty * RT, sK, (nk + 3) & ~3, tx);
    }

    T* dq = static_cast<T*>(a.dq);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        if (!row_ok[i]) continue;
        const int ig = i0 + ty * RT + i;
        const int t = ig / group, h = hk * group + (ig - t * group);
        T* row = dq + (((size_t)b * a.Hq + h) * a.Tq + t) * D;
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = 64 * jd + 4 * tx + e;
                if (d < D) row[d] = from_f32<T>(acc[i][4 * jd + e] * a.scale);
            }
    }
}

template <int DMAX, int BKV, int BQ>
constexpr size_t dkdv_smem() {
    return sizeof(float) * (2 * (size_t)BKV * (DMAX + 4) + 2 * (size_t)BQ * (DMAX + 4) +
                            2 * (size_t)BKV * (BQ + 4) + 2 * (size_t)BQ);
}

// Launch 2: dK and dV over key tiles.
template <typename T, int DMAX, int BKV, int BQ, int RK>
__global__ void __launch_bounds__(BKV / RK * 16)
attention_bwd_dkdv_kernel(const BwdArgs a) {
    constexpr int THREADS = BKV / RK * 16;
    constexpr int CQ = BQ / 16;     // score columns (query rows) a thread
    constexpr int LD = DMAX + 4;
    constexpr int LDP = BQ + 4;     // P^T and dS^T row stride
    constexpr int NJ = DMAX / 64;
    extern __shared__ float4 smem4[];
    float* sK = reinterpret_cast<float*>(smem4);
    float* sV = sK + BKV * LD;
    float* sQ = sV + BKV * LD;
    float* sdO = sQ + BQ * LD;
    float* sP = sdO + BQ * LD;
    float* sdS = sP + BKV * LDP;
    float* sLse = sdS + BKV * LDP;
    float* sDelta = sLse + BQ;

    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BKV;
    const int group = a.Hq / a.Hkv, D = a.D;
    const int nk = max(0, min(BKV, a.tk_valid - k0));  // valid keys of the tile
    const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;

    float dk[RK][NJ * 4], dv[RK][NJ * 4];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < NJ * 4; ++c) dk[i][c] = dv[i][c] = 0.f;

    // The query positions that see a key of the tile, as packed (t, g) rows.
    int r_lo = 0, r_hi = 0;
    if (nk > 0) {
        const int t_lo = a.causal ? max(0, k0 - a.q_offset) : 0;
        const int t_hi = a.window > 0 ? min(a.Tq, k0 + nk - 1 + a.window - a.q_offset) : a.Tq;
        if (t_lo < t_hi) {
            r_lo = t_lo * group;
            r_hi = t_hi * group;
        }
    }
    if (r_lo < r_hi) {
        const T* kg = static_cast<const T*>(a.k) + (size_t)b * a.ks_b + (size_t)hk * a.ks_h;
        const T* vg = static_cast<const T*>(a.v) + (size_t)b * a.vs_b + (size_t)hk * a.vs_h;
        stage_rows<T, DMAX, BKV, LD, THREADS>(sK, D, a.vec, [&](int c) -> const T* {
            return c < nk ? kg + (size_t)(k0 + c) * a.ks_t : nullptr;
        });
        stage_rows<T, DMAX, BKV, LD, THREADS>(sV, D, a.vec, [&](int c) -> const T* {
            return c < nk ? vg + (size_t)(k0 + c) * a.vs_t : nullptr;
        });
    }
    auto head_row = [&](const void* base, long long s_b, long long s_h, long long s_t,
                        int ig) -> const T* {
        const int t = ig / group, h = hk * group + (ig - t * group);
        return static_cast<const T*>(base) + (size_t)b * s_b + (size_t)h * s_h + (size_t)t * s_t;
    };
    for (int r0 = r_lo; r0 < r_hi; r0 += BQ) {
        __syncthreads();  // the previous rows' Q, dO, P and dS reads are done
        stage_rows<T, DMAX, BQ, LD, THREADS>(sQ, D, a.vec, [&](int r) -> const T* {
            return r0 + r < r_hi ? head_row(a.q, a.qs_b, a.qs_h, a.qs_t, r0 + r) : nullptr;
        });
        stage_rows<T, DMAX, BQ, LD, THREADS>(sdO, D, a.vec, [&](int r) -> const T* {
            return r0 + r < r_hi ? head_row(a.dout, a.gs_b, a.gs_h, a.gs_t, r0 + r) : nullptr;
        });
        for (int r = threadIdx.x; r < BQ; r += THREADS) {
            const int ig = r0 + r, t = ig / group, h = hk * group + (ig - t * group);
            const size_t row = ((size_t)b * a.Hq + h) * a.Tq + t;
            sLse[r] = ig < r_hi ? a.lse[row] : 0.f;
            sDelta[r] = ig < r_hi ? a.delta[row] : 0.f;
        }
        __syncthreads();

        float s[RK][CQ], dp[RK][CQ];
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
            for (int j = 0; j < CQ; ++j) s[i][j] = dp[i][j] = 0.f;
        dot_tile<RK, CQ, LD>(s, sK, ty * RK, 1, sQ, tx, 16, D);
        dot_tile<RK, CQ, LD>(dp, sV, ty * RK, 1, sdO, tx, 16, D);
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
            const int r = tx + 16 * j, ig = r0 + r;
            const int qpos = a.q_offset + ig / group;
#pragma unroll
            for (int i = 0; i < RK; ++i) {
                const int key = k0 + ty * RK + i;
                float p;
                const float ds = grad_score(
                    s[i][j], dp[i][j], sLse[r], sDelta[r],
                    ig < r_hi && pair_valid(key, k0 + nk, qpos, a.causal, a.window), a.scale,
                    a.softcap, inv_cap, p);
                sP[(ty * RK + i) * LDP + r] = p;
                sdS[(ty * RK + i) * LDP + r] = ds;
            }
        }
        __syncthreads();
        weigh_rows<RK, NJ, LDP, LD>(dv, sP, ty * RK, sdO, BQ, tx);
        weigh_rows<RK, NJ, LDP, LD>(dk, sdS, ty * RK, sQ, BQ, tx);
    }

    T* dkg = static_cast<T*>(a.dk) + ((size_t)b * a.Hkv + hk) * a.Tk * D;
    T* dvg = static_cast<T*>(a.dv) + ((size_t)b * a.Hkv + hk) * a.Tk * D;
#pragma unroll
    for (int i = 0; i < RK; ++i) {
        const int key = k0 + ty * RK + i;
        if (key >= a.Tk) continue;
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = 64 * jd + 4 * tx + e;
                if (d < D) {
                    dkg[(size_t)key * D + d] = from_f32<T>(dk[i][4 * jd + e] * a.scale);
                    dvg[(size_t)key * D + d] = from_f32<T>(dv[i][4 * jd + e]);
                }
            }
    }
}

// ---- float32 on the tensor cores: 3xTF32 wgmma, tiles by TMA -------------------

namespace tc {
constexpr int DMAX = 128;     // head dim of the instance (a smaller D: zero columns)
constexpr int THREADS = 256;  // two warpgroups
constexpr int Q_ROWS = 128;   // launch 1: packed (t, g) rows a CTA, 64 a warpgroup
constexpr int Q_KEYS = 32;    // launch 1: keys a tile
constexpr int KV_KEYS = 64;   // launch 2: keys a CTA
constexpr int KV_ROWS = 32;   // launch 2: query positions (one head) a tile
constexpr int PLANE = 32 * DMAX;  // floats of a 32-row tile or of its transpose: 16 KB
// A 32-row tile as the products over D read it: four boxes of 32 columns,
// each its 32 raw rows (which TMA writes) followed by their 32 small rows.
constexpr int BOX = 2 * 32 * 32;
constexpr int PAIRED = DMAX / 32 * BOX;  // 32 KB
// Launch 1: K and V paired with their small rows, K^T's two planes; Q, dO.
constexpr size_t DQ_SMEM = sizeof(float) * (2 * PAIRED + 2 * PLANE + 2 * Q_ROWS * DMAX) + 1024;
// Launch 2: Q and dO paired with their small rows, their transposes' two
// planes each; K, V; the weights P dtanh passed between the warpgroups;
// lse, D.
constexpr size_t DKDV_SMEM = sizeof(float) * (2 * PAIRED + 4 * PLANE + 2 * KV_KEYS * DMAX +
                                              2 * 16 * 128 + 2 * KV_ROWS) + 1024;
constexpr float LOG2E = 1.4426950408889634f;
}  // namespace tc

// 2^x by the special function unit (ex2.approx.ftz: relative error about
// 2^-22, results below 2^-126 flushed to zero), as the forward takes it.
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// P = exp(softcap(x scale) - lse) of a raw score x, given lse2 = lse
// log2(e), and the softcap's derivative dtanh (1 without a softcap).
__device__ __forceinline__ float tc_prob(float x, float lse2, float scale, float softcap,
                                         float inv_cap, float& dtanh) {
    if (softcap > 0.f) {
        const float th = tanhf(x * scale * inv_cap);
        dtanh = 1.f - th * th;
        return exp2_approx(fmaf(softcap * th, tc::LOG2E, -lse2));
    }
    dtanh = 1.f;
    return exp2_approx(fmaf(x, scale * tc::LOG2E, -lse2));
}

struct TileMaps {
    CUtensorMap a, b;  // launch 1: k, v; launch 2: q, dO
};

// The small rows of a paired tile (tc::BOX) whose raw rows arrived by TMA
// (128-byte swizzle, K-major as wgmma reads it), at the same offsets 32
// rows further.  The raw rows are their own big part: wgmma reads a TF32
// operand's top 19 bits, the truncation split_tf32 takes.
__device__ __forceinline__ void split_small(float* paired, int tid) {
#pragma unroll
    for (int i = 0; i < tc::PLANE / 4 / tc::THREADS; ++i) {
        const int off = (tid + i * tc::THREADS) * 4;
        float* raw = paired + (off >> 10) * tc::BOX + (off & 1023);
        const float4 v = *reinterpret_cast<const float4*>(raw);
        uint4 big, small;
        split_tf32(v.x, big.x, small.x);
        split_tf32(v.y, big.y, small.y);
        split_tf32(v.z, big.z, small.z);
        split_tf32(v.w, big.w, small.w);
        sts128(raw + 1024, small.x, small.y, small.z, small.w);
    }
}

// A paired 32-row tile whose raw rows arrived by TMA (128-byte swizzle),
// split into TF32 big and small parts in one pass: its small rows (as
// split_small; for the products over D), and the big and small planes of
// its transpose in `thi` and `tlo`: DMAX rows of the 32 source rows, 128
// bytes each in the 128-byte swizzle, where each group of 8 source rows
// holds its even rows first (source row 8s + 2u + e at k index u + 4e of
// step s).  A 64 x 32 accumulator's registers (columns 2t, 2t + 1 of each
// 8) are then the A fragments (k indices t, t + 4) as they stand.
__device__ __forceinline__ void split_tile(float* paired, float* thi, float* tlo, int tid) {
#pragma unroll
    for (int i = 0; i < tc::PLANE / 4 / tc::THREADS; ++i) {
        const int item = tid + i * tc::THREADS;  // (chunk, d), d fastest
        const int d = item & (tc::DMAX - 1), c = item >> 7;
        const int row0 = 8 * (c >> 1) + (c & 1);
        uint32_t big[4], small[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int row = row0 + 2 * u;  // a warp reads one swizzled 128-byte row
            const int at = (d >> 5) * tc::BOX + row * 32 +
                           ((((d & 31) >> 2) ^ (row & 7)) << 2) + (d & 3);
            split_tf32(paired[at], big[u], small[u]);
            paired[at + 1024] = __uint_as_float(small[u]);
        }
        const int off = d * 32 + ((c ^ (d & 7)) << 2);
        sts128(thi + off, big[0], big[1], big[2], big[3]);  // 16 bytes: conflict-free
        sts128(tlo + off, small[0], small[1], small[2], small[3]);
    }
}

// out (this warpgroup's 64 rows x 32, this thread's 16) = A B^T in
// 3xTF32 over D: A's rows r_lo and r_lo + 8 from the staged tile sA, split
// in registers two k8 steps at a time (the next pair's loads and split
// while one pair is in flight); B a paired tile (tc::BOX).  Each k8 step is
// two wgmma: big.[big; small] as one 64-wide product over the box's raw
// and small rows, and small.big; the three sums are added in fp32 at the
// end.  (Three 32-wide products a step ran at about 25 cycles each on the
// card against 16 at peak; the pairing takes 7% off this phase.)
__device__ __forceinline__ void rows_product(float (&out)[16], const float* sA,
                                             const float* sB, int r_lo, int t) {
    uint32_t ab[2][2][4], as[2][2][4];
    float wide[32], narrow[16];  // the first wgmma of each does not read it
#pragma unroll
    for (int c = 0; c < tc::DMAX / 16; ++c) {  // columns >= D are zero
        const int blk = c >> 1, half = c & 1;    // 32-column block, its first or second 16
        load_frags(sA, r_lo, t, blk, half, ab[c & 1], as[c & 1]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            // the k8 step's bytes in the 128-byte row
            const uint64_t desc = wgmma_desc(sB + blk * tc::BOX, (2 * half + j) * 32);
            wgmma_tf32_m64n64k8(wide, ab[c & 1][j], desc, c > 0 || j > 0);
            wgmma_tf32_m64n32k8(narrow, as[c & 1][j], desc, c > 0 || j > 0);
        }
        wgmma_commit();
        if (c > 0) {  // the previous pair is done: its registers may be reused
            wgmma_wait<1>();
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int u = 0; u < 4; ++u) keep_live(ab[(c - 1) & 1][j][u], as[(c - 1) & 1][j][u]);
        }
    }
    wgmma_wait<0>();
    fence_acc(wide);
    fence_acc(narrow);
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) keep_live(ab[b][j][u], as[b][j][u]);
    // wide's columns 0-31 are big.big, 32-63 big.small (registers 16 on).
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = (wide[i] + wide[16 + i]) + narrow[i];
}

// out[32h + i] += (A . B)[64 rows x columns 64h.., this thread's 32] for h
// = 0, 1, each half in a fresh accumulator added in fp32 (a long sum inside
// the tensor cores drops low bits), in 3xTF32: A (64 x 32) from a 64 x 32
// accumulator's registers split into big and small (step j's fragments are
// registers 4j + {0, 2, 1, 3}), B the big and small planes of a transposed
// tile (split_tile).  Both halves are issued before the first is waited for.
__device__ __forceinline__ void acc_product(float (&out)[64], uint32_t (&big)[16],
                                            uint32_t (&small)[16], const float* sThi,
                                            const float* sTlo) {
    float tile[2][32];  // the first wgmma of each half does not read it
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < tc::DMAX / 64; ++h) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint64_t bh = wgmma_desc(sThi + h * 64 * 32, j * 32);
            const uint64_t bl = wgmma_desc(sTlo + h * 64 * 32, j * 32);
            wgmma_tf32_m64n64k8(tile[h], small[4 * j], small[4 * j + 2], small[4 * j + 1],
                                small[4 * j + 3], bh, j > 0);
            wgmma_tf32_m64n64k8(tile[h], big[4 * j], big[4 * j + 2], big[4 * j + 1],
                                big[4 * j + 3], bl, 1);
            wgmma_tf32_m64n64k8(tile[h], big[4 * j], big[4 * j + 2], big[4 * j + 1],
                                big[4 * j + 3], bh, 1);
        }
        wgmma_commit();
    }
    wgmma_wait<1>();
    fence_acc(tile[0]);
#pragma unroll
    for (int i = 0; i < 32; ++i) out[i] += tile[0][i];
    wgmma_wait<0>();
    fence_acc(tile[1]);
#pragma unroll
    for (int i = 0; i < 16; ++i) keep_live(big[i], small[i]);
#pragma unroll
    for (int i = 0; i < 32; ++i) out[32 + i] += tile[1][i];
}

// Rows r_lo + 8 rr of a 64 x 128 accumulator (o[32h + 4j + e]: row r_lo + 8
// (e / 2), column 64h + 8j + 2t + e % 2) times `mul` into a contiguous row
// of D floats.
__device__ __forceinline__ void store_row(float* row, const float (&o)[64], int rr, int t, int D,
                                          float mul) {
#pragma unroll
    for (int i = 0; i < 64; i += 4) {  // columns 64 (i / 32) + 8 (i % 32 / 4) + 2t, + 1
        const int d = 64 * (i >> 5) + 2 * (i & 31) + 2 * t;
        if (d < D)
            *reinterpret_cast<float2*>(row + d) =
                make_float2(o[i + 2 * rr] * mul, o[i + 2 * rr + 1] * mul);
    }
}

// Launch 1 on the tensor cores: D and dQ.  One CTA per (128 packed (t, g)
// rows, KV head, b), the last query tiles first (they see the most keys
// under a causal mask): two warpgroups of 64 rows sharing each K/V tile of
// 32 keys, loaded by TMA (K and V as four swizzled boxes each) from maps
// whose key extent is tk_valid.  Q and dO are staged raw
// once.  Each tile: the CTA writes K's small rows and K^T's planes in one
// pass (split_tile) and V's small rows (split_small); each warpgroup forms
// S = Q K^T and dP = dO V^T (rows_product), dS by selects, and dQ += dS K
// on K^T's planes (acc_product).
__global__ void __launch_bounds__(tc::THREADS, 1)
attention_bwd_dq_wgmma_kernel(const __grid_constant__ TileMaps maps, const BwdArgs a) {
    using namespace tc;
    extern __shared__ uint8_t bwd_smem_raw[];
    // 1024-byte aligned for the 128-byte swizzle, by an offset from the
    // shared array, so that the compiler keeps shared (not generic) accesses.
    const uint32_t pad = (1024 - (smem_u32(bwd_smem_raw) & 1023)) & 1023;
    float* sK = reinterpret_cast<float*>(bwd_smem_raw + pad);  // paired (BOX)
    float* sV = sK + PAIRED;                                   // paired
    float* sKThi = sV + PAIRED;
    float* sKTlo = sKThi + PLANE;
    float* sQ = sKTlo + PLANE;
    float* sdO = sQ + Q_ROWS * DMAX;
    __shared__ __align__(8) uint64_t kv_full;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int group = a.Hq / a.Hkv, n_rows = group * a.Tq, D = a.D;
    const int n_qt = (n_rows + Q_ROWS - 1) / Q_ROWS, per_qt = a.Hkv * a.B;
    const int qt = n_qt - 1 - (int)(blockIdx.x / per_qt);
    const int hk = (int)(blockIdx.x % per_qt) % a.Hkv, b = (int)(blockIdx.x % per_qt) / a.Hkv;
    const int i0 = qt * Q_ROWS;
    // Keys any row of this CTA can see, as in the forward.
    const int last = min(i0 + Q_ROWS, n_rows) - 1;
    const int p_lo = a.q_offset + i0 / group, p_hi = a.q_offset + last / group;
    const int k_lo = a.window > 0 ? max(0, p_lo - a.window + 1) : 0;
    const int k_hi = a.causal ? min(a.tk_valid, p_hi + 1) : a.tk_valid;
    const int n_kt = k_lo < k_hi ? (k_hi - k_lo + Q_KEYS - 1) / Q_KEYS : 0;

    auto load_kv = [&](int k0) {
        mbar_expect_tx(&kv_full, 2 * PLANE * sizeof(float));
#pragma unroll
        for (int c = 0; c < DMAX / 32; ++c) {
            tma_load_4d(sK + c * BOX, &maps.a, 32 * c, k0, hk, b, &kv_full);
            tma_load_4d(sV + c * BOX, &maps.b, 32 * c, k0, hk, b, &kv_full);
        }
    };
    // In the loop, lane 0 of each warp loads one box (warps 0-3 K's, 4-7
    // V's), warp 0 announcing the bytes first: one thread issuing all eight
    // held its warpgroup's next wgmma back by hundreds of cycles.
    auto load_kv_box = [&](int k0) {
        if (lane == 0) {
            if (warp == 0) mbar_expect_tx(&kv_full, 2 * PLANE * sizeof(float));
            const int c = warp & 3;
            tma_load_4d((warp < 4 ? sK : sV) + c * BOX, warp < 4 ? &maps.a : &maps.b,
                        32 * c, k0, hk, b, &kv_full);
        }
    };
    if (tid == 0) {
        mbar_init(&kv_full, 1);
        mbar_init_fence();
        if (n_kt > 0) load_kv(k_lo);
    }
    auto head_row = [&](const void* base, long long s_b, long long s_h, long long s_t,
                        int ig) -> const float* {
        const int tq = ig / group, h = hk * group + (ig - tq * group);
        return static_cast<const float*>(base) + (size_t)b * s_b + (size_t)h * s_h +
               (size_t)tq * s_t;
    };
    stage_frag_rows<Q_ROWS, THREADS>(sQ, D, [&](int r) -> const float* {
        return i0 + r < n_rows ? head_row(a.q, a.qs_b, a.qs_h, a.qs_t, i0 + r) : nullptr;
    });
    stage_frag_rows<Q_ROWS, THREADS>(sdO, D, [&](int r) -> const float* {
        return i0 + r < n_rows ? head_row(a.dout, a.gs_b, a.gs_h, a.gs_t, i0 + r) : nullptr;
    });
    __syncthreads();  // the barrier's initialisation, Q and dO

    // Warpgroup wgi owns rows wgi*64 .. +63 of the CTA, warp wq of it rows
    // wq*16 .. +15, lane (g, t) rows r_lo and r_lo + 8: their keys [key_lo,
    // key_hi), lse and D = sum_d dO O (the quad's 4 lanes sum 32 columns
    // each).
    const int wgi = tid >> 7, wq = warp & 3, g = lane >> 2, t = lane & 3;
    const int r_lo = wgi * 64 + wq * 16 + g;
    int key_lo[2], key_hi[2];
    float lse2[2], delta[2];  // lse log2(e)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int r = r_lo + 8 * rr, ig = i0 + r;
        const bool ok = ig < n_rows;
        const int tq = ok ? ig / group : 0, h = hk * group + (ok ? ig - tq * group : 0);
        const int qpos = a.q_offset + tq;
        key_lo[rr] = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
        key_hi[rr] = !ok ? 0 : a.causal ? min(k_hi, qpos + 1) : k_hi;  // k_hi <= tk_valid
        key_hi[rr] = max(key_hi[rr], key_lo[rr]);
        float part = 0.f;
        if (ok) {
            const float* orow = head_row(a.o, a.os_b, a.os_h, a.os_t, ig);
#pragma unroll 2
            for (int d = 32 * t; d < 32 * t + 32; d += 4) {
                if (d >= D) break;
                const float4 ov = load4(orow + d);
                part = fmaf(sdO[frag_slot(r, d)], ov.x, part);
                part = fmaf(sdO[frag_slot(r, d + 1)], ov.y, part);
                part = fmaf(sdO[frag_slot(r, d + 2)], ov.z, part);
                part = fmaf(sdO[frag_slot(r, d + 3)], ov.w, part);
            }
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        delta[rr] = part;
        const size_t row = ((size_t)b * a.Hq + h) * a.Tq + tq;
        lse2[rr] = ok ? a.lse[row] * LOG2E : 0.f;
        if (ok && t == 0) a.delta[row] = part;
    }
    const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;

    float dq[64], s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    for (int it = 0; it < n_kt; ++it) {
        const int k0 = k_lo + it * Q_KEYS;
        mbar_wait(&kv_full, it & 1);
        __syncthreads();  // both warpgroups are done with the last tile's K^T planes
        split_tile(sK, sKThi, sKTlo, tid);
        split_small(sV, tid);
        fence_proxy_async();  // the planes are wgmma's operands
        __syncthreads();
        // No branch around a wgmma: ptxas serializes wgmma in divergent code.
        rows_product(s, sQ, sK, r_lo, t);
        rows_product(dp, sdO, sV, r_lo, t);
        __syncthreads();  // both warpgroups' products have read K and V
        if (it + 1 < n_kt) load_kv_box(k0 + Q_KEYS);

        // dS = P (dP - D) dtanh by selects, so an invalid pair (or a row
        // with lse = -inf) gives exactly 0; split for dQ.
        uint32_t dsb[16], dss[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int rr = (i >> 1) & 1, key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const bool valid =
                (unsigned)(key - key_lo[rr]) < (unsigned)(key_hi[rr] - key_lo[rr]);
            float dtanh;
            const float p = tc_prob(s[i], lse2[rr], a.scale, a.softcap, inv_cap, dtanh);
            split_tf32(valid ? p * (dp[i] - delta[rr]) * dtanh : 0.f, dsb[i], dss[i]);
        }
        acc_product(dq, dsb, dss, sKThi, sKTlo);
    }

    float* dqg = static_cast<float*>(a.dq);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int ig = i0 + r_lo + 8 * rr;
        if (ig >= n_rows) continue;
        const int tq = ig / group, h = hk * group + (ig - tq * group);
        store_row(dqg + (((size_t)b * a.Hq + h) * a.Tq + tq) * D, dq, rr, t, D, a.scale);
    }
}

// Launch 2 on the tensor cores: dK and dV.  One CTA per (64 keys, KV head,
// b), key block 0 first (under a causal mask it sees the most queries); K
// and V staged raw once.  It walks the query positions that see a key of
// the block, 32 at a time, for each head of the group, each tile's Q and dO
// loaded by TMA (four swizzled boxes each; positions beyond Tq read as
// zeros), its lse and D a tile ahead.  Each tile: the CTA splits Q
// and dO into their planes and their transposes' (split_tile).  Warpgroup
// 0 forms S^T = K Q^T, P and the weights w = P dtanh by selects, and passes w through
// shared memory; warpgroup 1 forms dP^T = V dO^T and dS^T = w (dP^T - D).
// Then warpgroup 0 adds P^T dO to dV on dO^T's planes, warpgroup 1 dS^T Q
// to dK on Q^T's planes.  The two run the same code on other operands,
// chosen by selects (no branch around a wgmma).
__global__ void __launch_bounds__(tc::THREADS, 1)
attention_bwd_dkdv_wgmma_kernel(const __grid_constant__ TileMaps maps, const BwdArgs a) {
    using namespace tc;
    extern __shared__ uint8_t bwd_smem_raw[];
    const uint32_t pad = (1024 - (smem_u32(bwd_smem_raw) & 1023)) & 1023;
    float* sQ = reinterpret_cast<float*>(bwd_smem_raw + pad);  // paired (BOX)
    float* sdO = sQ + PAIRED;                                  // paired
    float* sQThi = sdO + PAIRED;
    float* sQTlo = sQThi + PLANE;
    float* sdOThi = sQTlo + PLANE;
    float* sdOTlo = sdOThi + PLANE;
    float* sK = sdOTlo + PLANE;
    float* sV = sK + KV_KEYS * DMAX;
    float* sW = sV + KV_KEYS * DMAX;  // (warpgroup, register, thread)
    float* sLse = sW + 2 * 16 * 128;
    float* sDelta = sLse + KV_ROWS;
    __shared__ __align__(8) uint64_t rows_full;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int group = a.Hq / a.Hkv, D = a.D, per_kb = a.Hkv * a.B;
    const int kb = (int)(blockIdx.x / per_kb);
    const int hk = (int)(blockIdx.x % per_kb) % a.Hkv, b = (int)(blockIdx.x % per_kb) / a.Hkv;
    const int k0 = kb * KV_KEYS;
    const int nk = max(0, min(KV_KEYS, a.tk_valid - k0));  // valid keys of the block
    // The query positions that see a key of the block.
    int t_lo = 0, t_hi = 0;
    if (nk > 0) {
        t_lo = a.causal ? max(0, k0 - a.q_offset) : 0;
        t_hi = a.window > 0 ? min(a.Tq, k0 + nk - 1 + a.window - a.q_offset) : a.Tq;
    }
    const int n_pt = t_lo < t_hi ? (t_hi - t_lo + KV_ROWS - 1) / KV_ROWS : 0;
    const int n_tiles = group * n_pt;  // (head, position tile), head slowest

    auto load_rows = [&](int it) {
        const int h = hk * group + it / n_pt, t0 = t_lo + it % n_pt * KV_ROWS;
        mbar_expect_tx(&rows_full, 2 * PLANE * sizeof(float));
#pragma unroll
        for (int c = 0; c < DMAX / 32; ++c) {
            tma_load_4d(sQ + c * BOX, &maps.a, 32 * c, t0, h, b, &rows_full);
            tma_load_4d(sdO + c * BOX, &maps.b, 32 * c, t0, h, b, &rows_full);
        }
    };
    // In the loop, lane 0 of each warp loads one box (warps 0-3 Q's, 4-7
    // dO's), warp 0 announcing the bytes first.
    auto load_rows_box = [&](int it) {
        if (lane == 0) {
            const int h = hk * group + it / n_pt, t0 = t_lo + it % n_pt * KV_ROWS, c = warp & 3;
            if (warp == 0) mbar_expect_tx(&rows_full, 2 * PLANE * sizeof(float));
            tma_load_4d((warp < 4 ? sQ : sdO) + c * BOX, warp < 4 ? &maps.a : &maps.b,
                        32 * c, t0, h, b, &rows_full);
        }
    };
    if (tid == 0) {
        mbar_init(&rows_full, 1);
        mbar_init_fence();
        if (n_tiles > 0) load_rows(0);
    }
    if (n_tiles > 0) {
        const float* kg = static_cast<const float*>(a.k) + (size_t)b * a.ks_b + (size_t)hk * a.ks_h;
        const float* vg = static_cast<const float*>(a.v) + (size_t)b * a.vs_b + (size_t)hk * a.vs_h;
        stage_frag_rows<KV_KEYS, THREADS>(sK, D, [&](int r) -> const float* {
            return r < nk ? kg + (size_t)(k0 + r) * a.ks_t : nullptr;
        });
        stage_frag_rows<KV_KEYS, THREADS>(sV, D, [&](int r) -> const float* {
            return r < nk ? vg + (size_t)(k0 + r) * a.vs_t : nullptr;
        });
    }

    // Warpgroup wgi: 0 forms P and dV, 1 dS and dK.  Warp wq of it owns the
    // block's keys wq*16 .. +15, lane (g, t) keys r_lo and r_lo + 8.
    const int wgi = tid >> 7, wq = warp & 3, g = lane >> 2, t = lane & 3, wt = tid & 127;
    const int r_lo = wq * 16 + g;
    const float* sA = wgi ? sV : sK;          // S^T = K Q^T, dP^T = V dO^T
    const float* sB = wgi ? sdO : sQ;
    const float* sThi = wgi ? sQThi : sdOThi;  // dK += dS^T Q, dV += P^T dO
    const float* sTlo = wgi ? sQTlo : sdOTlo;
    const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;
    // The positions key k0 + r_lo + 8 rr pairs with: [t_min, t_max).
    int t_min[2], t_max[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int key = k0 + r_lo + 8 * rr;
        t_min[rr] = a.causal ? max(0, key - a.q_offset) : 0;
        t_max[rr] = key >= k0 + nk ? 0
                    : a.window > 0 ? min(a.Tq, key + a.window - a.q_offset) : a.Tq;
        t_max[rr] = max(t_max[rr], t_min[rr]);
    }

    // Tile it's lse and D, in the first warp's registers, loaded a tile
    // ahead so that their latency hides behind a tile's work (nothing reads
    // them until they are stored to shared memory).
    float row_lse = 0.f, row_delta = 0.f;
    auto load_row_stats = [&](int it) {
        const int h = hk * group + it / n_pt, tq = t_lo + it % n_pt * KV_ROWS + tid;
        const size_t row = ((size_t)b * a.Hq + h) * a.Tq + tq;
        row_lse = row_delta = 0.f;
        if (tq < a.Tq) {
            row_lse = a.lse[row];
            row_delta = a.delta[row];
        }
    };
    if (tid < KV_ROWS && n_tiles > 0) load_row_stats(0);

    float acc[64], s[16];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    __syncthreads();  // the barrier's initialisation, K and V
    for (int it = 0; it < n_tiles; ++it) {
        const int t0 = t_lo + it % n_pt * KV_ROWS;
        mbar_wait(&rows_full, it & 1);
        __syncthreads();  // the last tile's planes, weights, lse and D are read
        split_tile(sQ, sQThi, sQTlo, tid);
        split_tile(sdO, sdOThi, sdOTlo, tid);
        if (tid < KV_ROWS) {
            sLse[tid] = row_lse * LOG2E;
            sDelta[tid] = row_delta;
        }
        fence_proxy_async();  // the planes are wgmma's operands
        __syncthreads();
        rows_product(s, sA, sB, r_lo, t);

        // s[4j + e]: key k0 + r_lo + 8 (e / 2), position t0 + 8j + 2t + e % 2.
        bool valid[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int rr = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * t + (i & 1), tq = t0 + col;
            valid[i] = (unsigned)(tq - t_min[rr]) < (unsigned)(t_max[rr] - t_min[rr]);
            // Warpgroup 0: P and w = P dtanh (sLse holds lse log2(e)).
            float dtanh;
            const float pr = tc_prob(s[i], sLse[col], a.scale, a.softcap, inv_cap, dtanh);
            const float p = valid[i] ? pr : 0.f;
            sW[(wgi * 16 + i) * 128 + wt] = p * dtanh;
            s[i] = wgi ? s[i] : p;
        }
        __syncthreads();  // the weights are written; both products have read Q and dO
        if (it + 1 < n_tiles) {
            load_rows_box(it + 1);
            if (tid < KV_ROWS) load_row_stats(it + 1);
        }
        uint32_t big[16], small[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            // Warpgroup 1: dS^T = w (dP^T - D), exactly 0 where invalid.
            const int col = 8 * (i >> 2) + 2 * t + (i & 1);
            const float ds = valid[i] ? sW[i * 128 + wt] * (s[i] - sDelta[col]) : 0.f;
            split_tf32(wgi ? ds : s[i], big[i], small[i]);
        }
        acc_product(acc, big, small, sThi, sTlo);
    }

    // Keys at or beyond tk_valid (and below Tk) get zeros: every pair of
    // theirs is invalid.
    float* out = static_cast<float*>(wgi ? a.dk : a.dv) + ((size_t)b * a.Hkv + hk) * a.Tk * D;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int key = k0 + r_lo + 8 * rr;
        if (key < a.Tk) store_row(out + (size_t)key * D, acc, rr, t, D, wgi ? a.scale : 1.f);
    }
}

// A 4D TMA map (D, extent, heads, B) of a float32 tensor with the given
// element strides over (T, H, B), read in boxes of 32 columns x `rows` in
// the 128-byte swizzle; rows at or beyond `extent` and columns beyond D
// read as zeros.
bool tile_map(CUtensorMap* map, const void* base, int D, int extent, int heads, int B,
              long long s_t, long long s_h, long long s_b, int rows) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(extent > 1 ? extent : 1),
                                (cuuint64_t)heads, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)s_t * sizeof(float),
                                   (cuuint64_t)s_h * sizeof(float),
                                   (cuuint64_t)s_b * sizeof(float)};
    const cuuint32_t box[4] = {32, (cuuint32_t)rows, 1, 1};
    return float_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The runtime call comes before the maps' encoding: it makes the device's
// context current in a thread that has none yet (autograd runs the backward
// on a thread of its own), which cuTensorMapEncodeTiled needs.
int launch_dq_wgmma(const BwdArgs& a, cudaStream_t s) {
    cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_wgmma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(tc::DQ_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    TileMaps maps;
    if (!tile_map(&maps.a, a.k, a.D, a.tk_valid, a.Hkv, a.B, a.ks_t, a.ks_h, a.ks_b,
                  tc::Q_KEYS) ||
        !tile_map(&maps.b, a.v, a.D, a.tk_valid, a.Hkv, a.B, a.vs_t, a.vs_h, a.vs_b,
                  tc::Q_KEYS))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long ctas =
        (long long)((a.Hq / a.Hkv * a.Tq + tc::Q_ROWS - 1) / tc::Q_ROWS) * a.Hkv * a.B;
    if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    attention_bwd_dq_wgmma_kernel<<<(unsigned)ctas, tc::THREADS, tc::DQ_SMEM, s>>>(maps, a);
    return static_cast<int>(cudaGetLastError());
}

int launch_dkdv_wgmma(const BwdArgs& a, cudaStream_t s) {
    cudaError_t err = cudaFuncSetAttribute(attention_bwd_dkdv_wgmma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(tc::DKDV_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    TileMaps maps;
    if (!tile_map(&maps.a, a.q, a.D, a.Tq, a.Hq, a.B, a.qs_t, a.qs_h, a.qs_b, tc::KV_ROWS) ||
        !tile_map(&maps.b, a.dout, a.D, a.Tq, a.Hq, a.B, a.gs_t, a.gs_h, a.gs_b, tc::KV_ROWS))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long ctas =
        (long long)((a.Tk + tc::KV_KEYS - 1) / tc::KV_KEYS) * a.Hkv * a.B;
    if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    attention_bwd_dkdv_wgmma_kernel<<<(unsigned)ctas, tc::THREADS, tc::DKDV_SMEM, s>>>(maps, a);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX, int BQ, int BK, int RT>
int launch_dq(const BwdArgs& a, cudaStream_t s) {
    constexpr size_t smem = dq_smem<DMAX, BQ, BK>();
    auto kernel = attention_bwd_dq_kernel<T, DMAX, BQ, BK, RT>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_rows = a.Hq / a.Hkv * a.Tq;
    kernel<<<dim3((n_rows + BQ - 1) / BQ, a.Hkv, a.B), BQ / RT * 16, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX, int BKV, int BQ, int RK>
int launch_dkdv(const BwdArgs& a, cudaStream_t s) {
    constexpr size_t smem = dkdv_smem<DMAX, BKV, BQ>();
    auto kernel = attention_bwd_dkdv_kernel<T, DMAX, BKV, BQ, RK>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3((a.Tk + BKV - 1) / BKV, a.Hkv, a.B), BKV / RK * 16, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// Tiles by head size (kernels/flash_attention/kernel.py, bwd_plan, mirrors
// this): 64 rows and 64 keys up to D = 128 (152 KB and 170 KB of shared
// memory at D = 128), 32 and 32 at D = 256.
template <typename T>
int dispatch_dq(const BwdArgs& a, cudaStream_t s) {
    if (a.D <= 64) return launch_dq<T, 64, 64, 64, 4>(a, s);
    if (a.D <= 128) return launch_dq<T, 128, 64, 64, 4>(a, s);
    if (a.D <= 256) return launch_dq<T, 256, 32, 32, 2>(a, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_dkdv(const BwdArgs& a, cudaStream_t s) {
    if (a.D <= 64) return launch_dkdv<T, 64, 64, 64, 4>(a, s);
    if (a.D <= 128) return launch_dkdv<T, 128, 64, 64, 4>(a, s);
    if (a.D <= 256) return launch_dkdv<T, 256, 32, 32, 2>(a, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Float32 with D <= 128 and 16-byte rows and strides (vec) runs on the
// tensor cores; bfloat16, D > 128 and unaligned rows on the CUDA cores.
// kernels/flash_attention/kernel.py's bwd_plan mirrors this choice.
bool tensor_cores(const BwdArgs& a, int dtype) { return dtype == 0 && a.vec && a.D <= tc::DMAX; }

BwdArgs make_args(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Hq,
                  int Hkv, int Tq, int Tk, int D, int qs_b, int qs_h, int qs_t, int ks_b,
                  int ks_h, int ks_t, int vs_b, int vs_h, int vs_t, int os_b, int os_h, int os_t,
                  int gs_b, int gs_h, int gs_t, int q_offset, int tk_valid, int causal,
                  int window, int vec, float scale, float softcap) {
    return BwdArgs{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
                   dq, dk, dv, B, Hq, Hkv, Tq, Tk, D, qs_b, qs_h, qs_t, ks_b, ks_h, ks_t, vs_b,
                   vs_h, vs_t, os_b, os_h, os_t, gs_b, gs_h, gs_t, q_offset, tk_valid, causal,
                   window, vec, scale, softcap};
}

}  // namespace

extern "C" {

// The two launches of the backward, in this order on one stream (the second
// reads the D that the first leaves in `delta`).  q (B, Hq, Tq, D), k and v
// (B, Hkv, Tk, D), o and dout (B, Hq, Tq, D), each by its element strides
// over (B, H, T) with the last dimension contiguous, of one type (dtype 0:
// float32, 1: bfloat16); lse and delta (B, Hq, Tq) float32 contiguous; dq,
// dk and dv contiguous of the inputs' type.  vec != 0 asserts D, every
// stride and every pointer allow 4-element loads.  Each returns the first
// CUDA error.
#define BWD_PARAMS                                                                            \
    const void *q, const void *k, const void *v, const void *o, const void *dout,            \
        const void *lse, void *delta, void *dq, void *dk, void *dv, int B, int Hq, int Hkv,  \
        int Tq, int Tk, int D, int qs_b, int qs_h, int qs_t, int ks_b, int ks_h, int ks_t,   \
        int vs_b, int vs_h, int vs_t, int os_b, int os_h, int os_t, int gs_b, int gs_h,      \
        int gs_t, int q_offset, int tk_valid, int causal, int window, int vec, int dtype,    \
        float scale, float softcap, void *stream
#define BWD_ARGS                                                                              \
    make_args(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Tq, Tk, D, qs_b, qs_h,   \
              qs_t, ks_b, ks_h, ks_t, vs_b, vs_h, vs_t, os_b, os_h, os_t, gs_b, gs_h, gs_t,  \
              q_offset, tk_valid, causal, window, vec, scale, softcap)

int flash_attention_bwd_dq_launch(BWD_PARAMS) {
    const BwdArgs a = BWD_ARGS;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tensor_cores(a, dtype)) return launch_dq_wgmma(a, s);
    return dtype == 1 ? dispatch_dq<__nv_bfloat16>(a, s) : dispatch_dq<float>(a, s);
}

int flash_attention_bwd_dkdv_launch(BWD_PARAMS) {
    const BwdArgs a = BWD_ARGS;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tensor_cores(a, dtype)) return launch_dkdv_wgmma(a, s);
    return dtype == 1 ? dispatch_dkdv<__nv_bfloat16>(a, s) : dispatch_dkdv<float>(a, s);
}

const char* flash_attention_bwd_dq_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* flash_attention_bwd_dkdv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
