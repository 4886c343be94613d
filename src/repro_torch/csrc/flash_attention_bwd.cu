// Flash attention backward for Hopper (sm_90a): fp32 FMA on the CUDA cores.
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
// 6.45e10 FLOP, 0.96 ms at the CUDA cores' 67 TFLOP/s in fp32 (0.39 ms as
// three TF32 products on the tensor cores), against 0.08 ms of bytes.
//
// Design (simple and right first: fp32 FMA on the CUDA cores; 3xTF32 wgmma
// and TMA are later work):
//  * Two launches, no atomics, so a result repeats bit for bit.
//    1. attention_bwd_dq_kernel over query tiles: one CTA per (BQ packed
//       (t, g) rows, KV head, b), the forward's packing, so a K/V tile is read
//       once for the group's heads.  It computes D for its rows (stored for
//       launch 2), then walks the key tiles its rows can see (the window's
//       horizon to the causal frontier, below tk_valid), forming S and dP in
//       registers, dS in shared memory and dQ += dS K in registers.
//    2. attention_bwd_dkdv_kernel over key tiles: one CTA per (BKV keys, KV
//       head, b), key tile 0 first (under a causal mask it sees the most
//       queries).  It holds its K and V tiles and walks the packed rows of
//       the group's heads whose positions see them, forming S^T and dP^T in
//       registers, P^T and dS^T in shared memory, and dV += P^T dO and dK +=
//       dS^T Q in registers.  Keys at or beyond tk_valid get zeros.
//    It recomputes S and dP in both launches (7 D FMAs a pair against the
//    bound's 5), the price of no atomics on dQ.
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

namespace {

using attn::load4;
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
    return dtype == 1 ? dispatch_dq<__nv_bfloat16>(a, s) : dispatch_dq<float>(a, s);
}

int flash_attention_bwd_dkdv_launch(BWD_PARAMS) {
    const BwdArgs a = BWD_ARGS;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 1 ? dispatch_dkdv<__nv_bfloat16>(a, s) : dispatch_dkdv<float>(a, s);
}

const char* flash_attention_bwd_dq_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

const char* flash_attention_bwd_dkdv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
