// Flash attention forward (online softmax) for Hopper (sm_90a): float32
// prefill on the tensor cores (3xTF32 wgmma), the rest on the CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py, body `_kernel`).  Over
// q (B, Hq, Tq, D) and k, v (B, Hkv, Tk, D) it computes, for every query row
// at absolute position q_pos = q_offset + t,
//
//     out = softmax_k(mask(softcap(q . k * scale))) @ v       in fp32
//
// with mask = (k_pos < tk_valid) & (causal: k_pos <= q_pos) & (window:
// q_pos - k_pos < window), the KV head of q head h being h / group (GQA), and
// a zero row where no key is valid.  The output has q's type (fp32 or bf16).
// q_offset and tk_valid are launch arguments, so a decode loop neither
// recompiles nor syncs, and only the tk_valid prefix of a cache buffer of any
// length is read.  Given an lse buffer (training: kernels/flash_attention/
// autograd.py), every instance also stores each row's log-sum-exp m + log l
// of its masked scores, which flash_attention_bwd.cu reads; without one
// (serving, every call under no_grad) nothing else changes.
//
// What bounds it on this card.  A long prefill does 4·Tq·Tk·D/2 FMAs for
// Tq·D + 2·Tk·D inputs: bound by operations.  In fp32 on the CUDA cores (67
// TFLOP/s) phi4-mini's prefill (B 4, 24/8 heads, 1023 tokens, D 128: 25.7
// GFLOP of causal pairs) cannot beat 0.384 ms; three TF32 products on the
// tensor cores (495 TFLOP/s) bound it at 0.156 ms, its bytes at 0.040 ms.
// One TF32 product misses the fp32 tolerance (rtol 2e-5, atol 1.6e-4) by
// about 10x at that shape (tests/test_torch_kernels_flash_attention.py
// emulates it; chip_smoke.py's [k4-precision] measures it), so the tensor
// cores run 3xTF32.  A decode step (Tq = 1) does 2 FMAs per key element
// read: bound by bytes (3.35 TB/s), the valid K and V prefix read once.
//
// Tensor-core design (flash_attention_wgmma_kernel: float32, more than 8
// rows a KV head, D <= 128, 16-byte rows and strides, no key split):
//  * One CTA per (128 packed (t, g) rows, KV head, b): two warpgroups of 64
//    rows sharing each K/V tile, which thread 0 loads by TMA (mbarriers)
//    from 4D maps whose key extent is tk_valid: keys beyond it read as zeros
//    and are never read from memory.  (No producer warp: 288 threads or more
//    cap a thread at 168 registers; the kernel uses 255 without spilling.)
//    The CTAs run longest first (the last query tiles, most keys, launch
//    first).  Tiles before the window's horizon and after the causal
//    frontier of the CTA's rows are never loaded.  No wgmma sits in a
//    divergent branch, and the rare paths' branches are warp-uniform: ptxas
//    otherwise serializes every wgmma of the kernel (1.6x slower on the
//    card).
//  * S = Q K^T on wgmma.m64n64k8.tf32, A = Q from registers, B = K's planes
//    in shared memory.  Q is staged raw once per CTA and split into TF32 big
//    and small parts in registers as the k8 steps go; K arrives in the
//    128-byte swizzle, K-major as wgmma takes it, and is split in place (big)
//    and into a small plane.  small.big + big.small + big.big per step.
//  * Online softmax in registers (base 2), then O += P V on
//    wgmma.m64n64k8.tf32 in two 64-column halves, A = P from the score
//    accumulator's registers, split in place.  wgmma takes a TF32 B operand
//    only K-major, so the pass that splits V writes its planes transposed
//    (V^T, keys contiguous), with the even keys of each group of 8 first:
//    the accumulator's columns (2t, 2t + 1) are then the A fragment's (t, t +
//    4), and no shuffle is needed.  Each half's P V goes into a fresh
//    accumulator that the CUDA cores add to the fp32 output after the
//    rescale: a long sum inside the tensor cores drops low bits (coded_matmul.cu).
//  * Shared memory is the constraint (227 KB a block): Q 64 KB (128 rows),
//    the raw K tile that becomes its big plane 32 KB, K's small plane 32 KB,
//    the raw V tile 32 KB, V^T's two planes 64 KB: 224 KB at BK = 64, one
//    buffer each and one CTA an SM.  The next tile's V load starts once the
//    split has read the raw V tile, its K load once both warpgroups' score
//    products are done; they land during the score product, the softmax and
//    P V.  The split runs before the score product, by all 256 threads.
//    (Splitting V between the score product's issue and its wait, or the
//    next tile's K beside P V, saved no time on the card and cost registers.)
//    A two-stage ring would need 64 KB more.
//  * Non-finite input: the split turns an inf into big = inf, small = NaN,
//    so a score or an output that meets one comes out NaN.  Such a score is
//    recomputed as a plain fp32 dot product (q from shared memory, k from
//    device memory) and such an output as a plain fp32 sum over the tile's
//    keys, which gives the CUDA-core instance's inf and NaN.
//
// CUDA-core design (bfloat16, decode steps, D > 128, the non-vec case, split keys):
//  * One CTA per (b, KV head, tile of BQ query rows), where the rows of a CTA
//    are the (t, g) pairs of the `group` q heads sharing that KV head, g
//    fastest.  The K and V tiles are then read once for all of the group's
//    heads, and a decode step (Tq = 1) packs the group's heads into one CTA.
//  * BK = 64 keys per tile (32 in the narrow tile, below).  Q, K and V
//    tiles are staged as fp32 in dynamic shared memory (98 KB at D = 128,
//    so two CTAs fit an SM); P (the tile's probabilities) overlays the K
//    tile once the scores are in registers.
//  * Thread (ty, tx) of 16·TY threads owns RT query rows: in the score tile
//    keys tx + 16·j, in the output columns 4·tx + 64·jd + e.  Shared reads are
//    16-byte vectors: K rows are padded by 4 floats so 8 lanes cover the 32
//    banks; Q and P reads are broadcasts within a half-warp.  Row max and
//    sum are reduced with shuffles over the 16 lanes of a half-warp.
//  * The key loop runs from the window's horizon to the causal frontier of
//    the CTA's rows and stops at tk_valid: the masked tiles the TPU kernel
//    skips with pl.when are never visited.  Keys beyond tk_valid are never
//    read (the tile is zero-filled there), and masked scores get p = 0
//    exactly, as in the reference, so stale cache entries never weigh in.
//  * Ragged Tq, Tk and D are masked here, so the caller pads nothing.
//  * Split-K.  Unsplit, a decode step of phi4-mini (B 4, Hkv 8) has 32
//    (b, KV head) CTAs for 132 SMs, each streaming its ~1041 keys alone,
//    and reached 10% of the bytes bound.  Where the unsplit grid has fewer
//    CTAs than the card has
//    SMs, the wrapper (kernel.py, split_plan) cuts the key axis into chunks
//    of 128 keys (more when the buffer is long: at most 64 chunks) and
//    launches one CTA per (query tile, chunk).  The count comes from the
//    cache buffer's length, never from tk_valid, so one grid serves every
//    decode step (a CUDA graph can capture it); a chunk with no visible
//    key leaves an empty partial (m = -inf, l = 0) at once.  Each CTA
//    writes its rows' partial (m, l, unnormalised o) to a scratch buffer,
//    then takes a ticket (an atomic after __threadfence); the last of the
//    tile's CTAs combines, o = sum e^(m_s - M) o_s / sum e^(m_s - M) l_s,
//    and sets the ticket back to 0.  So the combine costs no second launch,
//    and the tickets, zeroed once when the wrapper first allocates them,
//    are reused.  The narrow tile stages K/V through a two-stage cp.async
//    ring of 32-key tiles in float32 (up to D = 128; 71 KB, three CTAs an
//    SM), so the next tile's copies fly while the current one is used;
//    bfloat16 rows are converted in registers and keep the synchronous
//    staging.
//
// Bound with ctypes: a plain C interface, pointers and the stream passed as
// void*, the launch error returned from cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

constexpr float NEG_INF = -1e30f;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* out;
    float* part;  // split partials: (m, l) per row, then o per row (n_split > 1)
    int* ticket;  // one counter per (b, KV head, query tile), 0 between launches
    float* lse;   // (B, Hq, Tq) row log-sum-exps for the backward; nullptr: none
    int B, Hq, Hkv, Tq, Tk, D;
    long long qs_b, qs_h, qs_t, ks_b, ks_h, ks_t, vs_b, vs_h, vs_t;  // element strides
    int q_offset, tk_valid, causal, window;  // window <= 0: none
    int vec;                                 // rows load as 4-element vectors
    int n_split, chunk;                      // key chunks per query tile, keys a chunk
    float scale, softcap;                    // softcap <= 0: none
};

template <int DMAX, int BQ, int STAGES, int BK>
constexpr size_t smem_bytes() {
    return sizeof(float) * ((size_t)BQ * (DMAX + 4) +
                            STAGES * ((size_t)BK * (DMAX + 4) + (size_t)BK * DMAX));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, ROWS) of a (ROWS, DMAX) float32 shared tile with row stride LD,
// copied asynchronously (16 bytes a copy) from the rows row_ptr gives
// (nullptr: zeros), columns >= D zero-filled; D a multiple of 4 and every
// row 16-byte aligned.  `any` is a valid address the zero-size copies name.
template <int DMAX, int ROWS, int LD, int THREADS, typename RowPtr>
__device__ __forceinline__ void stage_rows_async(float* __restrict__ dst, int D, const float* any,
                                                 RowPtr row_ptr) {
    constexpr int TPR = DMAX / 4, RPI = THREADS / TPR;
    static_assert(THREADS % TPR == 0 && ROWS % RPI == 0, "tiling");
    const int r0 = threadIdx.x / TPR, c4 = threadIdx.x % TPR * 4;
#pragma unroll 4
    for (int r = r0; r < ROWS; r += RPI) {
        const float* src = row_ptr(r);
        const bool ok = src != nullptr && c4 < D;
        cp_async16(&dst[r * LD + c4], ok ? src + c4 : any, ok ? 16 : 0);
    }
}

template <typename T, int DMAX, int BQ, int RT, int STAGES, int BK, bool SPLIT>
__global__ void __launch_bounds__(BQ / RT * 16)
flash_attention_kernel(const Args a) {
    constexpr int TY = BQ / RT, THREADS = TY * 16;
    constexpr int CT = BK / 16;     // score columns per thread
    constexpr int LDQ = DMAX + 4;   // Q and K row stride (floats)
    constexpr int LDP = BK + 4;     // P row stride
    constexpr int NJ = DMAX / 64;   // float4 output column groups per thread
    constexpr int KV = BK * LDQ + BK * DMAX;  // floats of one K/V stage
    static_assert(BQ * LDP <= BK * LDQ, "P must fit in the K tile it overlays");
    extern __shared__ float4 smem4[];
    float* sQ = reinterpret_cast<float*>(smem4);

    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int n_split = SPLIT ? a.n_split : 1;
    const int split = blockIdx.x % n_split, tile = blockIdx.x / n_split;
    const int b = blockIdx.z, hk = blockIdx.y, i0 = tile * BQ;
    const int group = a.Hq / a.Hkv, n_rows = group * a.Tq, D = a.D;
    const T* q = static_cast<const T*>(a.q);
    const T* kg = static_cast<const T*>(a.k) + (size_t)b * a.ks_b + (size_t)hk * a.ks_h;
    const T* vg = static_cast<const T*>(a.v) + (size_t)b * a.vs_b + (size_t)hk * a.vs_h;
    const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;  // no division a score


    int qpos[RT];
    bool row_ok[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const int ig = i0 + ty * RT + i;
        row_ok[i] = ig < n_rows;
        qpos[i] = a.q_offset + (row_ok[i] ? ig / group : 0);
    }
    // Keys any row of this CTA can see: from the window's horizon of its
    // first position to the causal frontier of its last, below tk_valid.
    const int last = min(i0 + BQ, n_rows) - 1;
    const int p_lo = a.q_offset + i0 / group, p_hi = a.q_offset + last / group;
    const int k_begin = a.window > 0 ? max(0, p_lo - a.window + 1) : 0;
    const int k_end = a.causal ? min(a.tk_valid, p_hi + 1) : a.tk_valid;
    // This CTA's share of them: its chunk of the key axis when split.  The
    // grid depends on the buffer's length only, so a chunk may hold no
    // visible key; its CTA then leaves an empty partial (m = -inf, l = 0).
    const int c_lo = split * a.chunk;
    const int k_lo = SPLIT ? max(k_begin, c_lo) : k_begin;
    const int k_hi = SPLIT ? min(k_end, c_lo + a.chunk) : k_end;

    // The CTA's query rows: row i0 + r is (t, g) = divmod(i0 + r, group).
    if (k_lo < k_hi)
        stage_rows<T, DMAX, BQ, LDQ, THREADS>(sQ, D, a.vec, [&](int r) -> const T* {
            const int ig = i0 + r;
            if (ig >= n_rows) return nullptr;
            const int t = ig / group, g = ig - t * group;
            return q + (size_t)b * a.qs_b + (size_t)(hk * group + g) * a.qs_h +
                   (size_t)t * a.qs_t;
        });
    // Rows of this warp (two row groups ty) that exist: the others skip the
    // arithmetic (a decode step's 3 rows leave most warps idle).
    const bool warp_rows = i0 + (ty & ~1) * RT < n_rows;

    float m[RT], l[RT], acc[RT][NJ * 4];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NJ * 4; ++c) acc[i][c] = 0.f;
    }

    // The K and V tiles at k0 into stage st: with two stages and float32
    // vector rows, by cp.async (the next tile's copies fly while this one
    // is used); otherwise by loads into registers, stored before returning.
    auto stage_kv = [&](int k0, int st) {
        const int nk = min(BK, k_hi - k0);
        float* dK = sQ + BQ * LDQ + st * KV;
        float* dV = dK + BK * LDQ;
        if constexpr (STAGES > 1 && std::is_same<T, float>::value) {
            if (a.vec) {
                stage_rows_async<DMAX, BK, LDQ, THREADS>(dK, D, kg, [&](int c) -> const T* {
                    return c < nk ? kg + (size_t)(k0 + c) * a.ks_t : nullptr;
                });
                stage_rows_async<DMAX, BK, DMAX, THREADS>(dV, D, vg, [&](int c) -> const T* {
                    return c < nk ? vg + (size_t)(k0 + c) * a.vs_t : nullptr;
                });
                return;
            }
        }
        stage_rows<T, DMAX, BK, LDQ, THREADS>(dK, D, a.vec, [&](int c) -> const T* {
            return c < nk ? kg + (size_t)(k0 + c) * a.ks_t : nullptr;
        });
        stage_rows<T, DMAX, BK, DMAX, THREADS>(dV, D, a.vec, [&](int c) -> const T* {
            return c < nk ? vg + (size_t)(k0 + c) * a.vs_t : nullptr;
        });
    };

    int st = 0;
    if (STAGES > 1 && k_lo < k_hi) {
        stage_kv(k_lo, 0);
        cp_async_commit();
    }
    for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
        const int nk = min(BK, k_hi - k0);
        __syncthreads();  // the previous tile's P and V reads are done
        if (STAGES > 1) {
            if (k0 + BK < k_hi) {  // the next tile into the other stage
                stage_kv(k0 + BK, st ^ 1);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
        } else {
            stage_kv(k0, 0);
        }
        __syncthreads();
        float* sK = sQ + BQ * LDQ + st * KV;
        float* sV = sK + BK * LDQ;
        float* sP = sK;  // overlays K once the scores are in registers

        float s[RT][CT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
        if (warp_rows) {
            // S = Q K^T over the tile, D in steps of 4 (columns >= D are 0).
#pragma unroll 2
            for (int d = 0; d < D; d += 4) {
                float4 kv[CT];
#pragma unroll
                for (int j = 0; j < CT; ++j)
                    kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * LDQ + d]);
#pragma unroll
                for (int i = 0; i < RT; ++i) {
                    const float4 qv =
                        *reinterpret_cast<const float4*>(&sQ[(ty * RT + i) * LDQ + d]);
#pragma unroll
                    for (int j = 0; j < CT; ++j) {
                        s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
                        s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
                        s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
                        s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
                    }
                }
            }
        }
        __syncthreads();  // every K read is done: P may overlay the tile

        if (warp_rows) {
#pragma unroll
            for (int i = 0; i < RT; ++i) {
                unsigned ok = 0;
                float mx = NEG_INF;
#pragma unroll
                for (int j = 0; j < CT; ++j) {
                    const int key = k0 + tx + 16 * j;
                    float x = s[i][j] * a.scale;
                    if (a.softcap > 0.f) x = a.softcap * tanhf(x * inv_cap);
                    const bool valid = row_ok[i] && key < k_hi &&  // k_hi <= tk_valid
                                       (!a.causal || key <= qpos[i]) &&
                                       (a.window <= 0 || qpos[i] - key < a.window);
                    s[i][j] = valid ? x : NEG_INF;
                    ok |= (unsigned)valid << j;
                    mx = fmaxf(mx, s[i][j]);
                }
#pragma unroll
                for (int off = 8; off > 0; off >>= 1)
                    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
                const float m_new = fmaxf(m[i], mx);
                float sum = 0.f;
#pragma unroll
                for (int j = 0; j < CT; ++j) {
                    const float p = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
                    sP[(ty * RT + i) * LDP + tx + 16 * j] = p;
                    sum += p;
                }
#pragma unroll
                for (int off = 8; off > 0; off >>= 1)
                    sum += __shfl_xor_sync(0xffffffffu, sum, off);
                const float corr = expf(m[i] - m_new);
                l[i] = corr * l[i] + sum;
                m[i] = m_new;
#pragma unroll
                for (int c = 0; c < NJ * 4; ++c) acc[i][c] *= corr;
            }
        }
        __syncthreads();

        if (warp_rows) {
            // acc += P V over the tile's keys (rows >= nk of V are 0, P is 0 there).
            const int nk4 = (nk + 3) & ~3;
            for (int c = 0; c < nk4; c += 4) {
                float4 p4[RT];
#pragma unroll
                for (int i = 0; i < RT; ++i)
                    p4[i] = *reinterpret_cast<const float4*>(&sP[(ty * RT + i) * LDP + c]);
#pragma unroll
                for (int cc = 0; cc < 4; ++cc) {
                    float4 vv[NJ];
#pragma unroll
                    for (int jd = 0; jd < NJ; ++jd)
                        vv[jd] = *reinterpret_cast<const float4*>(
                            &sV[(c + cc) * DMAX + 64 * jd + 4 * tx]);
#pragma unroll
                    for (int i = 0; i < RT; ++i) {
                        const float p = cc == 0 ? p4[i].x : cc == 1 ? p4[i].y
                                      : cc == 2 ? p4[i].z : p4[i].w;
#pragma unroll
                        for (int jd = 0; jd < NJ; ++jd) {
                            acc[i][4 * jd + 0] = fmaf(p, vv[jd].x, acc[i][4 * jd + 0]);
                            acc[i][4 * jd + 1] = fmaf(p, vv[jd].y, acc[i][4 * jd + 1]);
                            acc[i][4 * jd + 2] = fmaf(p, vv[jd].z, acc[i][4 * jd + 2]);
                            acc[i][4 * jd + 3] = fmaf(p, vv[jd].w, acc[i][4 * jd + 3]);
                        }
                    }
                }
            }
        }
        if (STAGES > 1) st ^= 1;
    }

    T* out = static_cast<T*>(a.out);
    if constexpr (!SPLIT) {
        if (!warp_rows) return;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            if (!row_ok[i]) continue;
            const int ig = i0 + ty * RT + i;
            const int t = ig / group, h = hk * group + (ig - t * group);
            T* orow = out + (((size_t)b * a.Hq + h) * a.Tq + t) * D;
            const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // one division a row
            if (a.lse != nullptr && tx == 0)
                a.lse[((size_t)b * a.Hq + h) * a.Tq + t] =
                    l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
#pragma unroll
            for (int jd = 0; jd < NJ; ++jd)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int d = 64 * jd + 4 * tx + e;
                    if (d < D)
                        orow[d] = from_f32<T>(l[i] > 0.f ? acc[i][4 * jd + e] * inv : 0.f);
                }
        }
        return;
    }

    // Split: leave this chunk's partial (row max m, row sum l, unnormalised
    // o) in the scratch; the last CTA of the query tile to finish combines.
    const int n_tiles = (n_rows + BQ - 1) / BQ;
    const size_t tile_id = ((size_t)b * a.Hkv + hk) * n_tiles + tile;
    float* ml_base = a.part + tile_id * a.n_split * BQ * 2;  // [n_split][BQ][2]
    float* o_base = a.part + (size_t)a.B * a.Hkv * n_tiles * a.n_split * BQ * 2 +
                    tile_id * a.n_split * BQ * DMAX;        // [n_split][BQ][DMAX]
    if (warp_rows) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const int r = ty * RT + i;
            float* ml = ml_base + ((size_t)split * BQ + r) * 2;
            if (tx == 0) {
                ml[0] = m[i];
                ml[1] = l[i];
            }
            if (l[i] > 0.f) {  // an empty partial's o is never read
                float* o = o_base + ((size_t)split * BQ + r) * DMAX;
#pragma unroll
                for (int jd = 0; jd < NJ; ++jd)
                    *reinterpret_cast<float4*>(&o[64 * jd + 4 * tx]) =
                        make_float4(acc[i][4 * jd], acc[i][4 * jd + 1], acc[i][4 * jd + 2],
                                    acc[i][4 * jd + 3]);
            }
        }
    }
    __threadfence();  // the partial is visible device-wide before the ticket
    __syncthreads();
    __shared__ int s_last;
    if (threadIdx.x == 0) s_last = atomicAdd(a.ticket + tile_id, 1) == a.n_split - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();

    // o = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M) l_s with M = max_s m_s;
    // 0 where no chunk saw a valid key.  Loads bypass L1 (__ldcg): other
    // CTAs wrote the partials.
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        if (!row_ok[i]) continue;
        const int r = ty * RT + i;
        float M = NEG_INF;
        for (int sp = 0; sp < a.n_split; ++sp)
            M = fmaxf(M, __ldcg(ml_base + ((size_t)sp * BQ + r) * 2));
        float L = 0.f, o[NJ * 4];
#pragma unroll
        for (int c = 0; c < NJ * 4; ++c) o[c] = 0.f;
        for (int sp = 0; sp < a.n_split; ++sp) {
            const float2 ml = __ldcg(reinterpret_cast<const float2*>(
                ml_base + ((size_t)sp * BQ + r) * 2));
            if (!(ml.y > 0.f)) continue;
            const float c = expf(ml.x - M);
            L += c * ml.y;
            const float* os = o_base + ((size_t)sp * BQ + r) * DMAX;
#pragma unroll
            for (int jd = 0; jd < NJ; ++jd) {
                const float4 v = __ldcg(reinterpret_cast<const float4*>(&os[64 * jd + 4 * tx]));
                o[4 * jd] += c * v.x;
                o[4 * jd + 1] += c * v.y;
                o[4 * jd + 2] += c * v.z;
                o[4 * jd + 3] += c * v.w;
            }
        }
        const int ig = i0 + r;
        const int t = ig / group, h = hk * group + (ig - t * group);
        T* orow = out + (((size_t)b * a.Hq + h) * a.Tq + t) * D;
        const float inv = L > 0.f ? 1.f / L : 0.f;
        if (a.lse != nullptr && tx == 0)
            a.lse[((size_t)b * a.Hq + h) * a.Tq + t] = L > 0.f ? M + logf(L) : -INFINITY;
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = 64 * jd + 4 * tx + e;
                if (d < D) orow[d] = from_f32<T>(L > 0.f ? o[4 * jd + e] * inv : 0.f);
            }
    }
    if (threadIdx.x == 0) a.ticket[tile_id] = 0;  // ready for the next launch
}

// The split and the unsplit launch are separate instances, so the split's
// epilogue costs the unsplit kernel no registers.
template <typename T, int DMAX, int BQ, int RT, int STAGES = 1, int BK = 64>
int launch(const Args& a, cudaStream_t s) {
    constexpr size_t smem = smem_bytes<DMAX, BQ, STAGES, BK>();
    auto kernel = a.n_split > 1 ? flash_attention_kernel<T, DMAX, BQ, RT, STAGES, BK, true>
                                : flash_attention_kernel<T, DMAX, BQ, RT, STAGES, BK, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_rows = a.Hq / a.Hkv * a.Tq;
    const dim3 grid((n_rows + BQ - 1) / BQ * a.n_split, a.Hkv, a.B);
    kernel<<<grid, BQ / RT * 16, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// ---- float32 on the tensor cores: 3xTF32 wgmma, K and V by TMA -----------------

struct KvMaps {
    CUtensorMap k, v;
};

namespace wg {
constexpr int BQ = 128;                  // packed (t, g) rows a CTA: two warpgroups of 64
constexpr int BK = 64;                   // keys a tile
constexpr int DMAX = 128;                // head dim of the instance (a smaller D: zero columns)
constexpr int THREADS = 256;            // two warpgroups (a producer warp would cap the
                                        // registers at 168 a thread, as for 384 threads)
constexpr int TILE = BK * DMAX;          // floats of one K/V tile or plane: 32 KB
constexpr size_t SMEM = sizeof(float) * (5 * TILE + BQ * DMAX) + 1024;  // + alignment
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
}  // namespace wg

// The tile's split, by the CTA's 256 threads.  K arrives as four
// 128-byte-swizzled boxes of 32 columns, K-major as wgmma reads it: its big
// plane is written in place, its small plane to sKlo at the same offsets.
__device__ __forceinline__ void split_k(float* sK, float* sKlo, int tid) {
#pragma unroll
    for (int i = 0; i < wg::TILE / 4 / wg::THREADS; ++i) {
        const int off = (tid + i * wg::THREADS) * 4;
        const float4 v = *reinterpret_cast<const float4*>(sK + off);
        uint4 big, small;
        split_tf32(v.x, big.x, small.x);
        split_tf32(v.y, big.y, small.y);
        split_tf32(v.z, big.z, small.z);
        split_tf32(v.w, big.w, small.w);
        sts128(sK + off, big.x, big.y, big.z, big.w);
        sts128(sKlo + off, small.x, small.y, small.z, small.w);
    }
}

// V arrives row-major (64 keys of 512 bytes) and is transposed into the big
// and small planes of V^T: two 32-key blocks of 128 d-rows of 128 bytes in
// the 128-byte swizzle, where each group of 8 keys holds its even keys first
// (key 8s + 2u + e at k index u + 4e of step s).  Then the score
// accumulator's registers are P's A fragments as they stand.
__device__ __forceinline__ void split_v(const float* sV, float* sVhi, float* sVlo, int tid) {
#pragma unroll
    for (int i = 0; i < wg::TILE / 4 / wg::THREADS; ++i) {
        const int item = tid + i * wg::THREADS;  // (key block, chunk, d), d fastest
        const int d = item & (wg::DMAX - 1), c = (item >> 7) & 7, kb = item >> 10;
        const int key = kb * 32 + 8 * (c >> 1) + (c & 1);
        uint32_t big[4], small[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) split_tf32(sV[(key + 2 * u) * wg::DMAX + d], big[u], small[u]);
        const int off = kb * 32 * wg::DMAX + d * 32 + ((c ^ (d & 7)) << 2);
        sts128(sVhi + off, big[0], big[1], big[2], big[3]);  // 16 bytes: conflict-free
        sts128(sVlo + off, small[0], small[1], small[2], small[3]);
    }
}

// s (this warpgroup's 64 rows x the tile's 64 keys, this thread's 32) = Q K^T
// in 3xTF32, small.big + big.small + big.big in each k8 step.  Q's A
// fragments are read from sQ and split in registers two k8 steps (16 d) at a
// time, the next pair's loads and split while one pair is in flight (two
// buffers of 16 registers: more would leave the kernel short of registers).
__device__ __forceinline__ void qk_product(float (&s)[32], const float* sQ, const float* sK,
                                           const float* sKlo, int r_lo, int t) {
    uint32_t qb[2][2][4], qs[2][2][4];
#pragma unroll
    for (int c = 0; c < wg::DMAX / 16; ++c) {  // columns >= D are zero
        const int blk = c >> 1, half = c & 1;    // 32-column block, its first or second 16
        uint32_t(&big)[2][4] = qb[c & 1];
        uint32_t(&small)[2][4] = qs[c & 1];
        load_frags(sQ, r_lo, t, blk, half, big, small);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int off = (2 * half + j) * 32;  // the k8 step's bytes in the 128-byte row
            const uint64_t kb = wgmma_desc(sK + blk * wg::BK * 32, off);
            const uint64_t ks = wgmma_desc(sKlo + blk * wg::BK * 32, off);
            wgmma_tf32_m64n64k8(s, small[j], kb, c > 0 || j > 0);
            wgmma_tf32_m64n64k8(s, big[j], ks, 1);
            wgmma_tf32_m64n64k8(s, big[j], kb, 1);
        }
        wgmma_commit();
        if (c > 0) {  // the previous pair is done: its registers may be reused
            wgmma_wait<1>();
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int u = 0; u < 4; ++u) keep_live(qb[(c - 1) & 1][j][u], qs[(c - 1) & 1][j][u]);
        }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) keep_live(qb[b][j][u], qs[b][j][u]);
}

// Whether all 32 values are finite: v - v is 0 for a finite v and NaN for
// an inf or a NaN, summed in four independent chains.
__device__ __forceinline__ bool all_finite(const float (&v)[32]) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i & 3] += v[i] - v[i];
    return (acc[0] + acc[1]) + (acc[2] + acc[3]) == 0.f;
}

// 2^x by the special function unit (ex2.approx.ftz: relative error about
// 2^-22, results below 2^-126 flushed to zero).
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// A score's plain fp32 dot product, q from sQ and k from device memory: the
// plain version's value where the tensor-core sum is not finite.
__device__ __forceinline__ float plain_qk(const float* sQ, int r, const float* k_row, int D) {
    float acc = 0.f;
#pragma unroll 1
    for (int d = 0; d < D; ++d) acc = fmaf(sQ[frag_slot(r, d)], k_row[d], acc);
    return acc;
}

// One CTA per (128 packed (t, g) rows, KV head, b), the last query tiles
// first (they have the most keys under a causal mask): two warpgroups of 64
// rows.  Thread 0 loads each key tile's K (four boxes) and V (one box) by
// TMA into single buffers, completing on mbarriers: V once the split has
// read the previous tile, K once both warpgroups' score products have.  Each tile: the CTA splits K
// and V (split_k, split_v); each warpgroup forms its scores (qk_product),
// its online softmax in registers, and P V in two 64-column halves, each
// into a fresh accumulator that is added to the fp32 output after the
// rescale.
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ KvMaps maps, const Args a) {
    using namespace wg;
    extern __shared__ uint8_t fa_smem_raw[];
    // 1024-byte aligned for the 128-byte swizzle, by an offset from the
    // shared array, so that the compiler keeps shared (not generic) accesses.
    const uint32_t pad = (1024 - (smem_u32(fa_smem_raw) & 1023)) & 1023;
    float* sK = reinterpret_cast<float*>(fa_smem_raw + pad);
    float* sKlo = sK + TILE;
    float* sVhi = sKlo + TILE;
    float* sVlo = sVhi + TILE;
    float* sV = sVlo + TILE;
    float* sQ = sV + TILE;
    __shared__ __align__(8) uint64_t k_full, v_full;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int group = a.Hq / a.Hkv, n_rows = group * a.Tq, D = a.D;
    const int n_qt = (n_rows + BQ - 1) / BQ, per_qt = a.Hkv * a.B;
    const int qt = n_qt - 1 - (int)(blockIdx.x / per_qt);
    const int hk = (int)(blockIdx.x % per_qt) % a.Hkv, b = (int)(blockIdx.x % per_qt) / a.Hkv;
    const int i0 = qt * BQ;
    // Keys any row of this CTA can see, as in flash_attention_kernel.
    const int last = min(i0 + BQ, n_rows) - 1;
    const int p_lo = a.q_offset + i0 / group, p_hi = a.q_offset + last / group;
    const int k_lo = a.window > 0 ? max(0, p_lo - a.window + 1) : 0;
    const int k_hi = a.causal ? min(a.tk_valid, p_hi + 1) : a.tk_valid;
    const int n_kt = k_lo < k_hi ? (k_hi - k_lo + BK - 1) / BK : 0;

    auto load_v = [&](int k0) {
        mbar_expect_tx(&v_full, TILE * sizeof(float));
        tma_load_4d(sV, &maps.v, 0, k0, hk, b, &v_full);
    };
    auto load_k = [&](int k0) {
        mbar_expect_tx(&k_full, TILE * sizeof(float));
#pragma unroll
        for (int c = 0; c < DMAX / 32; ++c)
            tma_load_4d(sK + c * BK * 32, &maps.k, 32 * c, k0, hk, b, &k_full);
    };
    if (tid == 0) {
        mbar_init(&k_full, 1);
        mbar_init(&v_full, 1);
        mbar_init_fence();
        if (n_kt > 0) {
            load_v(k_lo);
            load_k(k_lo);
        }
    }

    // Warpgroup wgi owns rows wgi*64 .. +63 of the CTA, warp wq of it rows
    // wq*16 .. +15, lane (g, t) rows r_lo and r_lo + 8.
    const int wgi = tid >> 7, wq = warp & 3, g = lane >> 2, t = lane & 3;
    const int r_lo = wgi * 64 + wq * 16 + g;
    if (n_kt > 0) {
        const float* qg = static_cast<const float*>(a.q) + (size_t)b * a.qs_b;
        stage_frag_rows<BQ, THREADS>(sQ, D, [&](int r) -> const float* {
            const int ig = i0 + r, tq = ig / group;
            return ig < n_rows ? qg + (size_t)(hk * group + ig - tq * group) * a.qs_h +
                                     (size_t)tq * a.qs_t
                               : nullptr;
        });
    }
    // The keys row r_lo + 8 rr sees: [key_lo, key_hi), key_lo <= key_hi
    // (empty for a row past the last).
    bool row_ok[2];
    int key_lo[2], key_hi[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int ig = i0 + r_lo + 8 * rr;
        const int qpos = a.q_offset + ig / group;
        row_ok[rr] = ig < n_rows;
        key_lo[rr] = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
        key_hi[rr] = !row_ok[rr] ? 0 : a.causal ? min(k_hi, qpos + 1) : k_hi;  // k_hi <= tk_valid
        key_hi[rr] = max(key_hi[rr], key_lo[rr]);
    }
    // o[32h + 4j + e]: row r_lo + 8 (e / 2), column 64h + 8j + 2t + e % 2;
    // s[4j + e]: row r_lo + 8 (e / 2), key k0 + 8j + 2t + e % 2.  s is zeroed
    // once: the score product's first wgmma does not read it.
    float o[64], s[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    __syncthreads();  // the barriers' initialisation and Q
    for (int it = 0; it < n_kt; ++it) {
        const int k0 = k_lo + it * BK;
        mbar_wait(&v_full, it & 1);
        mbar_wait(&k_full, it & 1);
        __syncthreads();  // both warpgroups are done with the last tile's planes
        split_k(sK, sKlo, tid);
        split_v(sV, sVhi, sVlo, tid);
        fence_proxy_async();  // the planes are wgmma's operands
        __syncthreads();
        if (tid == 0 && it + 1 < n_kt) load_v(k0 + BK);
        // No branch around a wgmma: ptxas serializes wgmma in divergent code.
        // A warpgroup whose rows see none of the tile's keys computes it all
        // the same; every key is masked and its rows are left as they were.
        qk_product(s, sQ, sK, sKlo, r_lo, t);
        __syncthreads();  // both warpgroups' score products have read K
        if (tid == 0 && it + 1 < n_kt) load_k(k0 + BK);

        // Keys at or beyond tk_valid were zero-filled.  A non-finite score
        // (an inf or a NaN in q or k: the split makes an inf's small part
        // NaN) is recomputed as the plain version forms it.  The branch is
        // warp-uniform: ptxas serializes every wgmma of the kernel around a
        // divergent one.
        if (__any_sync(0xffffffffu, !all_finite(s))) {
            const float* kg =
                static_cast<const float*>(a.k) + (size_t)b * a.ks_b + (size_t)hk * a.ks_h;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
                if (!isfinite(s[i]) && key < k_hi)
                    s[i] = plain_qk(sQ, r_lo + 8 * ((i >> 1) & 1), kg + (size_t)key * a.ks_t, D);
            }
        }

        // Online softmax in base 2 over the valid keys, without branches (a
        // warp has few peers to hide latency with); a row's 64 keys lie in
        // the 4 lanes of its quad.  Masked keys score -inf, so they weigh
        // exactly 0 once a row's running max is above -1e30.
        if (a.softcap > 0.f) {
            const float mul = a.scale / a.softcap;  // no division a score: each is a call
#pragma unroll
            for (int i = 0; i < 32; ++i) s[i] = a.softcap * tanhf(s[i] * mul) * LOG2E;
        } else {
            const float mul = a.scale * LOG2E;
#pragma unroll
            for (int i = 0; i < 32; ++i) s[i] *= mul;
        }
        float mx[2] = {NEG_INF, NEG_INF}, p_sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int rr = (i >> 1) & 1, key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            s[i] = (unsigned)(key - key_lo[rr]) < (unsigned)(key_hi[rr] - key_lo[rr]) ? s[i]
                                                                                       : -INFINITY;
            mx[rr] = fmaxf(mx[rr], s[i]);
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
            mx[rr] = fmaxf(fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2)), m[rr]);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            s[i] = exp2_approx(s[i] - mx[(i >> 1) & 1]);
            p_sum[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            p_sum[rr] += __shfl_xor_sync(0xffffffffu, p_sum[rr], 1);
            p_sum[rr] += __shfl_xor_sync(0xffffffffu, p_sum[rr], 2);
        }
        float corr[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            corr[rr] = exp2_approx(m[rr] - mx[rr]);
            l[rr] = corr[rr] * l[rr] + p_sum[rr];
            m[rr] = mx[rr];
        }
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
            for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];
        }

        // P's A fragments: step j's are s[4j + {0, 2, 1, 3}]; its big parts
        // overwrite s (as bits), its small parts go to ps.
        uint32_t ps[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            uint32_t big;
            split_tf32(s[i], big, ps[i]);
            s[i] = __uint_as_float(big);
        }

        // o += P V, 64 output columns at a time, each half's tile summed in a
        // fresh accumulator and added in fp32.
#pragma unroll
        for (int h = 0; h < DMAX / 64; ++h) {  // columns >= D are zero
            float tile[32];  // as o's first half; the first wgmma does not read it
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int off = (j >> 2) * 32 * DMAX + h * 64 * 32;
                const uint64_t vb = wgmma_desc(sVhi + off, (j & 3) * 32);
                const uint64_t vs = wgmma_desc(sVlo + off, (j & 3) * 32);
                wgmma_tf32_m64n64k8(tile, ps[4 * j], ps[4 * j + 2], ps[4 * j + 1], ps[4 * j + 3],
                                    vb, j > 0);
                wgmma_tf32_m64n64k8(tile, __float_as_uint(s[4 * j]), __float_as_uint(s[4 * j + 2]),
                                    __float_as_uint(s[4 * j + 1]), __float_as_uint(s[4 * j + 3]),
                                    vs, 1);
                wgmma_tf32_m64n64k8(tile, __float_as_uint(s[4 * j]), __float_as_uint(s[4 * j + 2]),
                                    __float_as_uint(s[4 * j + 1]), __float_as_uint(s[4 * j + 3]),
                                    vb, 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < 32; ++i) keep_live(s[i], ps[i]);

            // Rare: outputs that meet an inf or a NaN in v come out NaN from
            // the split; they are recomputed as plain fp32 sums over the
            // tile's keys below k_hi.  The warp stages its 16 rows of P in
            // K's small plane, which no one reads until the next split.
            if (__any_sync(0xffffffffu, !all_finite(tile))) {
                const float* vg =
                    static_cast<const float*>(a.v) + (size_t)b * a.vs_b + (size_t)hk * a.vs_h;
                float* p_rows = sKlo + (r_lo - g) * BK;  // this warp's rows, 64 keys each
#pragma unroll
                for (int i = 0; i < 32; ++i)
                    p_rows[(g + 8 * ((i >> 1) & 1)) * BK + 8 * (i >> 2) + 2 * t + (i & 1)] =
                        s[i] + __uint_as_float(ps[i]);
                __syncwarp();
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                    const int d = 64 * h + 8 * (i >> 2) + 2 * t + (i & 1);
                    if (isfinite(tile[i]) || d >= D) continue;
                    const float* p_row = p_rows + (g + 8 * ((i >> 1) & 1)) * BK;
                    float acc = 0.f;
#pragma unroll 1
                    for (int key = 0; key < min(BK, k_hi - k0); ++key)
                        acc = fmaf(p_row[key], vg[(size_t)(k0 + key) * a.vs_t + d], acc);
                    tile[i] = acc;
                }
                __syncwarp();
            }
#pragma unroll
            for (int i = 0; i < 32; ++i) o[32 * h + i] += tile[i];
        }
    }

    float* out = static_cast<float*>(a.out);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        if (!row_ok[rr]) continue;
        const int ig = i0 + r_lo + 8 * rr;
        const int tq = ig / group, h = hk * group + (ig - tq * group);
        float* orow = out + (((size_t)b * a.Hq + h) * a.Tq + tq) * D;
        const bool any = l[rr] > 0.f;  // else a zero row, as when l is NaN
        const float inv = any ? 1.f / l[rr] : 0.f;
        if (a.lse != nullptr && t == 0)  // m and l are in base 2
            a.lse[((size_t)b * a.Hq + h) * a.Tq + tq] =
                any ? (m[rr] + log2f(l[rr])) * LN2 : -INFINITY;
#pragma unroll
        for (int i = 0; i < 64; i += 4) {  // columns 64 (i / 32) + 8 (i % 32 / 4) + 2t, + 1
            const int d = 64 * (i >> 5) + 2 * (i & 31) + 2 * t;
            if (d < D)
                *reinterpret_cast<float2*>(orow + d) =
                    any ? make_float2(o[i + 2 * rr] * inv, o[i + 2 * rr + 1] * inv)
                        : make_float2(0.f, 0.f);
        }
    }
}

// A 4D TMA map of k or v, (D, tk_valid, Hkv, B) with the tensor's strides:
// keys at or beyond tk_valid and columns beyond D read as zeros, so the
// kernel never reads past the valid prefix of a cache buffer.
bool kv_map(CUtensorMap* map, const void* base, const Args& a, long long s_t, long long s_h,
            long long s_b, int box_cols, CUtensorMapSwizzle swizzle) {
    const cuuint64_t dims[4] = {(cuuint64_t)a.D, (cuuint64_t)(a.tk_valid > 1 ? a.tk_valid : 1),
                                (cuuint64_t)a.Hkv, (cuuint64_t)a.B};
    const cuuint64_t strides[3] = {(cuuint64_t)s_t * sizeof(float),
                                   (cuuint64_t)s_h * sizeof(float),
                                   (cuuint64_t)s_b * sizeof(float)};
    const cuuint32_t box[4] = {(cuuint32_t)box_cols, wg::BK, 1, 1};
    return float_map(map, base, 4, dims, strides, box, swizzle);
}

// The runtime call comes before the maps' encoding: it makes the device's
// context current in a thread that has none yet (autograd recomputes a
// checkpointed forward on a thread of its own), which
// cuTensorMapEncodeTiled needs.
int launch_wgmma(const Args& a, cudaStream_t s) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(wg::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    KvMaps maps;
    if (!kv_map(&maps.k, a.k, a, a.ks_t, a.ks_h, a.ks_b, 32, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !kv_map(&maps.v, a.v, a, a.vs_t, a.vs_h, a.vs_b, wg::DMAX, CU_TENSOR_MAP_SWIZZLE_NONE))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long ctas = (long long)((a.Hq / a.Hkv * a.Tq + wg::BQ - 1) / wg::BQ) * a.Hkv * a.B;
    if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    flash_attention_wgmma_kernel<<<(unsigned)ctas, wg::THREADS, wg::SMEM, s>>>(maps, a);
    return static_cast<int>(cudaGetLastError());
}

// Tiles by head size, and a narrow tile (8 rows) where a KV head has at most
// 8 query rows (a decode step: the group's heads at one position), with a
// two-stage ring of 32-key K/V tiles up to D = 128: 71 KB of shared memory
// at D = 128, so three CTAs share an SM (at 256 it would not fit).  Float32
// with more rows, D <= 128, 16-byte rows and strides (vec) and no key split
// runs on the tensor cores.  kernels/flash_attention/kernel.py's split_plan
// mirrors this choice.
template <typename T>
int dispatch(const Args& a, cudaStream_t s) {
    const bool narrow = a.Hq / a.Hkv * a.Tq <= 8;
    if (std::is_same<T, float>::value && !narrow && a.vec && a.D <= 128 && a.n_split == 1)
        return launch_wgmma(a, s);
    if (a.D <= 64)
        return narrow ? launch<T, 64, 8, 1, 2, 32>(a, s) : launch<T, 64, 64, 4>(a, s);
    if (a.D <= 128)
        return narrow ? launch<T, 128, 8, 1, 2, 32>(a, s) : launch<T, 128, 64, 4>(a, s);
    if (a.D <= 256) return narrow ? launch<T, 256, 8, 1>(a, s) : launch<T, 256, 32, 2>(a, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out (B, Hq, Tq, D), contiguous, = attention of q (B, Hq, Tq, D) over k, v
// (B, Hkv, Tk, D), each given by its element strides over (B, H, T) with the
// last dimension contiguous (dtype 0: float32, 1: bfloat16, all four alike);
// vec != 0 asserts D, every stride and every pointer allow 4-element loads.
// lse, when not null, receives each row's log-sum-exp of its masked scores,
// (B, Hq, Tq) float32 (-inf for a row with no valid key), for the backward.
// n_split > 1 splits each query tile's keys into chunks of `chunk` keys
// over that many CTAs; part then holds B * Hkv * tiles * n_split * BQ *
// (2 + DMAX) floats and ticket B * Hkv * tiles zeroed ints, which the
// launch leaves zero (both unused when n_split == 1).  Launches on
// `stream` and returns the first CUDA error.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, void* part,
                           void* ticket, void* lse, int B, int Hq, int Hkv, int Tq, int Tk, int D,
                           int qs_b, int qs_h, int qs_t, int ks_b, int ks_h, int ks_t, int vs_b,
                           int vs_h, int vs_t, int q_offset, int tk_valid, int causal, int window,
                           int vec, int n_split, int chunk, int dtype, float scale,
                           float softcap, void* stream) {
    if (n_split < 1 || (n_split > 1 && (part == nullptr || ticket == nullptr || chunk < 1)))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{q, k, v, out, static_cast<float*>(part), static_cast<int*>(ticket),
                 static_cast<float*>(lse), B, Hq, Hkv,
                 Tq, Tk, D, qs_b, qs_h, qs_t, ks_b, ks_h, ks_t, vs_b, vs_h, vs_t, q_offset,
                 tk_valid, causal, window, vec, n_split, chunk, scale, softcap};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) return dispatch<__nv_bfloat16>(a, s);
    return dispatch<float>(a, s);
}

const char* flash_attention_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
