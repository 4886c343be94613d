// Flash attention forward (online softmax) for Hopper (sm_90a), fp32 on
// CUDA cores.
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
// length is read.
//
// What bounds it on this card.  A long prefill does 4·Tq·Tk·D/2 FMAs for
// Tq·D + 2·Tk·D inputs: bound by operations (67 TFLOP/s fp32 outside the
// tensor cores).  A decode step (Tq = 1) does 2 FMAs per key element read:
// bound by bytes (3.35 TB/s), the valid K and V prefix read once.
//
// Design (fp32 FMA on CUDA cores; tensor cores and TMA are later work):
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

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* out;
    float* part;  // split partials: (m, l) per row, then o per row (n_split > 1)
    int* ticket;  // one counter per (b, KV head, query tile), 0 between launches
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

// Four consecutive elements at p (16-byte aligned for float32, 8-byte for
// bfloat16), through the read-only path, as float.
__device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
    return make_float4(to_f32(e[0]), to_f32(e[1]), to_f32(e[2]), to_f32(e[3]));
}

// Rows [0, ROWS) of a (ROWS, DMAX) shared tile with row stride LD, from the
// global rows that row_ptr gives (nullptr: zeros), columns >= D zero-filled.
// VEC (D and every row a multiple of 4 elements, aligned): each thread owns
// 4 columns and issues up to 8 row loads before it stores any, so a CTA
// keeps many loads in flight (a decode step has only B * Hkv CTAs).
// Otherwise one element per thread and load.
template <typename T, int DMAX, int ROWS, int LD, int THREADS, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int D, bool vec,
                                           RowPtr row_ptr) {
    if (vec) {
        constexpr int TPR = DMAX / 4, RPI = THREADS / TPR, PASSES = ROWS / RPI;
        constexpr int UNR = PASSES < 8 ? PASSES : 8;
        static_assert(THREADS % TPR == 0 && ROWS % RPI == 0 && PASSES % UNR == 0, "tiling");
        const int r0 = threadIdx.x / TPR, c4 = threadIdx.x % TPR * 4;
#pragma unroll
        for (int p0 = 0; p0 < PASSES; p0 += UNR) {
            float4 v[UNR];
#pragma unroll
            for (int u = 0; u < UNR; ++u) {
                const T* src = row_ptr(r0 + (p0 + u) * RPI);
                v[u] = (src != nullptr && c4 < D) ? load4(src + c4)
                                                  : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int u = 0; u < UNR; ++u)
                *reinterpret_cast<float4*>(&dst[(r0 + (p0 + u) * RPI) * LD + c4]) = v[u];
        }
        return;
    }
    constexpr int TPR = DMAX < THREADS ? DMAX : THREADS;  // threads per row
    constexpr int RPI = THREADS / TPR;                    // rows per pass
    const int r0 = threadIdx.x / TPR, d0 = threadIdx.x % TPR;
#pragma unroll 4
    for (int r = r0; r < ROWS; r += RPI) {
        const T* src = row_ptr(r);
#pragma unroll
        for (int d = d0; d < DMAX; d += TPR)
            dst[r * LD + d] = (src != nullptr && d < D) ? to_f32(src[d]) : 0.f;
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
                    if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
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
#pragma unroll
            for (int jd = 0; jd < NJ; ++jd)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int d = 64 * jd + 4 * tx + e;
                    if (d < D)
                        orow[d] = from_f32<T>(l[i] > 0.f ? acc[i][4 * jd + e] / l[i] : 0.f);
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
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = 64 * jd + 4 * tx + e;
                if (d < D) orow[d] = from_f32<T>(L > 0.f ? o[4 * jd + e] / L : 0.f);
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

// Tiles by head size, and a narrow tile (8 rows) where a KV head has at most
// 8 query rows (a decode step: the group's heads at one position), with a
// two-stage ring of 32-key K/V tiles up to D = 128: 71 KB of shared memory
// at D = 128, so three CTAs share an SM (at 256 it would not fit).
// kernels/flash_attention/kernel.py's split_plan mirrors this choice.
template <typename T>
int dispatch(const Args& a, cudaStream_t s) {
    const bool narrow = a.Hq / a.Hkv * a.Tq <= 8;
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
// n_split > 1 splits each query tile's keys into chunks of `chunk` keys
// over that many CTAs; part then holds B * Hkv * tiles * n_split * BQ *
// (2 + DMAX) floats and ticket B * Hkv * tiles zeroed ints, which the
// launch leaves zero (both unused when n_split == 1).  Launches on
// `stream` and returns the first CUDA error.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, void* part,
                           void* ticket, int B, int Hq, int Hkv, int Tq, int Tk, int D,
                           int qs_b, int qs_h, int qs_t, int ks_b, int ks_h, int ks_t, int vs_b,
                           int vs_h, int vs_t, int q_offset, int tk_valid, int causal, int window,
                           int vec, int n_split, int chunk, int dtype, float scale,
                           float softcap, void* stream) {
    if (n_split < 1 || (n_split > 1 && (part == nullptr || ticket == nullptr || chunk < 1)))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{q, k, v, out, static_cast<float*>(part), static_cast<int*>(ticket), B, Hq, Hkv,
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
