// Single-token decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py::flash_decode
// (body _decode_body).  It computes the same function: for every sequence b
// and query head, softmax(q K^T * scale [softcap], keys [0, valid_len[b])) V
// over a cache (B, Hkv, L, D), with an online softmax, fp32 statistics and
// the reference's finite -1e30 mask.  Query head h reads KV head h / rep.
//
// Bound.  Bytes: a call reads the live K/V rows once, 2 x valid_len x D x
// sizeof(T) bytes per (b, KV head), and does 4 x rep x valid_len x D
// operations on them, about one operation per byte against the H100's ~295
// of bf16 tensor-core balance.  At the served Jamba shape (B = 4, Hkv = 8,
// rep = 4, D = 128, valid_len ~1900) that is ~31 MB, ~9.4 us at 3.35 TB/s.
// What keeps a kernel from that is bytes in flight (about 3.35 TB/s x 1 us
// of DRAM latency over 132 SMs: 25 KB an SM at the least) and the time
// between a tile's arrival and the release of its buffer.
//
// Split-K (flash-decoding) in both bodies: a grid of (splits, Hkv, B) CTAs.
// A CTA reads valid_len[b] on the device and takes ceil(live_tiles / splits)
// consecutive tiles of TK = 64 keys from the live ones, so every split count
// works whatever the prompt length and the host never syncs.  Tiles at or
// past valid_len[b] are never loaded; the ragged end of the last live tile
// is masked here.  The rep query heads of a KV head share every K/V tile
// (the TPU kernel's GQA packing); the statistics are (rep,) vectors (the TPU
// kernel's (rep, 128) scratch was a lane-width artefact).
//
// Two bodies, routed by dtype and head_dim alone (flash_decode.py's
// decode_body):
//   wgmma  bf16 at head_dim 17-128, a multiple of 8 (every registry head
//          dim; TMA needs rows of a multiple of 16 bytes).  One launch a
//          call.  A CTA of 160 threads: warp 4 is the producer, warps 0-3
//          one consumer warpgroup.
//          * A TMA ring.  One producer thread keeps the split's K and V
//            tiles in flight with cp.async.bulk.tensor on 3-D tensor maps
//            over (D, L, B x Hkv), boxes of 64 columns x 64 keys, 128B-
//            swizzled, each stage on a full and an empty mbarrier.  The
//            ring is 96 KB: 3 stages of 32 KB at D > 64, 6 stages of 16 KB
//            at D <= 64, and two CTAs fit an SM (2 x 101 KB of its 228 KB),
//            so each SM has up to 192 KB of K/V requested, well above the
//            25 KB floor above and the 16-32 KB a CTA of the simt body
//            keeps in flight.  Columns past D come back as zeros from
//            TMA's out-of-bounds fill, so 96 and 120 run in the 128-wide
//            tiles with no copy; rows past L too.
//          * Products on tensor cores, the query heads as N (at most 8):
//            S^T (64 keys x 8) = K_tile q^T as wgmma m64n8k16, K from the
//            swizzled tile and q from shared memory (written once, swizzled
//            the same way, zeros past rep and past D); then
//            O^T (D x 8) = O^T alpha + V_tile^T P as wgmma m64n8k16 with V
//            read transposed from its tile.  P is carried as two bf16
//            terms, hi = bf16(p) and lo = bf16(p - hi): p to ~2^-17 of
//            itself (one rounding of P would move every output by ~1e-3 of
//            itself, past the bf16 bounds).  q K^T from bf16 inputs is
//            exact in its products.  The tensor cores' fp32 sums are not
//            IEEE-rounded, so each 16-wide step of both products has its
//            own accumulator and the steps are summed in fp32 FADDs, as the
//            plain version's products are: chained through one
//            accumulator, the served Jamba decode read a whole-output rel
//            RMS of 4.05e-4 against the plain version (bound 4e-4), and
//            1.21e-4 so (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W).
//            Warp w holds keys 16w..16w+15 of S^T and rows 16w..16w+15 of
//            every 64-row block of O^T; the row maximum of a tile crosses
//            the four warps once through shared memory (a named barrier),
//            and P is written to shared memory as the B operand (a second
//            one).
//          * The split merge in the same launch.  With one split the CTA
//            writes the output.  Otherwise each CTA writes its (m, l, acc)
//            to fp32 scratch, fences, and counts itself in on an int
//            counter of its (b, KV head); the CTA that arrives last merges
//            every split in split-index order (so two calls are bit-equal
//            whoever arrives last), loading every partial in one round trip,
//            writes the output in bf16 and resets the counter to 0.  The
//            wrapper keeps the counters, one buffer per (device, stream),
//            zeroed when it is allocated.
//   simt   fp32 inputs, bf16 at head_dim <= 16 or off a multiple of 8, and
//          any bf16 call asked for it (chip_smoke.py times both bodies in
//          turns).  decode_split: 128 threads, the tiles double-buffered
//          with cp.async, IEEE fp32 FFMA for both products (two threads a
//          key for the scores, one output column a thread for P V), three
//          barriers a tile; decode_combine, a second launch, merges the
//          splits.  Instances at D = 16, 64 and 128; the wrapper zero-pads
//          other head dims to the next (96 and 120 run at 128).
//
// Partial mode (stat_m, stat_l not null): both bodies also write each query
// row's merged statistics, the running maximum M and the denominator l
// (fp32, (B, Hkv x rep)), and write the output in fp32, so that a merge of
// several calls over shards of one cache (the length sharded over ranks)
// starts from no bf16 rounding: out = sum_r e^(M_r - M*) l_r o_r / sum_r
// e^(M_r - M*) l_r.  The wgmma body writes them in the last CTA's merge (or
// the one CTA's epilogue), the simt body in decode_combine.  A shard with no
// live key (valid_len 0) loads no tile and writes o = 0, M = -1e30, l = 0:
// every split's (m, l, acc) stays (-1e30, 0, 0), so the merge's weights are
// e^0 = 1 against l = 0 and the output is 0 / max(0, 1e-30) = 0, no NaN.
//
// Offsets.  Every element offset into the caches, the partials and the
// output is formed in size_t (B x Hkv x L x D reaches 2^31 at a batch of 4
// at 524 288 keys); TMA addresses the caches with 64-bit strides and int32
// coordinates (keys < 2^31).
//
// Types.  The simt body's products, statistics and accumulator are IEEE
// fp32 (FFMA, expf, tanhf), so fp32 inputs agree with the plain version to a
// few ulps.  Both bodies round a bf16 output once.
//
// Times.  On the card's own time, L2 flushed (chip_smoke.py, NVIDIA H100
// 80GB HBM3, 700.00 W; PERF.md): wgmma 0.0219 ms at the served Jamba shape
// (valid_len 1908, 8 splits; simt 0.0316, SDPA 0.0423, bound 0.0094) and
// 0.0184 ms at the seamless cross cache (4 splits; simt 0.0208, SDPA
// 0.0183, bound 0.0073).  What holds wgmma there besides the stream from
// DRAM: the first tile's latency, and the split merge's tail (the
// partials, a fence, the atomic, one load round trip) on the path of the
// last CTA.
//
// C interface: avo_flash_decode(...) launches the simt body's two kernels,
// avo_flash_decode_wgmma(...) the wgmma body's one, on the given stream
// (stat_m and stat_l both null, or both set: partial mode); both return a
// CUDA error code as an int (0: launched).
// avo_flash_decode_wgmma_ctas_per_sm(D, &n) reports how many wgmma CTAs fit
// an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TK = 64;           // keys per tile
constexpr int MAX_REP = 8;       // query heads per KV head
constexpr float NEG_INF = -1e30f;

struct Params {
    const void* q; const void* k; const void* v; const int* valid_len;
    float* part_m; float* part_l; float* part_acc;   // (B, Hkv, splits, rep[, D])
    void* o;                                         // T, or fp32 with the statistics
    float* stat_m; float* stat_l;                    // (B, Hkv x rep) or null
    int B, Hkv, rep, L, splits;
    float softcap, scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) {
    *dst = __float2bfloat16_rn(x);
}

template <int D, typename T> struct Layout {
    static constexpr int VEC = 16 / sizeof(T);        // elements per 16 bytes
    static constexpr int VPR = D / VEC;               // 16-byte vectors per row
    static constexpr int LDK = D + 2 * VEC;           // padded K row in smem
    static constexpr int KP = THREADS / D;            // key blocks of the P V step
    static constexpr int STAGE = TK * LDK + TK * D;   // elements of one K + V stage
    static constexpr size_t smem = (size_t)2 * STAGE * sizeof(T)    // two stages
                                 + (size_t)MAX_REP * D * 4          // q rows
                                 + (size_t)MAX_REP * TK * 4         // scores / p
                                 + (size_t)MAX_REP * 4              // alpha
                                 + (size_t)(KP > 1 ? KP * MAX_REP * D * 4 : 0);
    static_assert(VPR % 2 == 0 && (TK / KP) % 4 == 0, "two threads a key, 4 keys a step");
};

// 16 bytes of a row as floats
__device__ __forceinline__ void load_vec(const float* src, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float (&f)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(h[i]);
        f[2 * i] = x.x; f[2 * i + 1] = x.y;
    }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
    uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    int n = pred ? 16 : 0;      // 0 source bytes: zero-fill the 16 bytes
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_split(const Params p) {
    using Lay = Layout<D, T>;
    static_assert(THREADS % D == 0 && THREADS == 2 * TK,
                  "a column per thread, KP blocks of keys; two threads a key");
    constexpr int KP = Lay::KP;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* kv_s = reinterpret_cast<T*>(smem_raw);            // stage s: K, then V
    float* q_s = reinterpret_cast<float*>(kv_s + 2 * Lay::STAGE);
    float* s_s = q_s + MAX_REP * D;
    float* alpha_s = s_s + MAX_REP * TK;
    float* red_s = alpha_s + MAX_REP;

    const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int rep = p.rep;
    const int vl = min(p.valid_len[b], p.L);          // keys [0, vl) are live
    const int live = (vl + TK - 1) / TK;
    const int per = (live + p.splits - 1) / p.splits;
    const int t_lo = sp * per, t_hi = min(live, t_lo + per);
    const size_t head = (size_t)b * p.Hkv + h;
    const T* qg = static_cast<const T*>(p.q) + head * rep * D;
    const T* kg = static_cast<const T*>(p.k) + head * (size_t)p.L * D;
    const T* vg = static_cast<const T*>(p.v) + head * (size_t)p.L * D;

    // tile t into stage st, 16 bytes a thread a step; rows past L are zeros
    auto load_tile = [&](int t, int st) {
        T* k_s = kv_s + st * Lay::STAGE;
        T* v_s = k_s + TK * Lay::LDK;
        for (int i = tid; i < TK * Lay::VPR; i += THREADS) {
            const int row = i / Lay::VPR, c = (i % Lay::VPR) * Lay::VEC;
            const int key = t * TK + row;
            const bool ok = key < p.L;
            const size_t off = ok ? (size_t)key * D + c : 0;
            cp_async16(k_s + row * Lay::LDK + c, kg + off, ok);
            cp_async16(v_s + row * D + c, vg + off, ok);
        }
        cp_async_commit();
    };
    if (t_lo < t_hi) load_tile(t_lo, 0);
    for (int i = tid; i < rep * D; i += THREADS) q_s[i] = to_f(qg[i]);

    // running statistics of the rows this warp owns (rows warp, warp + 4)
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
    // the output column and block of keys this thread owns, for all rep rows
    const int d = tid % D, kp = tid / D;
    float acc[MAX_REP];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) acc[r] = 0.f;

    for (int t = t_lo; t < t_hi; ++t) {
        const int st = (t - t_lo) & 1, t0 = t * TK;
        if (t + 1 < t_hi) { load_tile(t + 1, st ^ 1); cp_async_wait<1>(); }
        else cp_async_wait<0>();
        __syncthreads();
        const T* k_s = kv_s + st * Lay::STAGE;
        const T* v_s = k_s + TK * Lay::LDK;

        // 1. scores s[r][j] = softcap(q_r . k_j * scale), masked past vl:
        //    two threads a key, each over alternate 16-byte pieces of the
        //    row (conflict-free with the padded rows), all rep rows at once
        {
            const int j = tid >> 1, hf = tid & 1;
            const T* kr = k_s + j * Lay::LDK;
            float sc[MAX_REP];
#pragma unroll
            for (int r = 0; r < MAX_REP; ++r) sc[r] = 0.f;
#pragma unroll
            for (int i = 0; i < Lay::VPR / 2; ++i) {
                const int c = (2 * i + hf) * Lay::VEC;
                float kf[Lay::VEC];
                load_vec(kr + c, kf);
#pragma unroll
                for (int r = 0; r < MAX_REP; ++r) {
                    if (r >= rep) break;
                    const float* qr = q_s + r * D + c;
#pragma unroll
                    for (int e = 0; e < Lay::VEC; e += 4) {
                        const float4 qv = *reinterpret_cast<const float4*>(qr + e);
                        sc[r] = fmaf(qv.x, kf[e], sc[r]);
                        sc[r] = fmaf(qv.y, kf[e + 1], sc[r]);
                        sc[r] = fmaf(qv.z, kf[e + 2], sc[r]);
                        sc[r] = fmaf(qv.w, kf[e + 3], sc[r]);
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < MAX_REP; ++r) {
                if (r >= rep) break;
                float x = (sc[r] + __shfl_xor_sync(0xffffffffu, sc[r], 1)) * p.scale;
                if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
                if (hf == 0) s_s[r * TK + j] = (t0 + j < vl) ? x : NEG_INF;
            }
        }
        __syncthreads();

        // 2. online softmax, one warp per row
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int r = warp + WARPS * k;
            if (r >= rep) break;
            float* sr = s_s + r * TK;
            const float s0 = sr[lane], s1 = sr[lane + 32];
            const float m_new = fmaxf(m_run[k], warp_max(fmaxf(s0, s1)));
            const float alpha = expf(m_run[k] - m_new);
            const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
            sr[lane] = p0;
            sr[lane + 32] = p1;
            l_run[k] = l_run[k] * alpha + warp_sum(p0 + p1);
            m_run[k] = m_new;
            if (lane == 0) alpha_s[r] = alpha;
        }
        __syncthreads();

        // 3. acc = acc * alpha + p . V over this thread's block of keys,
        //    four keys a step
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
            if (r < rep) acc[r] *= alpha_s[r];
        for (int j = kp * (TK / KP); j < (kp + 1) * (TK / KP); j += 4) {
            float vj[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) vj[i] = to_f(v_s[(j + i) * D + d]);
#pragma unroll
            for (int r = 0; r < MAX_REP; ++r) {
                if (r >= rep) break;
                const float4 pr = *reinterpret_cast<const float4*>(s_s + r * TK + j);
                acc[r] = fmaf(pr.x, vj[0], acc[r]);
                acc[r] = fmaf(pr.y, vj[1], acc[r]);
                acc[r] = fmaf(pr.z, vj[2], acc[r]);
                acc[r] = fmaf(pr.w, vj[3], acc[r]);
            }
        }
        __syncthreads();            // the stage and p are overwritten next
    }

    const size_t part = (head * p.splits + sp) * rep;    // row 0 of this split
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int r = warp + WARPS * k;
        if (r < rep && lane == 0) {
            p.part_m[part + r] = m_run[k];
            p.part_l[part + r] = l_run[k];
        }
    }
    if constexpr (KP > 1) {
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
            if (r < rep) red_s[(kp * MAX_REP + r) * D + d] = acc[r];
        __syncthreads();
        if (kp != 0) return;
    }
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        float a = acc[r];
        if constexpr (KP > 1) {
            for (int k = 1; k < KP; ++k) a += red_s[(k * MAX_REP + r) * D + d];
        }
        p.part_acc[(part + r) * D + d] = a;
    }
}

constexpr int COMBINE_THREADS = 256;
constexpr int MAX_SPLITS = 1024;

// One CTA per (sequence, KV head): warp r merges row r's statistics into
// weights e^(m_s - M) and a denominator in shared memory, then every thread
// sums the weighted partial accumulators of its (row, column) pairs.  With
// the statistics asked for (partial mode) it writes each row's M and
// denominator too, and T is fp32 whatever the inputs' type.
template <typename T, int D>
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_combine(const Params p) {
    extern __shared__ float w_s[];                  // (rep, splits), then den (rep,)
    const int h = blockIdx.x, b = blockIdx.y;
    const int S = p.splits, rep = p.rep;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const size_t head = (size_t)b * p.Hkv + h;
    float* den_s = w_s + MAX_REP * S;
    if (warp < rep) {
        const size_t row0 = head * S * rep + warp;  // row `warp` of split 0
        float M = NEG_INF;
        for (int s = lane; s < S; s += 32) M = fmaxf(M, p.part_m[row0 + (size_t)s * rep]);
        M = warp_max(M);
        float den = 0.f;
        for (int s = lane; s < S; s += 32) {
            const float w = expf(p.part_m[row0 + (size_t)s * rep] - M);
            w_s[warp * S + s] = w;
            den = fmaf(w, p.part_l[row0 + (size_t)s * rep], den);
        }
        den = warp_sum(den);
        if (lane == 0) {
            den_s[warp] = den;
            if (p.stat_m) {
                p.stat_m[head * rep + warp] = M;
                p.stat_l[head * rep + warp] = den;
            }
        }
    }
    __syncthreads();
    T* og = static_cast<T*>(p.o) + head * rep * D;
    for (int i = threadIdx.x; i < rep * D; i += COMBINE_THREADS) {
        const int r = i / D, d = i % D;
        const float* acc = p.part_acc + (head * S * rep + r) * D + d;
        float num = 0.f;
#pragma unroll 4
        for (int s = 0; s < S; ++s) num = fmaf(w_s[r * S + s], acc[(size_t)s * rep * D], num);
        from_f(num / fmaxf(den_s[r], 1e-30f), og + r * D + d);
    }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
    const size_t smem = Layout<D, T>::smem;
    cudaError_t err = cudaFuncSetAttribute(
        decode_split<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    decode_split<T, D><<<dim3(p.splits, p.Hkv, p.B), THREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t combine_smem = (size_t)(MAX_REP * p.splits + MAX_REP) * sizeof(float);
    if (p.stat_m)           // partial mode: the output in fp32
        decode_combine<float, D><<<dim3(p.Hkv, p.B), COMBINE_THREADS, combine_smem, stream>>>(p);
    else
        decode_combine<T, D><<<dim3(p.Hkv, p.B), COMBINE_THREADS, combine_smem, stream>>>(p);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int D, cudaStream_t s) {
    if (D == 128) return launch<T, 128>(p, s);
    if (D == 64) return launch<T, 64>(p, s);
    if (D == 16) return launch<T, 16>(p, s);
    return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The wgmma body: bf16, head_dim 17-128 and a multiple of 8; TMA + wgmma,
// the split merge in the same launch.
constexpr int W_THREADS = 160;            // consumer warpgroup (warps 0-3), producer warp 4
constexpr int W_CTAS_PER_SM = 2;          // flash_decode.py's CTAS_PER_SM
constexpr uint32_t TILE_BOX = TK * ROW_BYTES;   // a box of 64 keys x 64 columns: 8 KB
constexpr uint32_t RING_BYTES = 96 * 1024;
constexpr uint32_t Q_BOX = 8 * ROW_BYTES;       // 8 query heads x 64 columns, swizzled

// Shared memory, from a 1024-byte aligned base: the ring (per stage the K
// boxes, then the V boxes), q (NB boxes), P hi and P lo, the cross-warp
// reduction, the merge flag, the mbarriers.  After the walk the ring holds
// the merge's weights.
template <int NB>
struct WLayout {
    static constexpr uint32_t STAGE = 2 * NB * TILE_BOX;
    static constexpr int STAGES = RING_BYTES / STAGE;         // 3 at NB = 2, 6 at NB = 1
    static constexpr uint32_t q = STAGES * STAGE;
    static constexpr uint32_t p = q + NB * Q_BOX;             // hi, then lo at + Q_BOX
    static constexpr uint32_t red = p + 2 * Q_BOX;            // 4 warps x 8 floats
    static constexpr uint32_t last = red + 4 * 8 * 4;
    static constexpr uint32_t bars = last + 16;               // full[STAGES], empty[STAGES]
    static constexpr size_t smem = 1024 + bars + 16 * STAGES;
};
// 228 KB of shared memory an SM, 1 KB of it reserved per CTA
static_assert(W_CTAS_PER_SM * (WLayout<2>::smem + 1024) <= 233472 &&
              W_CTAS_PER_SM * (WLayout<1>::smem + 1024) <= 233472,
              "two wgmma CTAs fit an SM");
static_assert((2 * MAX_SPLITS * MAX_REP + MAX_REP * 128) * 4 <= RING_BYTES,
              "the merge's m, l and one split's acc fit the ring");

struct WParams {
    const __nv_bfloat16* q; const int* valid_len;
    float* part_m; float* part_l; float* part_acc;   // (B, Hkv, splits, rep[, D])
    int* counters;                                   // (B, Hkv), 0 between calls
    void* o;                                         // bf16, or fp32 with the statistics
    float* stat_m; float* stat_l;                    // (B, Hkv x rep) or null
    int Hkv, rep, L, D, splits;
    float softcap, scale;
};

// D (64 x 8) (+)= A B, both from shared memory: m64n8k16, fp32 accumulator;
// TRANS_A = 1 reads A (M x K) M-major
template <int TRANS_A>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da, uint64_t db,
                                         int accumulate) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A));
}

// element i of the output: bf16, or fp32 in partial mode (statistics asked for)
__device__ __forceinline__ void store_out(const WParams& p, size_t i, float x) {
    if (p.stat_m) static_cast<float*>(p.o)[i] = x;
    else static_cast<__nv_bfloat16*>(p.o)[i] = __float2bfloat16_rn(x);
}

// the four consumer warps, without the producer
__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// byte offset of (row, 16-byte chunk) in a 128B-swizzled box of 128-byte rows
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
    return row * ROW_BYTES + (((chunk ^ row) & 7) << 4);
}

template <int NB>
__global__ void __launch_bounds__(W_THREADS, W_CTAS_PER_SM)
decode_wgmma(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
             const WParams p) {
    using Lay = WLayout<NB>;
    constexpr int STAGES = Lay::STAGES, DP = NB * BOX_COLS;
    extern __shared__ __align__(16) unsigned char smem_w[];
    const uint32_t base = (smem_u32(smem_w) + 1023u) & ~1023u;
    unsigned char* sm = smem_w + (base - smem_u32(smem_w));   // base, as a pointer
    float* red = reinterpret_cast<float*>(sm + Lay::red);
    auto full = [&](int s) { return base + Lay::bars + 8 * s; };
    auto empty = [&](int s) { return base + Lay::bars + 8 * (STAGES + s); };

    const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int head = b * p.Hkv + h, rep = p.rep, D = p.D;
    const int vl = min(p.valid_len[b], p.L);             // keys [0, vl) are live
    const int live = (vl + TK - 1) / TK;
    const int per = (live + p.splits - 1) / p.splits;
    const int t_lo = sp * per, t_hi = min(live, t_lo + per);

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 4);                      // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= 128) {
        // ---- producer warp: one thread keeps the ring full ----
        if (threadIdx.x == 128) {
            for (int t = t_lo; t < t_hi; ++t) {
                const int n = t - t_lo, s = n % STAGES;
                mbar_wait(empty(s), ((n / STAGES) & 1) ^ 1);   // round 0 passes at once
                const uint32_t st = base + s * Lay::STAGE;
                mbar_expect_tx(full(s), Lay::STAGE);
#pragma unroll
                for (int i = 0; i < NB; ++i) {
                    tma_load(st + i * TILE_BOX, &tm_k, full(s), i * BOX_COLS, t * TK, head);
                    tma_load(st + (NB + i) * TILE_BOX, &tm_v, full(s), i * BOX_COLS, t * TK,
                             head);
                }
            }
        }
        return;
    }

    // ---- consumer warpgroup ----
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tig = lane % 4;
    const size_t q_row0 = ((size_t)b * p.Hkv + h) * rep;      // query head h rep of b
    // q as the B operand of S^T: row r is query head r (zeros past rep), 16
    // bytes a thread a step, zeros past D, swizzled like a TMA box
    for (int i = tid; i < DP; i += 128) {
        const int r = i / (DP / 8), c = i % (DP / 8);
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rep && 8 * c < D)
            val = *reinterpret_cast<const uint4*>(p.q + (q_row0 + r) * D + 8 * c);
        *reinterpret_cast<uint4*>(sm + Lay::q + (c / 8) * Q_BOX + sw128(r, c % 8)) = val;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();

    const uint32_t q_s = base + Lay::q, p_s = base + Lay::p;
    // this thread's share: S^T rows (keys) 16 warp + g and + 8, O^T rows
    // (head_dim) 64 mt + 16 warp + g and + 8, columns (query heads) 2 tig, + 1
    constexpr int KS = DP / 16;                 // 16-column steps of q K^T
    constexpr int KV = TK / 16;                 // 16-key steps of V^T P
    float o[NB][4], sc[KS][4], pv[NB * KV][4];
#pragma unroll
    for (int mt = 0; mt < NB; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    for (int t = t_lo; t < t_hi; ++t) {
        const int n = t - t_lo, s = n % STAGES;
        mbar_wait(full(s), (n / STAGES) & 1);
        const uint32_t k_tile = base + s * Lay::STAGE, v_tile = k_tile + NB * TILE_BOX;

        // S^T (64 keys x 8) = K q^T: one product per 16 columns of head_dim,
        // each into its own accumulator, summed here in fp32 (the tensor
        // cores' fp32 sums are not IEEE-rounded; chaining all of them into
        // one accumulator moved the served outputs past the bf16 bounds)
        fence_acc<KS>(sc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
            wgmma_n8<0>(sc[kk], sw128_desc(k_tile + (kk / 4) * TILE_BOX + (kk % 4) * 32, 16,
                                           8 * ROW_BYTES),
                        sw128_desc(q_s + (kk / 4) * Q_BOX + (kk % 4) * 32, 16, 8 * ROW_BYTES),
                        0);
        wg_commit();
        wg_wait();
        fence_acc<KS>(sc);

        // scale, softcap and mask; the tile's row maximum over the four warps
        const int key0 = t * TK + 16 * warp + g;
        float sv[4], mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float x = 0.f;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) x += sc[kk][e];
            x *= p.scale;
            if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
            sv[e] = key0 + 8 * (e >> 1) < vl ? x : NEG_INF;
            mx[e & 1] = fmaxf(mx[e & 1], sv[e]);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
                mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], off));
        if (g == 0) {
            red[warp * 8 + 2 * tig] = mx[0];
            red[warp * 8 + 2 * tig + 1] = mx[1];
        }
        consumer_sync();
        float alpha[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int col = 2 * tig + c;
            const float tile_max = fmaxf(fmaxf(red[col], red[8 + col]),
                                         fmaxf(red[16 + col], red[24 + col]));
            const float m_new = fmaxf(m[c], tile_max);
            alpha[c] = expf(m[c] - m_new);
            m[c] = m_new;
        }
        float pr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) pr[e] = expf(sv[e] - m[e & 1]);
#pragma unroll
        for (int c = 0; c < 2; ++c) l[c] = l[c] * alpha[c] + (pr[c] + pr[c + 2]);

        // P as the B operand of O^T += V^T P: row = query head, its 64 keys
        // in 128 bytes, swizzled; hi, then lo one box further
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int col = 2 * tig + (e & 1), key = 16 * warp + g + 8 * (e >> 1);
            const __nv_bfloat16 hi = __float2bfloat16_rn(pr[e]);
            const __nv_bfloat16 lo = __float2bfloat16_rn(pr[e] - __bfloat162float(hi));
            unsigned char* at = sm + Lay::p + sw128(col, key >> 3) + (key & 7) * 2;
            *reinterpret_cast<__nv_bfloat16*>(at) = hi;
            *reinterpret_cast<__nv_bfloat16*>(at + Q_BOX) = lo;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumer_sync();

        // V^T P per 64-column box of V (mt) and 16 keys (kk), each into its
        // own accumulator (P hi, then P lo); V (keys x head_dim) read
        // head_dim-major; then O^T = O^T alpha + their fp32 sum
        fence_acc<NB * KV>(pv);
        wg_fence();
#pragma unroll
        for (int mt = 0; mt < NB; ++mt)
#pragma unroll
            for (int kk = 0; kk < KV; ++kk) {
                const uint64_t dv = sw128_desc(v_tile + mt * TILE_BOX + kk * 16 * ROW_BYTES,
                                               TILE_BOX, 8 * ROW_BYTES);
                wgmma_n8<1>(pv[mt * KV + kk], dv,
                            sw128_desc(p_s + kk * 32, 16, 8 * ROW_BYTES), 0);
                wgmma_n8<1>(pv[mt * KV + kk], dv,
                            sw128_desc(p_s + Q_BOX + kk * 32, 16, 8 * ROW_BYTES), 1);
            }
        wg_commit();
        wg_wait();
        fence_acc<NB * KV>(pv);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
#pragma unroll
        for (int mt = 0; mt < NB; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = 0.f;
#pragma unroll
                for (int kk = 0; kk < KV; ++kk) x += pv[mt * KV + kk][e];
                o[mt][e] = o[mt][e] * alpha[e & 1] + x;
            }
    }

    // l over the keys of all four warps, in warp order; every read of red
    // came before the last tile's second barrier
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) l[c] += __shfl_xor_sync(0xffffffffu, l[c], off);
    if (g == 0) {
        red[warp * 8 + 2 * tig] = l[0];
        red[warp * 8 + 2 * tig + 1] = l[1];
    }
    consumer_sync();
    float lsum[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        const int col = 2 * tig + c;
        lsum[c] = ((red[col] + red[8 + col]) + red[16 + col]) + red[24 + col];
    }

    const size_t o0 = q_row0 * D;                      // this (b, KV head)'s output rows
    if (p.splits == 1) {
#pragma unroll
        for (int mt = 0; mt < NB; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = 2 * tig + (e & 1), d = mt * 64 + 16 * warp + g + 8 * (e >> 1);
                if (col < rep && d < D)
                    store_out(p, o0 + col * D + d, o[mt][e] / fmaxf(lsum[e & 1], 1e-30f));
            }
        if (p.stat_m && warp == 0 && g == 0) {
#pragma unroll
            for (int c = 0; c < 2; ++c)
                if (2 * tig + c < rep) {
                    p.stat_m[q_row0 + 2 * tig + c] = m[c];
                    p.stat_l[q_row0 + 2 * tig + c] = lsum[c];
                }
        }
        return;
    }

    // this split's partial (m, l, acc), then count it in: the stores
    // ordered before the count by the barrier and one thread's fence
    const size_t h0 = (size_t)head * p.splits * rep, row0 = h0 + (size_t)sp * rep;
    if (warp == 0 && g == 0) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
            if (2 * tig + c < rep) {
                p.part_m[row0 + 2 * tig + c] = m[c];
                p.part_l[row0 + 2 * tig + c] = lsum[c];
            }
    }
#pragma unroll
    for (int mt = 0; mt < NB; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int col = 2 * tig + (e & 1), d = mt * 64 + 16 * warp + g + 8 * (e >> 1);
            if (col < rep && d < D) p.part_acc[(row0 + col) * D + d] = o[mt][e];
        }
    consumer_sync();
    int* last = reinterpret_cast<int*>(sm + Lay::last);
    if (tid == 0) {
        asm volatile("fence.acq_rel.gpu;\n" ::: "memory");       // release the partials
        const bool is_last = atomicAdd(p.counters + head, 1) == p.splits - 1;
        if (is_last) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");   // acquire the rest
        *last = is_last;
    }
    consumer_sync();
    if (!*last) return;

    // the last split to arrive merges all of them, in split order:
    // M = max m_s, out = sum e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s, 1e-30).
    // One round trip: every split's m and l, and the acc of the first SC
    // splits (all of them unless S x rep x D floats overflow the ring), are
    // copied into the ring, cp.async for the accumulators (past L1, as the
    // loads of m and l), every copy in flight at once.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // the ring, now generic
    const int S = p.splits, RD = rep * D;
    const int SC = min(S, ((int)RING_BYTES / 4 - 2 * S * rep) / RD);
    float* acc_s = reinterpret_cast<float*>(sm);       // (SC, rep, D), then weights, l
    float* w_s = acc_s + SC * RD;
    float* l_s = w_s + S * rep;
    float* den_s = reinterpret_cast<float*>(sm + Lay::red);
    for (int i = tid; i < SC * RD / 4; i += 128)
        cp_async16(acc_s + 4 * i, p.part_acc + h0 * D + 4 * i, true);
    cp_async_commit();
    for (int i = tid; i < S * rep; i += 128) {           // while the copies fly
        w_s[i] = __ldcg(p.part_m + h0 + i);
        l_s[i] = __ldcg(p.part_l + h0 + i);
    }
    cp_async_wait<0>();
    consumer_sync();
    if (tid < rep) {
        float M = NEG_INF;
        for (int s = 0; s < S; ++s) M = fmaxf(M, w_s[s * rep + tid]);
        float den = 0.f;
        for (int s = 0; s < S; ++s) {
            const float w = expf(w_s[s * rep + tid] - M);
            w_s[s * rep + tid] = w;
            den = den + w * l_s[s * rep + tid];
        }
        den_s[tid] = den;
        if (p.stat_m) {
            p.stat_m[q_row0 + tid] = M;
            p.stat_l[q_row0 + tid] = den;
        }
    }
    consumer_sync();
    for (int i = tid; i < RD; i += 128) {
        const int r = i / D;
        float num = 0.f;
        for (int s = 0; s < SC; ++s) num = num + w_s[s * rep + r] * acc_s[s * RD + i];
        for (int s = SC; s < S; ++s)
            num = num + w_s[s * rep + r] * __ldcg(p.part_acc + (h0 + (size_t)s * rep) * D + i);
        store_out(p, o0 + i, num / fmaxf(den_s[r], 1e-30f));
    }
    if (tid == 0) p.counters[head] = 0;                 // ready for the next call
}

template <int NB>
cudaError_t launch_wgmma(const WParams& p, const void* k, const void* v, int B,
                         cudaStream_t stream) {
    // The runtime call comes first: it makes the device's primary context
    // current in the calling thread, which cuTensorMapEncodeTiled needs.
    const size_t smem = WLayout<NB>::smem;
    cudaError_t err = cudaFuncSetAttribute(decode_wgmma<NB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    CUtensorMap tk, tv;
    err = make_map(&tk, k, p.D, p.L, B * p.Hkv, TK);
    if (err == cudaSuccess) err = make_map(&tv, v, p.D, p.L, B * p.Hkv, TK);
    if (err != cudaSuccess) return err;
    decode_wgmma<NB><<<dim3(p.splits, p.Hkv, B), W_THREADS, smem, stream>>>(tk, tv, p);
    return cudaGetLastError();
}

template <int NB>
cudaError_t ctas_per_sm(int* n) {
    cudaError_t err = cudaFuncSetAttribute(decode_wgmma<NB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)WLayout<NB>::smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, decode_wgmma<NB>, W_THREADS,
                                                         WLayout<NB>::smem);
}

bool wgmma_head_dim(int D) { return D > 16 && D <= 128 && D % 8 == 0; }

}  // namespace

extern "C" int avo_flash_decode(
        const void* q, const void* k, const void* v, const void* valid_len,
        void* part_m, void* part_l, void* part_acc, void* o, void* stat_m, void* stat_l,
        int dtype_bf16,
        int B, int Hkv, int rep, int L, int D, int splits,
        float softcap, float scale, void* stream) {
    if (rep < 1 || rep > MAX_REP || B < 1 || Hkv < 1 || L < 1 || splits < 1 ||
        splits > MAX_SPLITS ||
        Hkv > 65535 || B > 65535)
        return (int)cudaErrorInvalidValue;
    Params p{q, k, v, static_cast<const int*>(valid_len),
             static_cast<float*>(part_m), static_cast<float*>(part_l),
             static_cast<float*>(part_acc), o, static_cast<float*>(stat_m),
             static_cast<float*>(stat_l), B, Hkv, rep, L, splits, softcap, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = dtype_bf16 ? dispatch<__nv_bfloat16>(p, D, s)
                                 : dispatch<float>(p, D, s);
    return (int)err;
}

// counters: an int per (b, KV head), all 0, kept by the caller between calls
// (unused with one split, as the scratch is)
extern "C" int avo_flash_decode_wgmma(
        const void* q, const void* k, const void* v, const void* valid_len,
        void* part_m, void* part_l, void* part_acc, void* counters, void* o,
        void* stat_m, void* stat_l, int B, int Hkv, int rep, int L, int D, int splits,
        float softcap, float scale, void* stream) {
    if (rep < 1 || rep > MAX_REP || B < 1 || Hkv < 1 || L < 1 || splits < 1 ||
        splits > MAX_SPLITS || Hkv > 65535 || B > 65535 || !wgmma_head_dim(D) ||
        (splits > 1 && (!part_m || !counters)) || (!stat_m != !stat_l))
        return (int)cudaErrorInvalidValue;
    WParams p{static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(valid_len),
              static_cast<float*>(part_m), static_cast<float*>(part_l),
              static_cast<float*>(part_acc), static_cast<int*>(counters),
              o, static_cast<float*>(stat_m), static_cast<float*>(stat_l), Hkv, rep, L, D,
              splits, softcap, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(D > 64 ? launch_wgmma<2>(p, k, v, B, s) : launch_wgmma<1>(p, k, v, B, s));
}

extern "C" int avo_flash_decode_wgmma_ctas_per_sm(int D, int* n) {
    if (!wgmma_head_dim(D)) return (int)cudaErrorInvalidValue;
    return (int)(D > 64 ? ctas_per_sm<2>(n) : ctas_per_sm<1>(n));
}
