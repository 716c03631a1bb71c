// Single-token decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py::flash_decode
// (body _decode_body).  It computes the same function: for every sequence b
// and query head, softmax(q K^T * scale [softcap], keys [0, valid_len[b])) V
// over a cache (B, Hkv, L, D), with an online softmax, fp32 statistics and
// the reference's finite -1e30 mask.  Query head h reads KV head h / rep.
//
// Split-K (flash-decoding).  Two kernels.
//   decode_split: grid (splits, Hkv, B), 128 threads.  The rep query heads
//     of a KV head are the rows of every score product, so each K/V tile
//     loaded into shared memory serves all of them: the TPU kernel's
//     (rep x D) . (D x bk) packing.  A CTA reads valid_len[b] on the device
//     and takes ceil(live_tiles / splits) consecutive tiles of 64 keys from
//     the live ones, so every split count works whatever the prompt length
//     and the host never syncs; tiles at or past valid_len[b] are never
//     loaded, and the ragged end of the last live tile is masked here.  The
//     tiles are double-buffered with cp.async: tile t + 1 loads while tile t
//     is computed.  Per tile:
//       1. two threads per key compute its scores against all rep rows,
//          each over alternate 16-byte pieces of the row, from shared memory;
//       2. warp w owns rows w and w + 4: it takes the row maximum, rescales
//          its running (m, l) and turns the scores into p = exp(s - m_new);
//       3. every thread owns one column d of the output (and, when D < 128,
//          one block of keys) for all rep rows: acc = acc * alpha + p . V.
//     The split writes its (m, l, acc) to fp32 scratch; a split with no live
//     tile writes m = -1e30, l = 0, acc = 0.
//   decode_combine: grid (Hkv, B).  Per (sequence, query head) and column d:
//     M = max_s m_s, out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s,
//     1e-30), written in the input dtype; the weights e^(m_s - M) are made
//     once per row, in shared memory.  With one split this is
//     acc / max(l, 1e-30) exactly.
// The statistics are (rep,) vectors: the TPU kernel's (rep, 128) scratch
// was a lane-width artefact.
//
// Types.  fp32 and bf16 inputs; both products, the statistics and the
// accumulator are IEEE fp32 (FFMA, expf, tanhf), so fp32 inputs agree with
// the plain version to a few ulps, and bf16 outputs are rounded once.
//
// Bound.  Bytes: one call reads 2 x valid_len x D x sizeof(T) bytes of K/V
// per (b, KV head) and does 4 x rep x valid_len x D operations on them,
// about one operation per byte.  At the served Jamba shape (B = 4, Hkv = 8,
// rep = 4, D = 128, valid_len ~ 1900) that is ~31 MB, ~9.4 us at 3.35 TB/s.
// One CTA per (b, KV head) left 100 of the 132 SMs idle there and loaded
// each tile with no overlap; the split count the wrapper picks (enough
// splits to put a CTA on every SM), the double buffer and the per-key score
// threads address that: 39 us with 5 splits against 123 us with one, L2
// cold (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md).  Each
// CTA still waits on its tile loads and its three barriers per tile.  Left
// for later: TMA loads, and CUDA graphs over the decode step, which is
// host-bound.
//
// C interface: avo_flash_decode(...) launches both kernels on the given
// stream and returns a CUDA error code as an int (0: launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TK = 64;           // keys per tile
constexpr int MAX_REP = 8;       // query heads per KV head
constexpr float NEG_INF = -1e30f;

struct Params {
    const void* q; const void* k; const void* v; const int* valid_len;
    float* part_m; float* part_l; float* part_acc;   // (B, Hkv, splits, rep[, D])
    void* o;
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
// sums the weighted partial accumulators of its (row, column) pairs.
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
        if (lane == 0) den_s[warp] = den;
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
    decode_combine<T, D><<<dim3(p.Hkv, p.B), COMBINE_THREADS, combine_smem, stream>>>(p);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int D, cudaStream_t s) {
    if (D == 128) return launch<T, 128>(p, s);
    if (D == 16) return launch<T, 16>(p, s);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int avo_flash_decode(
        const void* q, const void* k, const void* v, const void* valid_len,
        void* part_m, void* part_l, void* part_acc, void* o, int dtype_bf16,
        int B, int Hkv, int rep, int L, int D, int splits,
        float softcap, float scale, void* stream) {
    if (rep < 1 || rep > MAX_REP || B < 1 || Hkv < 1 || L < 1 || splits < 1 ||
        splits > MAX_SPLITS ||
        Hkv > 65535 || B > 65535)
        return (int)cudaErrorInvalidValue;
    Params p{q, k, v, static_cast<const int*>(valid_len),
             static_cast<float*>(part_m), static_cast<float*>(part_l),
             static_cast<float*>(part_acc), o, B, Hkv, rep, L, splits, softcap, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = dtype_bf16 ? dispatch<__nv_bfloat16>(p, D, s)
                                 : dispatch<float>(p, D, s);
    return (int)err;
}
