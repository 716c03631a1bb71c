// Single-token decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py::flash_decode
// (body _decode_body).  It computes the same function: for every sequence b
// and query head, softmax(q K^T * scale [softcap], keys [0, valid_len[b])) V
// over a cache (B, Hkv, L, D), with an online softmax, fp32 statistics and
// the reference's finite -1e30 mask.  Query head h reads KV head h / rep.
//
// Walk.  One CTA of 128 threads per (KV head, sequence).  The rep query
// heads of that KV head are the rows of every score product, so each K/V
// tile that is loaded into shared memory serves all of them: the TPU
// kernel's (rep x D) . (D x bk) packing.  K and V stream through shared
// memory in tiles of 64 keys; tiles at or past valid_len[b] are never
// loaded (the reference's pl.when skip), and the ragged end of the last
// live tile is masked here, so the caller never pads L.  Per tile:
//   1. the tile is loaded (rows at or past L are zero-filled);
//   2. every thread computes scores of (row, key) pairs from shared memory;
//   3. warp w owns rows w and w + 4: it takes the row maximum, rescales its
//      running (m, l) and turns the scores into p = exp(s - m_new);
//   4. every thread owns one column d of the output (and, when D < 128, one
//      phase of the keys) for all rep rows: acc = acc * alpha + p . V.
// The statistics are (rep,) vectors: the TPU kernel's (rep, 128) scratch
// was a lane-width artefact.  l is clamped at 1e-30 before the division.
//
// Types.  fp32 and bf16 inputs; both products, the statistics and the
// accumulator are IEEE fp32 (FFMA, expf, tanhf), so fp32 inputs agree with
// the plain version to a few ulps, and bf16 outputs are rounded once.
//
// Bound.  Bytes: one launch reads 2 x valid_len x D x sizeof(T) bytes of
// K/V per (b, KV head) and does 4 x rep x valid_len x D operations on them,
// about one operation per byte.  At the served Jamba shape (B = 4, Hkv = 8,
// rep = 4, D = 128, valid_len ~ 2000) that is ~34 MB, ~10 us at 3.35 TB/s.
// This first version is simple, not fast: B x Hkv = 32 CTAs leave 100 of
// the 132 SMs idle and each CTA loads its tiles without overlap.  The first
// change a later PR makes is split-K (flash-decoding): several CTAs per
// (b, KV head) over slices of the cache, combined by a second pass.
//
// C interface: avo_flash_decode(...) launches on the given stream and returns
// cudaGetLastError() as an int.

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
    const void* q; const void* k; const void* v; const int* valid_len; void* o;
    int B, Hkv, rep, L;
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
    static constexpr int LDK = D + VEC;               // padded K row in smem
    static constexpr int KP = THREADS / D;            // key phases of the P V step
    static constexpr size_t smem = (size_t)TK * LDK * sizeof(T)     // K tile
                                 + (size_t)TK * D * sizeof(T)       // V tile
                                 + (size_t)MAX_REP * D * 4          // q rows
                                 + (size_t)MAX_REP * TK * 4         // scores / p
                                 + (size_t)2 * MAX_REP * 4          // alpha, l
                                 + (size_t)(KP > 1 ? KP * MAX_REP * D * 4 : 0);
};

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const Params p) {
    using Lay = Layout<D, T>;
    static_assert(THREADS % D == 0, "a column per thread, KP phases of keys");
    constexpr int KP = Lay::KP;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* k_s = reinterpret_cast<T*>(smem_raw);
    T* v_s = k_s + TK * Lay::LDK;
    float* q_s = reinterpret_cast<float*>(v_s + TK * D);
    float* s_s = q_s + MAX_REP * D;
    float* alpha_s = s_s + MAX_REP * TK;
    float* l_s = alpha_s + MAX_REP;
    float* red_s = l_s + MAX_REP;

    const int h = blockIdx.x, b = blockIdx.y;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int rep = p.rep;
    const int vl = min(p.valid_len[b], p.L);          // keys [0, vl) are live
    const size_t head = (size_t)b * p.Hkv + h;
    const T* qg = static_cast<const T*>(p.q) + head * rep * D;
    const T* kg = static_cast<const T*>(p.k) + head * (size_t)p.L * D;
    const T* vg = static_cast<const T*>(p.v) + head * (size_t)p.L * D;

    for (int i = tid; i < rep * D; i += THREADS) q_s[i] = to_f(qg[i]);

    // running statistics of the rows this warp owns (rows warp, warp + 4)
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
    // the output column and key phase this thread owns, for all rep rows
    const int d = tid % D, kp = tid / D;
    float acc[MAX_REP];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) acc[r] = 0.f;

    for (int t0 = 0; t0 < vl; t0 += TK) {
        // 1. the K/V tile, 16 bytes a thread a step; rows past L are zeros
        for (int i = tid; i < TK * Lay::VPR; i += THREADS) {
            const int row = i / Lay::VPR, c = (i % Lay::VPR) * Lay::VEC;
            uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
            if (t0 + row < p.L) {
                kv = *reinterpret_cast<const uint4*>(kg + (size_t)(t0 + row) * D + c);
                vv = *reinterpret_cast<const uint4*>(vg + (size_t)(t0 + row) * D + c);
            }
            *reinterpret_cast<uint4*>(k_s + row * Lay::LDK + c) = kv;
            *reinterpret_cast<uint4*>(v_s + row * D + c) = vv;
        }
        __syncthreads();

        // 2. scores s[r][j] = softcap(q_r . k_j * scale), masked past vl
        for (int i = tid; i < rep * TK; i += THREADS) {
            const int r = i / TK, j = i % TK;
            const float* qr = q_s + r * D;
            const T* kr = k_s + j * Lay::LDK;
            float s = 0.f;
#pragma unroll 16
            for (int e = 0; e < D; ++e) s = fmaf(qr[e], to_f(kr[e]), s);
            s *= p.scale;
            if (p.softcap != 0.f) s = p.softcap * tanhf(s / p.softcap);
            s_s[r * TK + j] = (t0 + j < vl) ? s : NEG_INF;
        }
        __syncthreads();

        // 3. online softmax, one warp per row
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

        // 4. acc = acc * alpha + p . V over this thread's key phase
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
            if (r < rep) acc[r] *= alpha_s[r];
        for (int j = kp; j < TK; j += KP) {
            const float vj = to_f(v_s[j * D + d]);
#pragma unroll
            for (int r = 0; r < MAX_REP; ++r)
                if (r < rep) acc[r] = fmaf(s_s[r * TK + j], vj, acc[r]);
        }
        __syncthreads();            // the tile and p are overwritten next
    }

#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int r = warp + WARPS * k;
        if (r < rep && lane == 0) l_s[r] = l_run[k];
    }
    if constexpr (KP > 1) {
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
            if (r < rep) red_s[(kp * MAX_REP + r) * D + d] = acc[r];
    }
    __syncthreads();
    if (kp != 0) return;
    T* og = static_cast<T*>(p.o) + head * rep * D;
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        float a = acc[r];
        if constexpr (KP > 1) {
            for (int k = 1; k < KP; ++k) a += red_s[(k * MAX_REP + r) * D + d];
        }
        from_f(a / fmaxf(l_s[r], 1e-30f), og + r * D + d);
    }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
    const size_t smem = Layout<D, T>::smem;
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(p.Hkv, p.B);
    decode_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
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
        void* o, int dtype_bf16, int B, int Hkv, int rep, int L, int D,
        float softcap, float scale, void* stream) {
    if (rep < 1 || rep > MAX_REP || B < 1 || Hkv < 1 || L < 1)
        return (int)cudaErrorInvalidValue;
    Params p{q, k, v, static_cast<const int*>(valid_len), o, B, Hkv, rep, L,
             softcap, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = dtype_bf16 ? dispatch<__nv_bfloat16>(p, D, s)
                                 : dispatch<float>(p, D, s);
    return (int)err;
}
