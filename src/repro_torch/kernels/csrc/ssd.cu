// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py::ssd_chunked (body
// _ssd_body).  It computes the same function: for x (B, L, H, P), step sizes
// dt (B, L, H), decay rates A (H,) and one group of B, C (B, L, 1, N), cut
// into chunks of Q steps with cum = cumsum(dt A) inside a chunk,
//   y[i]   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//          + exp(cum_i) C_i . state                                   (inter)
//   state' = exp(cum_Q) state + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
// and returns y and the final fp32 state (B, H, P, N).
//
// Walk.  The TPU grid carried the chunk axis in order ("arbitrary"); blocks
// on Hopper run in no order, so the chunk axis is a loop inside one CTA of
// 256 threads per (head, sequence), which carries the fp32 (P, N) state in
// shared memory from chunk to chunk.  The TPU kernel's head block (bh heads
// per grid step) only shared C . B^T between heads; here each head is its
// own CTA (B x H = 512 CTAs at the served Jamba shape) and recomputes that
// product, a quarter of the work of the w . x product at P = 64, N = 16.
// Per chunk:
//   1. dt is loaded and cum is a block-wide inclusive scan of dt A;
//   2. for every tile of 64 output rows i: y = exp(cum_i) C_i . state, then
//      for every tile of 64 source rows j <= i: the (64 x 64) weight tile
//      w = (C_i . B_j) exp(cum_i - cum_j) dt_j, with the causal mask applied
//      BEFORE the exp (w = 0 where j > i, as the reference masks at :51),
//      and y += w . x_j.  The (Q, Q, bh) decay tensor is never formed: at
//      Q = 256 it would not fit;
//   3. the state is updated from the chunk's B, x and exp(cum_Q - cum_j) dt_j.
// A sequence length that is not a multiple of the chunk is masked in the
// kernel: steps past L count as x = 0, dt = 0, which neither decays nor
// updates the state, and their y is not written.  So any L runs here.
//
// Types.  fp32 and bf16 x, B, C; dt and A are fp32.  Everything is computed
// in IEEE fp32 FFMA from values widened on load, and y is rounded to the
// input type once.
//
// Bound.  At the served Jamba shape (B = 4, L ~ 2000, H = 128, P = 64,
// N = 16, Q = 256, bf16) one launch moves ~270 MB (x and y dominate), ~80 us
// at 3.35 TB/s, against ~37 GFLOP of useful products, ~40 us at the bf16
// tensor-core peak: bytes bound it.  This first version is simple, not
// fast: it runs its products on the CUDA cores in fp32 (67 TFLOP/s peak) and
// stages tiles with plain loads.  A tensor-core (mma / wgmma) version of the
// two chunk products is later work.
//
// Supported (P, N): (64, 16) Jamba, (64, 128) mamba2-780m, (16, 16) the
// reduced test configs.  Chunk Q <= 256.
//
// C interface: avo_ssd_chunked(...) launches on the given stream and returns
// cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXQ = THREADS;     // one scan element per thread
constexpr int TQ = 64;            // rows of an i or j tile
constexpr int TW = TQ + 1;        // padded weight-tile row

struct Params {
    const void* x; const float* dt; const float* A; const void* Bm; const void* Cm;
    void* y; float* state;
    int B, L, H, Q;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) {
    *dst = __float2bfloat16_rn(x);
}

template <int P, int N> struct Layout {
    static constexpr int LN = N + 1;      // padded B / C / state rows
    static constexpr int LP = P + 1;      // padded x rows
    static constexpr size_t floats = 3 * MAXQ + WARPS       // cum, dt, u, scan
                                   + 2 * TQ * LN            // C tile, B tile
                                   + TQ * LP                // x tile
                                   + TQ * TW                // weight tile
                                   + P * LN;                // state
    static constexpr size_t smem = floats * sizeof(float);
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const Params p) {
    using Lay = Layout<P, N>;
    constexpr int LN = Lay::LN, LP = Lay::LP;
    constexpr int RP = P / 16;                 // output columns per thread
    constexpr int E = P * N / THREADS;         // state entries per thread
    static_assert(P % 16 == 0 && (P * N) % THREADS == 0, "tile mapping");
    extern __shared__ __align__(16) float sm[];
    float* cum_s = sm;
    float* dt_s = cum_s + MAXQ;
    float* u_s = dt_s + MAXQ;
    float* scan_s = u_s + MAXQ;
    float* c_s = scan_s + WARPS;
    float* b_s = c_s + TQ * LN;
    float* x_s = b_s + TQ * LN;
    float* w_s = x_s + TQ * LP;
    float* st_s = w_s + TQ * TW;

    const int h = blockIdx.x, b = blockIdx.y;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int ty = tid / 16, tx = tid % 16;
    const int L = p.L, H = p.H, Q = p.Q;
    const float A = p.A[h];
    const T* xg = static_cast<const T*>(p.x);
    const T* Bg = static_cast<const T*>(p.Bm);
    const T* Cg = static_cast<const T*>(p.Cm);
    T* yg = static_cast<T*>(p.y);
    const size_t row0 = (size_t)b * L;         // first step of this sequence

    for (int e = tid; e < P * LN; e += THREADS) st_s[e] = 0.f;

    // rows [r0, r0 + TQ) of the chunk into a (TQ, N) tile; rows past the
    // chunk or past L are zeros
    auto load_bc = [&](const T* g, float* s, int t0, int r0, int nq) {
        for (int e = tid; e < TQ * N; e += THREADS) {
            const int r = e / N, n = e % N;
            float v = 0.f;
            if (r0 + r < nq) v = to_f(g[(row0 + t0 + r0 + r) * N + n]);
            s[r * LN + n] = v;
        }
    };
    auto load_x = [&](int t0, int r0, int nq) {
        for (int e = tid; e < TQ * P; e += THREADS) {
            const int r = e / P, c = e % P;
            float v = 0.f;
            if (r0 + r < nq) v = to_f(xg[((row0 + t0 + r0 + r) * H + h) * P + c]);
            x_s[r * LP + c] = v;
        }
    };

    for (int t0 = 0; t0 < L; t0 += Q) {
        const int nq = min(Q, L - t0);         // live steps of this chunk

        // 1. cum = inclusive scan of dt A over the chunk (zeros past nq)
        const float dti = tid < nq ? p.dt[(row0 + t0 + tid) * H + h] : 0.f;
        float a = dti * A;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float v = __shfl_up_sync(0xffffffffu, a, o);
            if (lane >= o) a += v;
        }
        if (lane == 31) scan_s[warp] = a;
        __syncthreads();
        if (warp == 0) {
            float v = lane < WARPS ? scan_s[lane] : 0.f;
#pragma unroll
            for (int o = 1; o < WARPS; o <<= 1) {
                const float w = __shfl_up_sync(0xffffffffu, v, o);
                if (lane >= o) v += w;
            }
            if (lane < WARPS) scan_s[lane] = v;
        }
        __syncthreads();
        if (warp > 0) a += scan_s[warp - 1];
        cum_s[tid] = a;
        dt_s[tid] = dti;
        __syncthreads();
        const float total = cum_s[Q - 1];
        u_s[tid] = expf(total - a) * dti;     // state-update weight of step tid

        // 2. y for every tile of output rows
        for (int i0 = 0; i0 < nq; i0 += TQ) {
            load_bc(Cg, c_s, t0, i0, nq);
            __syncthreads();
            float acc[4][RP];
#pragma unroll
            for (int ai = 0; ai < 4; ++ai) {
                const int i = ty + 16 * ai;
                const float* cr = c_s + i * LN;
                const float ec = expf(cum_s[min(i0 + i, MAXQ - 1)]);
#pragma unroll
                for (int c = 0; c < RP; ++c) {
                    const float* sr = st_s + (tx + 16 * c) * LN;
                    float s = 0.f;
#pragma unroll 16
                    for (int n = 0; n < N; ++n) s = fmaf(cr[n], sr[n], s);
                    acc[ai][c] = s * ec;
                }
            }
            for (int j0 = 0; j0 <= i0; j0 += TQ) {
                __syncthreads();               // b_s, x_s, w_s are reloaded
                load_bc(Bg, b_s, t0, j0, nq);
                load_x(t0, j0, nq);
                __syncthreads();
                // the weight tile, masked before the exp
#pragma unroll
                for (int ai = 0; ai < 4; ++ai) {
                    const int i = ty + 16 * ai, ig = i0 + i;
                    const float* cr = c_s + i * LN;
#pragma unroll
                    for (int cj = 0; cj < 4; ++cj) {
                        const int j = tx + 16 * cj, jg = j0 + j;
                        float w = 0.f;
                        if (jg <= ig && ig < nq) {
                            const float* br = b_s + j * LN;
                            float s = 0.f;
#pragma unroll 16
                            for (int n = 0; n < N; ++n) s = fmaf(cr[n], br[n], s);
                            w = s * expf(cum_s[ig] - cum_s[jg]) * dt_s[jg];
                        }
                        w_s[i * TW + j] = w;
                    }
                }
                __syncthreads();
#pragma unroll
                for (int ai = 0; ai < 4; ++ai) {
                    const float* wr = w_s + (ty + 16 * ai) * TW;
#pragma unroll 8
                    for (int j = 0; j < TQ; ++j) {
                        const float w = wr[j];
                        const float* xr = x_s + j * LP;
#pragma unroll
                        for (int c = 0; c < RP; ++c)
                            acc[ai][c] = fmaf(w, xr[tx + 16 * c], acc[ai][c]);
                    }
                }
            }
#pragma unroll
            for (int ai = 0; ai < 4; ++ai) {
                const int ig = i0 + ty + 16 * ai;
                if (ig >= nq) continue;
                T* yr = yg + ((row0 + t0 + ig) * H + h) * P;
#pragma unroll
                for (int c = 0; c < RP; ++c) from_f(acc[ai][c], yr + tx + 16 * c);
            }
            __syncthreads();                   // c_s is reloaded next
        }

        // 3. state' = exp(total) state + sum_j u_j x_j B_j^T
        float upd[E];
#pragma unroll
        for (int k = 0; k < E; ++k) upd[k] = 0.f;
        for (int j0 = 0; j0 < nq; j0 += TQ) {
            load_bc(Bg, b_s, t0, j0, nq);
            load_x(t0, j0, nq);
            __syncthreads();
#pragma unroll
            for (int k = 0; k < E; ++k) {
                const int e = tid + THREADS * k, pp = e / N, n = e % N;
                float s = upd[k];
#pragma unroll 8
                for (int j = 0; j < TQ; ++j)
                    s = fmaf(u_s[min(j0 + j, MAXQ - 1)] * x_s[j * LP + pp],
                             b_s[j * LN + n], s);
                upd[k] = s;
            }
            __syncthreads();                   // b_s, x_s are reloaded next
        }
        const float et = expf(total);
#pragma unroll
        for (int k = 0; k < E; ++k) {
            const int e = tid + THREADS * k, pp = e / N, n = e % N;
            st_s[pp * LN + n] = st_s[pp * LN + n] * et + upd[k];
        }
        __syncthreads();                       // the next chunk reads the state
    }

    float* sg = p.state + ((size_t)b * H + h) * P * N;
    for (int e = tid; e < P * N; e += THREADS) sg[e] = st_s[(e / N) * LN + e % N];
}

template <typename T, int P, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
    const size_t smem = Layout<P, N>::smem;
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(p.H, p.B);
    ssd_kernel<T, P, N><<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int P, int N, cudaStream_t s) {
    if (P == 64 && N == 16) return launch<T, 64, 16>(p, s);
    if (P == 64 && N == 128) return launch<T, 64, 128>(p, s);
    if (P == 16 && N == 16) return launch<T, 16, 16>(p, s);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int avo_ssd_chunked(
        const void* x, const void* dt, const void* A, const void* Bm,
        const void* Cm, void* y, void* state, int dtype_bf16,
        int B, int L, int H, int P, int N, int Q, void* stream) {
    if (B < 1 || L < 1 || H < 1 || Q < 1 || Q > MAXQ)
        return (int)cudaErrorInvalidValue;
    Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
             y, static_cast<float*>(state), B, L, H, Q};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = dtype_bf16 ? dispatch<__nv_bfloat16>(p, P, N, s)
                                 : dispatch<float>(p, P, N, s);
    return (int)err;
}
