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
// Two bodies.  The wrapper (kernels/ssd.py::ssd_body) routes bf16 to the
// chunked body and fp32 to the serial one; neither falls back to the other.
//
// Serial body (ssd_kernel; every fp32 launch).  The TPU grid carried the
// chunk axis in order ("arbitrary"); here the chunk axis is a loop inside
// one CTA of 256 threads per (head, sequence), which carries the fp32 (P, N)
// state in shared memory from chunk to chunk.  Per chunk:
//   1. dt is loaded and cum is a block-wide inclusive scan of dt A;
//   2. for every tile of 64 output rows i: y = exp(cum_i) C_i . state, then
//      for every tile of 64 source rows j <= i: the (64 x 64) weight tile
//      w = (C_i . B_j) exp(cum_i - cum_j) dt_j, with the causal mask applied
//      BEFORE the exp (w = 0 where j > i, as the reference masks at :51),
//      and y += w . x_j.  The (Q, Q, bh) decay tensor is never formed;
//   3. the state is updated from the chunk's B, x and exp(cum_Q - cum_j) dt_j.
// IEEE fp32 FFMA throughout, from values widened on load.  512 CTAs at the
// served Jamba shape, each walking its 8 chunks in order (times: PERF.md).
//
// Chunked body (every bf16 launch): three kernels on the caller's stream.
//   1. ssd_chunk_state, grid (chunks, H, B): the chunk's cum and dt (to a
//      scratch tensor) and its local state from zero, S_c = x^T (u B) on
//      mma.sync;
//   2. ssd_state_pass, a thread per state entry: S_c becomes the state
//      entering chunk c, by the serial body's update;
//   3. ssd_chunk_scan, grid (chunks, H, B): y of every row of the chunk on
//      mma.sync, from the entering state, in tiles of 64 steps that carry
//      the state to the end of the previous tile: C R^T for the earlier
//      steps, C B^T and w x inside the row's own tile, x^T (u B) to move R.
// Every product has one operand that is exact in bf16 (x, B, C) and one in
// fp32 (u B, w, R); the fp32 one is split into SPLIT = 3 bf16 terms that
// sum to it exactly, so the products keep fp32 accuracy up to summation order
// on the tensor cores.  y is rounded to bf16 once.
//
// Both bodies mask a ragged last chunk in the kernel: steps past L count as
// x = 0, dt = 0, which neither decays nor updates the state, and their y is
// not written.  So any L runs here.
//
// Bound.  At the served Jamba shape (B = 4, L ~ 1900, H = 128, P = 64,
// N = 16, Q = 256, bf16) one launch must move ~250 MB (x in and y out
// dominate), ~76 us at 3.35 TB/s, against ~23 GFLOP of useful products,
// ~23 us at the bf16 tensor-core peak: bytes bound it.  The chunked body
// reads x twice (kernels 1 and 3) and runs each product three times (the
// split), on mma.sync rather than wgmma.
//
// Supported (P, N): (64, 16) Jamba, (64, 128) mamba2-780m, (16, 16) the
// reduced test configs.  Chunk Q <= 256.
//
// C interface: avo_ssd_chunked(...) (serial) and avo_ssd_chunk_parallel(...)
// (chunked) launch on the given stream and return cudaGetLastError() as an
// int.

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

// The block-wide inclusive scan of dt A over one chunk (THREADS threads, one
// step each; zeros past the chunk's live steps), as ssd_kernel scans it.
__device__ __forceinline__ float chunk_scan_dtA(float a, float* scan_s) {
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
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
    return a;
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
    const int tid = threadIdx.x;
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
        const float a = chunk_scan_dtA(dti * A, scan_s);
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

// ---------------------------------------------------------------------------
// The chunk-parallel body (bf16 x, B, C).
// ---------------------------------------------------------------------------

// Copied from flash_attention.cu (the build hashes each source's own text, so
// a shared header that changed would not trigger a rebuild).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
    uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    if constexpr (TRANS)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
    else
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
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
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::);
}


// An fp32 operand of a bf16 product is split into SPLIT bf16 terms, each the
// bf16 rounding of what the terms before it left: hi, mid, lo.  fp32 has 24
// significant bits and bf16 8, so three terms sum to the operand exactly and
// the products run in fp32 arithmetic up to summation order.  Two terms
// (hi + lo, 16 bits) leave ~2^-17 of it, enough to flip y's bf16 rounding in
// ~0.4 % of the elements: at one step (L = 1) that fails the whole-y bound
// in 20 of 600 draws (tests/test_torch_bf16_bound.py), three terms in none.
constexpr int SPLIT = 3;

// the terms of two values a, b as packed pairs, into t[k][q] for term k
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t (&t)[SPLIT][4], int q) {
#pragma unroll
    for (int k = 0; k < SPLIT; ++k) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
        const float2 f = __bfloat1622float2(h);
        t[k][q] = *reinterpret_cast<const uint32_t*>(&h);
        a -= f.x;
        b -= f.y;
    }
}

struct ChunkParams {
    const __nv_bfloat16* x; const float* dt; const float* A;
    const __nv_bfloat16* Bm; const __nv_bfloat16* Cm;
    __nv_bfloat16* y; float* state;
    float* cum;                 // (B, H, nc, 2, Q) scratch: each chunk's cum, then dt
    float* states;              // (B, H, nc, P, N) scratch: chunk states
    int B, L, H, Q, nc;
};

// rows [0, ROWS) of a tile whose row r is at g + r * stride, COLS bf16 a row,
// into smem rows of ld by NTHR threads; rows at or past `valid` are zero-filled
template <int COLS, int ROWS, int NTHR>
__device__ __forceinline__ void load_rows(__nv_bfloat16* s, int ld, const __nv_bfloat16* g,
                                          size_t stride, int valid) {
    constexpr int PER = COLS / 8;
    for (int e = threadIdx.x; e < ROWS * PER; e += NTHR) {
        const int r = e / PER, col = (e % PER) * 8;
        const bool ok = r < valid;
        cp_async16(s + r * ld + col, ok ? g + r * stride + col : g, ok);
    }
}

// 1. ssd_chunk_state: grid (nc, H, B), THREADS threads.  The chunk's cum and
// dt to the scratch, and its local state S = sum_j u_j x_j B_j^T (u_j = exp(cum_Q -
// cum_j) dt_j) on mma.sync: S = x^T (u B), x (exact in bf16) as A through
// ldmatrix .trans, u_j B_j (fp32) split into SPLIT bf16 terms as B
// fragments.  The whole chunk of x and B is staged with cp.async while the
// scan runs.  A warp owns UPW units of 16 (p) x 16 (n) and one of KS slices
// of the chunk's steps; the slices are summed at the end in a fixed order.
template <int P, int N> struct StateLayout {
    static constexpr int LDP = P + 8, LDN = N + 8;
    static constexpr int U = (P / 16) * (N / 16);
    static constexpr int KS = U >= WARPS ? 1 : WARPS / U;
    static constexpr int UPW = U >= WARPS ? U / WARPS : 1;
    static constexpr size_t bytes = (2 * MAXQ + WARPS) * sizeof(float)
                                  + (size_t)MAXQ * (LDP + LDN) * 2
                                  + (KS > 1 ? (size_t)KS * P * N * sizeof(float) : 0);
    static_assert(U % WARPS == 0 || WARPS % U == 0, "state units per warp");
};

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state(const ChunkParams p) {
    using SM = StateLayout<P, N>;
    constexpr int LDP = SM::LDP, LDN = SM::LDN, KS = SM::KS, UPW = SM::UPW;
    extern __shared__ __align__(16) float sm[];
    float* cum_s = sm;
    float* u_s = cum_s + MAXQ;
    float* scan_s = u_s + MAXQ;
    __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(scan_s + WARPS);   // (Q, P)
    __nv_bfloat16* b_s = x_s + MAXQ * LDP;                                   // (Q, N)
    float* red_s = reinterpret_cast<float*>(b_s + MAXQ * LDN);               // (KS, P, N)

    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tig = lane % 4;
    const int L = p.L, H = p.H, Q = p.Q, t0 = c * Q, nq = min(Q, L - t0);
    const int nq16 = (nq + 15) / 16 * 16;
    const size_t row0 = (size_t)b * L + t0;
    const size_t bhc = ((size_t)b * H + h) * p.nc + c;

    load_rows<P, MAXQ, THREADS>(x_s, LDP, p.x + (row0 * H + h) * P, (size_t)H * P, nq);
    load_rows<N, MAXQ, THREADS>(b_s, LDN, p.Bm + row0 * N, N, nq);
    cp_async_commit();

    const float dti = tid < nq ? p.dt[(row0 + tid) * H + h] : 0.f;
    const float a = chunk_scan_dtA(dti * p.A[h], scan_s);
    cum_s[tid] = a;
    if (tid < Q) {
        p.cum[bhc * 2 * Q + tid] = a;
        p.cum[bhc * 2 * Q + Q + tid] = dti;
    }
    __syncthreads();
    u_s[tid] = expf(cum_s[Q - 1] - a) * dti;
    cp_async_wait_all();
    __syncthreads();

    const int ks = warp % KS, u0 = (warp / KS) * UPW;
    float acc[UPW][2][4];
#pragma unroll
    for (int v = 0; v < UPW; ++v)
#pragma unroll
        for (int t = 0; t < 2; ++t) acc[v][t][0] = acc[v][t][1] = acc[v][t][2] = acc[v][t][3] = 0.f;
    for (int k0 = ks * 16; k0 < nq16; k0 += 16 * KS) {
        const int ja = k0 + 2 * tig, jb = ja + 8;     // this thread's B-fragment rows
        const float ua0 = u_s[ja], ua1 = u_s[ja + 1], ub0 = u_s[jb], ub1 = u_s[jb + 1];
#pragma unroll
        for (int v = 0; v < UPW; ++v) {
            const int unit = u0 + v;
            const int m0 = (unit / (N / 16)) * 16, n0 = (unit % (N / 16)) * 16;
            uint32_t af[4];
            ldmatrix_x4<true>(af, x_s + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDP
                                  + m0 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int t = 0; t < 2; ++t) {
                const int n = n0 + 8 * t + g;
                uint32_t bf[SPLIT][4];
                split_bf16(ua0 * __bfloat162float(b_s[ja * LDN + n]),
                           ua1 * __bfloat162float(b_s[(ja + 1) * LDN + n]), bf, 0);
                split_bf16(ub0 * __bfloat162float(b_s[jb * LDN + n]),
                           ub1 * __bfloat162float(b_s[(jb + 1) * LDN + n]), bf, 1);
#pragma unroll
                for (int k = 0; k < SPLIT; ++k) mma_bf16(acc[v][t], af, bf[k][0], bf[k][1]);
            }
        }
    }
    // acc[v][t]: rows p = m0 + g (+ 8), columns n = n0 + 8 t + 2 tig (+ 1)
    float* out = p.states + bhc * P * N;
    float* dst = KS > 1 ? red_s + ks * P * N : out;
#pragma unroll
    for (int v = 0; v < UPW; ++v) {
        const int unit = u0 + v;
        const int m0 = (unit / (N / 16)) * 16, n0 = (unit % (N / 16)) * 16;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
            const int n = n0 + 8 * t + 2 * tig;
            dst[(m0 + g) * N + n] = acc[v][t][0];
            dst[(m0 + g) * N + n + 1] = acc[v][t][1];
            dst[(m0 + g + 8) * N + n] = acc[v][t][2];
            dst[(m0 + g + 8) * N + n + 1] = acc[v][t][3];
        }
    }
    if constexpr (KS > 1) {
        __syncthreads();
        for (int e = tid; e < P * N; e += THREADS) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < KS; ++k) s += red_s[k * P * N + e];
            out[e] = s;
        }
    }
}

// 2. ssd_state_pass: one thread per (b, h, p, n) state entry, serial over the
// chunks.  Each chunk state is overwritten with the state entering that
// chunk; the serial body's update, state * exp(total) + upd, so the carried
// state rounds as it does there.  The loads of CB chunks are issued before
// their updates: one chunk at a time, each update waited for its own load.
__global__ void __launch_bounds__(THREADS)
ssd_state_pass(const ChunkParams p, int PN) {
    const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= (size_t)p.B * p.H * PN) return;
    const size_t bh = idx / PN, e = idx % PN;
    float s = 0.f;
    constexpr int CB = 8;       // chunks whose loads are in flight together
    for (int c0 = 0; c0 < p.nc; c0 += CB) {
        float upd[CB], tot[CB];
#pragma unroll
        for (int k = 0; k < CB; ++k) {
            if (c0 + k < p.nc) {
                upd[k] = p.states[(bh * p.nc + c0 + k) * PN + e];
                tot[k] = p.cum[(bh * p.nc + c0 + k) * 2 * p.Q + p.Q - 1];
            }
        }
#pragma unroll
        for (int k = 0; k < CB; ++k) {
            if (c0 + k < p.nc) {
                p.states[(bh * p.nc + c0 + k) * PN + e] = s;
                s = s * expf(tot[k]) + upd[k];
            }
        }
    }
    p.state[idx] = s;
}

namespace scan {               // ssd_chunk_scan's tiling
constexpr int TI = 64;          // rows of an i tile, and steps of a j tile
constexpr int SW = 4;           // warps
constexpr int ST = SW * 32;
constexpr float NEG_INF = -1e30f;
}  // namespace scan

// 3. ssd_chunk_scan: grid (nc, H, B), 4 warps walk the 64-step tiles of one
// chunk in order, 16 rows i a warp, in the mma.sync m16n8k16 layout of
// flash_attention.cu's mma_sync body (C_i plays Q, B_j K and x_j V).  The
// walk carries R, the state at the end of the previous tile (at step r):
// R = s_in for the first tile (r = -1, cum_r = 0), and for a row i of tile t
//   y_i = exp(cum_i - cum_r) C_i R^T                         (earlier steps)
//       + sum_{j in tile t, j <= i} w_ij x_j,                  (the tile itself)
//   w_ij = (C_i B_j^T) exp(cum_i - cum_j) dt_j, masked (j > i) before the exp;
// then R = exp(cum_e - cum_r) R + x_t^T (u B_t), u_j = exp(cum_e - cum_j) dt_j,
// at the tile's last step e.  This is the chunked form of the scan again, at
// 64 steps inside the chunk: the tiles before a row's own tile reach it
// through R, a (P, N) product, and not through their (64 x 64) weights:
// at P = 64, N = 16 and Q = 256 under a quarter of the products of the
// weight tiles it replaces.
// R is fp32 in shared memory beside its SPLIT bf16 terms, which feed C R^T.
// x and B tiles are double-buffered with cp.async: tile t + 1 loads while
// tile t is computed.  C_i is read into A fragments from global memory.
template <int P, int N> struct ScanLayout {
    static constexpr int LDN = N + 8;          // bf16 rows of B and the R terms
    static constexpr int LDP = P + 8;          // bf16 rows of x
    static constexpr int STAGES = 2;           // x and B tiles double-buffered
    static constexpr int MINB = P * N <= 1024 ? 4 : 1;
    static constexpr size_t bytes =
        (2 * MAXQ + P * N) * sizeof(float)                         // cum, dt, R
        + (size_t)(STAGES * scan::TI + SPLIT * P) * LDN * 2        // B tiles, R terms
        + (size_t)STAGES * scan::TI * LDP * 2;                     // x tiles
};

template <int P, int N>
__global__ void __launch_bounds__(scan::ST, ScanLayout<P, N>::MINB)
ssd_chunk_scan(const ChunkParams p) {
    using Lay = ScanLayout<P, N>;
    using scan::TI;
    using scan::ST;
    constexpr int LDN = Lay::LDN, LDP = Lay::LDP, STAGES = Lay::STAGES;
    constexpr int KN = N / 16;                 // k-steps of C B^T and C R^T
    constexpr int NP = P / 8;                  // n-tiles of y
    constexpr int NJ = TI / 8;                 // n-tiles of a score tile
    constexpr int U = (P / 16) * (N / 16);     // 16 x 16 units of R
    static_assert(P % 16 == 0 && N % 16 == 0, "mma tiles");
    extern __shared__ __align__(16) float sm[];
    float* cum_s = sm;
    float* dt_s = cum_s + MAXQ;
    float* r_s = dt_s + MAXQ;                                           // (P, N)
    __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(r_s + P * N); // STAGES
    __nv_bfloat16* rt_s = b_s + STAGES * TI * LDN;                      // SPLIT terms
    __nv_bfloat16* x_s = rt_s + SPLIT * P * LDN;                        // STAGES

    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int L = p.L, H = p.H, Q = p.Q, t0 = c * Q, nq = min(Q, L - t0);
    const int n_tiles = (nq + TI - 1) / TI;    // live tiles of this chunk
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tig = lane % 4;
    const size_t row0 = (size_t)b * L + t0;
    const size_t bhc = ((size_t)b * H + h) * p.nc + c;

    auto load_tile = [&](int t) {
        const int j0 = t * TI, stage = t % STAGES;
        static_assert(STAGES == 2, "one tile loads while the one before it runs");
        load_rows<N, TI, ST>(b_s + stage * TI * LDN, LDN, p.Bm + (row0 + j0) * N, N, nq - j0);
        load_rows<P, TI, ST>(x_s + stage * TI * LDP, LDP, p.x + ((row0 + j0) * H + h) * P,
                             (size_t)H * P, nq - j0);
        cp_async_commit();
    };
    load_tile(0);
    for (int k = tid; k < n_tiles * TI; k += ST) {
        cum_s[k] = k < Q ? p.cum[bhc * 2 * Q + k] : 0.f;
        dt_s[k] = k < Q ? p.cum[bhc * 2 * Q + Q + k] : 0.f;
    }
    // R = s_in, and its terms
    const float* sin_g = p.states + bhc * P * N;
    for (int e = 2 * tid; e < P * N; e += 2 * ST) {
        const float2 v = *reinterpret_cast<const float2*>(sin_g + e);
        *reinterpret_cast<float2*>(r_s + e) = v;
        uint32_t t[SPLIT][4];
        split_bf16(v.x, v.y, t, 0);
        const int off = (e / N) * LDN + e % N;
#pragma unroll
        for (int k = 0; k < SPLIT; ++k)
            *reinterpret_cast<uint32_t*>(rt_s + k * P * LDN + off) = t[k][0];
    }
    // ldmatrix lanes: x4 over 16 rows x 16 columns of a row-major tile
    const int lrow = (lane & 7) + ((lane >> 4) & 1) * 8, lcol = ((lane >> 3) & 1) * 8;

    for (int it = 0; it < n_tiles; ++it) {
        const int i0 = it * TI;
        const int ia = i0 + warp * 16 + g, ib = ia + 8;     // this thread's two rows
        // C_i as A fragments, as flash_attention.cu's mma_sync body holds Q;
        // rows past the chunk's live steps read as zeros
        uint32_t cf[KN][4];
        {
            const __nv_bfloat16* ca = p.Cm + (row0 + ia) * N + tig * 2;
            const __nv_bfloat16* cb = ca + 8 * N;
#pragma unroll
            for (int kk = 0; kk < KN; ++kk) {
                cf[kk][0] = ia < nq ? *reinterpret_cast<const uint32_t*>(ca + kk * 16) : 0u;
                cf[kk][1] = ib < nq ? *reinterpret_cast<const uint32_t*>(cb + kk * 16) : 0u;
                cf[kk][2] = ia < nq ? *reinterpret_cast<const uint32_t*>(ca + kk * 16 + 8) : 0u;
                cf[kk][3] = ib < nq ? *reinterpret_cast<const uint32_t*>(cb + kk * 16 + 8) : 0u;
            }
        }
        // tile it is in, and R's terms; every warp is past tile it - 1, so
        // its stage takes the next tile
        cp_async_wait_all();
        __syncthreads();
        if (it + 1 < n_tiles) load_tile(it + 1);
        const __nv_bfloat16* bs = b_s + (it % STAGES) * TI * LDN;
        const __nv_bfloat16* xs = x_s + (it % STAGES) * TI * LDP;

        // earlier steps: y = exp(cum_i - cum_r) C_i R^T, R as the sum of its terms
        float o[NP][4];
#pragma unroll
        for (int t = 0; t < NP; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
        for (int k = 0; k < SPLIT; ++k) {
#pragma unroll
            for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
                for (int tp = 0; tp < NP / 2; ++tp) {
                    uint32_t r[4];
                    ldmatrix_x4<false>(r, rt_s + (k * P + tp * 16 + lrow) * LDN + kk * 16 + lcol);
                    mma_bf16(o[2 * tp], cf[kk], r[0], r[1]);
                    mma_bf16(o[2 * tp + 1], cf[kk], r[2], r[3]);
                }
            }
        }
        const float cum_a = cum_s[ia], cum_b = cum_s[ib];
        const float cum_r = it > 0 ? cum_s[i0 - 1] : 0.f;
        {
            const float ea = expf(cum_a - cum_r), eb = expf(cum_b - cum_r);
#pragma unroll
            for (int t = 0; t < NP; ++t) {
                o[t][0] *= ea; o[t][1] *= ea; o[t][2] *= eb; o[t][3] *= eb;
            }
        }

        // the tile itself: a warp's rows see only its first warp + 1 blocks
        // of 16 steps; the rest is masked
        const int jb16 = warp + 1;
        float s[NJ][4];
#pragma unroll
        for (int t = 0; t < NJ; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
            for (int tp = 0; tp < NJ / 2; ++tp) {
                if (tp >= jb16) break;
                uint32_t r[4];
                ldmatrix_x4<false>(r, bs + (tp * 16 + lrow) * LDN + kk * 16 + lcol);
                mma_bf16(s[2 * tp], cf[kk], r[0], r[1]);
                mma_bf16(s[2 * tp + 1], cf[kk], r[2], r[3]);
            }
        }
        // w = s exp(cum_i - cum_j) dt_j, j > i masked before the exp
#pragma unroll
        for (int t = 0; t < NJ; ++t) {
            if (t >= 2 * jb16) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = i0 + t * 8 + tig * 2 + (e & 1);
                const int i = e < 2 ? ia : ib;
                float seg = (e < 2 ? cum_a : cum_b) - cum_s[j];
                if (j > i) seg = scan::NEG_INF;
                s[t][e] *= expf(seg) * dt_s[j];
            }
        }
        // y += sum over the terms of w_k x_j (A fragments packed as
        // flash_attention.cu's pv_chunk packs P)
#pragma unroll
        for (int kk = 0; kk < TI / 16; ++kk) {
            if (kk >= jb16) break;
            uint32_t a[SPLIT][4];
            split_bf16(s[2 * kk][0], s[2 * kk][1], a, 0);
            split_bf16(s[2 * kk][2], s[2 * kk][3], a, 1);
            split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], a, 2);
            split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], a, 3);
            const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
            for (int np = 0; np < NP / 2; ++np) {
                uint32_t r[4];
                ldmatrix_x4<true>(r, xs + row * LDP + np * 16 + (lane >> 4) * 8);
#pragma unroll
                for (int k = 0; k < SPLIT; ++k) {
                    mma_bf16(o[2 * np], a[k], r[0], r[1]);
                    mma_bf16(o[2 * np + 1], a[k], r[2], r[3]);
                }
            }
        }

        // y rounded to bf16 once; rows past the chunk's live steps are not written
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int i = half ? ib : ia;
            if (i >= nq) continue;
            __nv_bfloat16* yr = p.y + ((row0 + i) * H + h) * P + tig * 2;
#pragma unroll
            for (int t = 0; t < NP; ++t)
                *reinterpret_cast<uint32_t*>(yr + t * 8) =
                    pack_bf16(o[t][2 * half], o[t][2 * half + 1]);
        }
        if (it + 1 == n_tiles) break;

        // R to the tile's last step e: R = exp(cum_e - cum_r) R + x_it^T (u B_it)
        __syncthreads();                       // every warp is done reading R's terms
        const float cum_e = cum_s[i0 + TI - 1];
        const float f = expf(cum_e - cum_r);
        for (int unit = warp; unit < U; unit += scan::SW) {
            const int m0 = (unit / (N / 16)) * 16, n0 = (unit % (N / 16)) * 16;
            float acc[2][4] = {};
#pragma unroll
            for (int kb = 0; kb < TI / 16; ++kb) {
                const int la = kb * 16 + 2 * tig, lb = la + 8;      // rows of the tile
                const float ua0 = expf(cum_e - cum_s[i0 + la]) * dt_s[i0 + la];
                const float ua1 = expf(cum_e - cum_s[i0 + la + 1]) * dt_s[i0 + la + 1];
                const float ub0 = expf(cum_e - cum_s[i0 + lb]) * dt_s[i0 + lb];
                const float ub1 = expf(cum_e - cum_s[i0 + lb + 1]) * dt_s[i0 + lb + 1];
                uint32_t af[4];
                ldmatrix_x4<true>(af, xs + (kb * 16 + lrow) * LDP + m0 + lcol);
#pragma unroll
                for (int t = 0; t < 2; ++t) {
                    const int n = n0 + 8 * t + g;
                    uint32_t bf[SPLIT][4];
                    split_bf16(ua0 * __bfloat162float(bs[la * LDN + n]),
                               ua1 * __bfloat162float(bs[(la + 1) * LDN + n]), bf, 0);
                    split_bf16(ub0 * __bfloat162float(bs[lb * LDN + n]),
                               ub1 * __bfloat162float(bs[(lb + 1) * LDN + n]), bf, 1);
#pragma unroll
                    for (int k = 0; k < SPLIT; ++k) mma_bf16(acc[t], af, bf[k][0], bf[k][1]);
                }
            }
            // acc[t]: rows p = m0 + g (+ 8), columns n = n0 + 8 t + 2 tig (+ 1)
#pragma unroll
            for (int t = 0; t < 2; ++t) {
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int pp = m0 + g + 8 * hr, n = n0 + 8 * t + 2 * tig;
                    float2 r = *reinterpret_cast<const float2*>(r_s + pp * N + n);
                    r.x = f * r.x + acc[t][2 * hr];
                    r.y = f * r.y + acc[t][2 * hr + 1];
                    *reinterpret_cast<float2*>(r_s + pp * N + n) = r;
                    uint32_t tm[SPLIT][4];
                    split_bf16(r.x, r.y, tm, 0);
#pragma unroll
                    for (int k = 0; k < SPLIT; ++k)
                        *reinterpret_cast<uint32_t*>(rt_s + (k * P + pp) * LDN + n) = tm[k][0];
                }
            }
        }
    }
}

template <int P, int N>
cudaError_t launch_chunked(const ChunkParams& p, cudaStream_t stream) {
    const size_t smem1 = StateLayout<P, N>::bytes, smem3 = ScanLayout<P, N>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_state<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        ssd_chunk_scan<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
    if (err != cudaSuccess) return err;
    ssd_chunk_state<P, N><<<dim3(p.nc, p.H, p.B), THREADS, smem1, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const size_t entries = (size_t)p.B * p.H * P * N;
    ssd_state_pass<<<(unsigned)((entries + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        p, P * N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_chunk_scan<P, N><<<dim3(p.nc, p.H, p.B), scan::ST, smem3, stream>>>(p);
    return cudaGetLastError();
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

extern "C" int avo_ssd_chunk_parallel(
        const void* x, const void* dt, const void* A, const void* Bm,
        const void* Cm, void* y, void* state, void* cum, void* states,
        int B, int L, int H, int P, int N, int Q, void* stream) {
    if (B < 1 || L < 1 || H < 1 || Q < 1 || Q > MAXQ)
        return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    ChunkParams p{static_cast<const bf16*>(x), static_cast<const float*>(dt),
                  static_cast<const float*>(A), static_cast<const bf16*>(Bm),
                  static_cast<const bf16*>(Cm), static_cast<bf16*>(y),
                  static_cast<float*>(state), static_cast<float*>(cum),
                  static_cast<float*>(states), B, L, H, Q, (L + Q - 1) / Q};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (P == 64 && N == 16) return (int)launch_chunked<64, 16>(p, s);
    if (P == 64 && N == 128) return (int)launch_chunked<64, 128>(p, s);
    if (P == 16 && N == 16) return (int)launch_chunked<16, 16>(p, s);
    return (int)cudaErrorInvalidValue;
}
