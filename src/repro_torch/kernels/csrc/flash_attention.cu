// Genome-parameterized flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention
// (bodies _fa_body_grid and _fa_body_loop).  It computes the same function:
// softmax(Q K^T * scale [softcap] [mask]) V with an online softmax and f32
// statistics, causal / sliding-window / key-padding masks, GQA by h / rep, and
// the genome axes of core/search_space.py.  The Python wrapper
// (kernels/flash_attention.py) does the gqa_pack reshape, passes seq_mod and
// picks the body: by dtype and head_dim alone, never by genome.
//
// Three bodies.
//   wgmma     bf16 at head_dim 64 or 128 (the measured rung at every mha_suite
//             shape, and the served prefill).  Warp-specialised: a CTA of
//             three warpgroups owns 128 query rows.  Warpgroup 0 is the
//             producer: it drops to 40 registers (setmaxnreg) and one of its
//             threads issues every TMA load (Q once, then K and V chunks of
//             128 keys, each on its own mbarrier so Q K^T starts while V is in
//             flight).  Warpgroups 1 and 2 are consumers of 64 rows each, at
//             232 registers: S = Q K^T is wgmma m64n128k16 with both operands
//             read from the 128B-swizzled TMA tiles through descriptors;
//             O += P V is wgmma with P in registers (the S accumulator turned
//             to bf16) and V read through the descriptor's transpose flag.
//             fp32 accumulators.  Q/K/V are 3-D tensor maps (D, S, B * H), so
//             a box never crosses a head and TMA zero-fills rows past S.
//             Shared memory: Q 32 KB, each K/V stage 64 KB at D = 128, so one
//             CTA runs per SM.  Row blocks run heaviest first (causal).
//   mma_sync  bf16 at other head dims: one CTA of 4 warps owns 64 query rows
//             (m16n8k16 accumulator layout, a thread holds rows g and g + 8,
//             g = lane / 4); K/V stream through shared memory in chunks of 64
//             keys with cp.async.  The wrapper's private body= keyword forces
//             it on any bf16 launch, for the A/B timing in chip_smoke.py.
//   fp32      the correctness gate: the mma_sync walk with both products as
//             IEEE fp32 FFMA on the CUDA cores, never TF32 (the gate's
//             tolerance of 2e-5 fails in TF32).
// Every body uses the same walk and the same per-chunk softmax step.
//
// Genome axes.  block_q / block_k are LOGICAL blocks (they reach 2048, far
// beyond shared memory); every body uses them for
//   * _block_classify and the block_skip loop bounds (Walk below: producer
//     and consumers step through the same sequence), so a genome skips
//     exactly the logical blocks the reference skips;
//   * the points where the bf16 accumulator (acc_dtype="bf16") is rounded:
//     once at the end of every visited logical K block.
// A logical K block is walked in physical chunks; keys of a chunk that lie
// outside its logical block take no part at all (p = 0).  Every block_k of
// the search space is a multiple of 128, so there a wgmma chunk never
// straddles two logical blocks.
//   kv_in_grid=True  -> reference _fa_body_grid semantics.  wgmma: a 2-stage
//                       K/V ring, the producer runs ahead of the consumers;
//                       mma_sync / fp32: cp.async double buffering.
//   kv_in_grid=False -> reference _fa_body_loop semantics (always mask, always
//                       rescale without a branch, always divide at the end,
//                       loop bounds narrowed only when seq_mod is unset); a
//                       single stage, loaded only after the consumers release
//                       it: no load/compute overlap.
//   rescale_mode     -> "branched" skips the accumulator rescale when no row
//                       needs it: a vote per warp (wgmma) or per CTA
//                       (__syncthreads_or; mma_sync, fp32).  Skipping a
//                       factor of exactly 1 changes nothing, so any
//                       granularity is exact.
//   mask_mode        -> "block_skip" skips fully masked logical blocks and the
//                       mask arithmetic on fully unmasked ones.
//   div_mode         -> "eager" keeps the accumulator normalized after every
//                       chunk (P is scaled by 1 / l before P V).
//   acc_dtype        -> bf16 rounds the accumulator at logical block ends.
//                       The reference's branched path also rounds the
//                       rescaled value before adding P V; the kernel rounds
//                       once.  Both errors sit far above the gate tolerance.
// P is rounded to bf16 for the P V product, as FlashAttention does.
//
// Bound.  At every mha_suite shape the work is compute-bound on the H100:
// useful FLOPs / 989e12 exceeds (q + k + v + o bytes) / 3.35e12 by two
// orders of magnitude.  The mma_sync body reaches 15-18 % of the bf16 peak
// for the pipelined genome: synchronous m16n8k16 products, per-score
// arithmetic in series with them on the same warps, and addresses computed
// by every thread for its cp.async loads.  The wgmma body issues the
// products asynchronously on the full-rate path, lets one consumer
// warpgroup's softmax run while the other's products do, and moves every
// byte by TMA: 421-552 TFLOP/s (43-56 % of the peak), 2.9-3.4x the mma_sync
// body and 1.18-1.40x cuDNN's time over two runs, at 168 registers with no
// spill (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md).  Inside a
// consumer the softmax still waits for its own Q K^T and P V waits for the
// softmax.  Left for later: ping-pong scheduling of the two consumers,
// overlap of the softmax with the next Q K^T inside a warpgroup, persistent
// CTAs with causal load balance, fp8.
//
// Build.  cuTensorMapEncodeTiled is a driver-API function; it is looked up
// in the driver library already loaded into the process (dlsym of
// libcuda.so.1), so the library links no -lcuda.
//
// C interface: avo_flash_attention(...) launches on the given stream and
// returns a CUDA error code as an int (0: launched).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // mma_sync / fp32: query rows per CTA
constexpr int BK = 64;          // mma_sync / fp32: keys per chunk
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAXD = 128;       // head_dim <= 128, multiple of 16
constexpr int NT = BK / 8;      // n-tiles of a score chunk
constexpr int ND = MAXD / 8;    // n-tiles of the accumulator
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
// scores are kept in the log2 domain (exp(x - m) == exp2(x log2e - m log2e));
// the reference's -1e30 mask value maps to NEG_INF * LOG2E there
constexpr float NEG_INF2 = NEG_INF * LOG2E;
static_assert(BQ == BK, "load_rows stages BK rows for the Q tile too");

struct Params {
    const void* q; const void* k; const void* v; void* o;
    int B, Hq, rep, Sq, Sk, D;
    int seq_mod;                // 0: none
    int bq, bk, nk;             // logical blocks and the logical K block count
    int causal, window;         // window < 0: none
    float softcap, scale;
    int branched, block_skip, eager;
};

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int v = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };

__device__ __forceinline__ int floor_div(int a, int b) {
    int q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// reference _block_classify: (fully_masked, fully_unmasked) of logical (i, j)
__device__ __forceinline__ void classify(const Params& p, int i, int j,
                                         bool& fm, bool& fu) {
    int q_lo = i * p.bq, q_hi = i * p.bq + p.bq - 1;
    if (p.seq_mod) {
        bool wraps = (q_hi / p.seq_mod) != (q_lo / p.seq_mod);
        int lo_m = wraps ? 0 : q_lo % p.seq_mod;
        int hi_m = wraps ? p.seq_mod - 1 : q_hi % p.seq_mod;
        q_lo = lo_m; q_hi = hi_m;
    }
    int k_lo = j * p.bk, k_hi = j * p.bk + p.bk - 1;
    fm = false;
    fu = k_hi < p.Sk;
    if (p.causal) { fm |= k_lo > q_hi; fu &= k_hi <= q_lo; }
    if (p.window >= 0) { fm |= k_hi <= q_lo - p.window; fu &= k_lo > q_hi - p.window; }
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

// rows [row0, row0 + rows) of a (S, D) matrix into smem with stride ld;
// rows outside [0, limit) or at/after `valid` are zero-filled
template <typename T>
__device__ __forceinline__ void load_rows(T* smem, int ld, const T* g, int row0,
                                          int valid, int limit, int D) {
    const int per_row = D * (int)sizeof(T) / 16;      // 16-byte pieces a row
    // one division per call: a thread keeps its column and strides over rows
    // (per_row divides THREADS for every head_dim a power of two)
    const int step = THREADS % per_row == 0 ? THREADS / per_row : 0;
    if (step) {
        const int col = (threadIdx.x % per_row) * (16 / (int)sizeof(T));
        for (int r = threadIdx.x / per_row; r < BK; r += step) {
            int row = row0 + r;
            bool ok = r < valid && row < limit;
            const T* src = ok ? g + (size_t)row * D + col : g;
            cp_async16(smem + r * ld + col, src, ok);
        }
        return;
    }
    for (int c = threadIdx.x; c < BK * per_row; c += THREADS) {
        int r = c / per_row, col = (c % per_row) * (16 / (int)sizeof(T));
        int row = row0 + r;
        bool ok = r < valid && row < limit;
        const T* src = ok ? g + (size_t)row * D + col : g;
        cp_async16(smem + r * ld + col, src, ok);
    }
}

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

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
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

// S (16 x 64 per warp) = Q K^T for one chunk, in the mma accumulator layout
template <typename T>
__device__ __forceinline__ void qk_chunk(float (&s)[NT][4], const T* Qs, const T* Ks,
                                         const uint32_t (&qf)[MAXD / 16][4],
                                         int D, int warp, int g, int tig);

template <>
__device__ __forceinline__ void qk_chunk<float>(float (&s)[NT][4], const float* Qs,
                                                const float* Ks,
                                                const uint32_t (&)[MAXD / 16][4],
                                                int D, int warp, int g, int tig) {
    const int ldd = D + Pad<float>::v;
    const float* qa = Qs + (warp * 16 + g) * ldd;
    const float* qb = qa + 8 * ldd;
    for (int d = 0; d < D; ++d) {
        float a = qa[d], b = qb[d];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            float k0 = Ks[(t * 8 + tig * 2) * ldd + d];
            float k1 = Ks[(t * 8 + tig * 2 + 1) * ldd + d];
            s[t][0] = fmaf(a, k0, s[t][0]);
            s[t][1] = fmaf(a, k1, s[t][1]);
            s[t][2] = fmaf(b, k0, s[t][2]);
            s[t][3] = fmaf(b, k1, s[t][3]);
        }
    }
}

template <>
__device__ __forceinline__ void qk_chunk<__nv_bfloat16>(
        float (&s)[NT][4], const __nv_bfloat16*, const __nv_bfloat16* Ks,
        const uint32_t (&qf)[MAXD / 16][4], int D, int, int, int) {
    const int ldd = D + Pad<__nv_bfloat16>::v;
    const int lane = threadIdx.x % 32;
    // x4: keys [16 tp, 16 tp + 16) x d [16 kk, 16 kk + 16) -> b0, b1 of
    // n-tiles 2 tp and 2 tp + 1
    const int row = (lane & 7) + ((lane >> 4) & 1) * 8;
    const int col = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < MAXD / 16; ++kk) {
        if (kk * 16 >= D) break;
#pragma unroll
        for (int tp = 0; tp < NT / 2; ++tp) {
            uint32_t r[4];
            ldmatrix_x4<false>(r, Ks + (tp * 16 + row) * ldd + kk * 16 + col);
            mma_bf16(s[2 * tp], qf[kk], r[0], r[1]);
            mma_bf16(s[2 * tp + 1], qf[kk], r[2], r[3]);
        }
    }
}

// O (16 x D per warp) += P V for one chunk; P is in the accumulator layout
template <typename T>
__device__ __forceinline__ void pv_chunk(float (&o)[ND][4], const float (&pr)[NT][4],
                                         const T* Vs, float* Ps, int D, int g, int tig,
                                         int lane);

template <>
__device__ __forceinline__ void pv_chunk<float>(float (&o)[ND][4], const float (&pr)[NT][4],
                                                const float* Vs, float* Ps, int D,
                                                int g, int tig, int) {
    constexpr int ldp = BK + 4;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        int c = t * 8 + tig * 2;
        Ps[g * ldp + c] = pr[t][0];
        Ps[g * ldp + c + 1] = pr[t][1];
        Ps[(g + 8) * ldp + c] = pr[t][2];
        Ps[(g + 8) * ldp + c + 1] = pr[t][3];
    }
    __syncwarp();
    const int ldd = D + Pad<float>::v;
    for (int key = 0; key < BK; ++key) {
        float pa = Ps[g * ldp + key], pb = Ps[(g + 8) * ldp + key];
        const float* vrow = Vs + key * ldd + tig * 2;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            if (n * 8 >= D) break;
            float v0 = vrow[n * 8], v1 = vrow[n * 8 + 1];
            o[n][0] = fmaf(pa, v0, o[n][0]);
            o[n][1] = fmaf(pa, v1, o[n][1]);
            o[n][2] = fmaf(pb, v0, o[n][2]);
            o[n][3] = fmaf(pb, v1, o[n][3]);
        }
    }
    __syncwarp();
}

template <>
__device__ __forceinline__ void pv_chunk<__nv_bfloat16>(
        float (&o)[ND][4], const float (&pr)[NT][4], const __nv_bfloat16* Vs, float*,
        int D, int, int, int lane) {
    const int ldd = D + Pad<__nv_bfloat16>::v;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(pr[2 * kk][0], pr[2 * kk][1]);
        a[1] = pack_bf16(pr[2 * kk][2], pr[2 * kk][3]);
        a[2] = pack_bf16(pr[2 * kk + 1][0], pr[2 * kk + 1][1]);
        a[3] = pack_bf16(pr[2 * kk + 1][2], pr[2 * kk + 1][3]);
        const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
            if (np * 16 >= D) break;
            uint32_t r[4];
            ldmatrix_x4<true>(r, Vs + row * ldd + np * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * np], a, r[0], r[1]);
            mma_bf16(o[2 * np + 1], a, r[2], r[3]);
        }
    }
}

// The walk over visited chunks: logical K block j, chunk start k0 inside it.
struct Cursor {
    int j, k0, kend;            // kend: end of logical block j
    bool mask;                  // apply the mask on this block
    bool valid;
};

// ROWS: the CTA's query rows; CHUNK: keys per physical chunk
template <bool GRID, int ROWS, int CHUNK>
struct Walk {
    const Params& p;
    int i_first, i_last;        // logical q blocks this CTA's rows touch
    int j_lo, j_hi;

    __device__ Walk(const Params& p_, int r0) : p(p_) {
        int r_last = min(r0 + ROWS, p.Sq) - 1;
        i_first = r0 / p.bq;
        i_last = r_last / p.bq;
        j_lo = 0; j_hi = p.nk;
        if (!GRID && p.block_skip && (p.causal || p.window >= 0) && !p.seq_mod) {
            // reference _fa_body_loop bounds; lo and hi grow with i
            if (p.causal)
                j_hi = min(p.nk, (i_last * p.bq + p.bq + p.bk - 1) / p.bk);
            if (p.window >= 0)
                j_lo = max(0, floor_div(i_first * p.bq - p.window + 1, p.bk));
        }
    }

    // first visited logical block at or after j; fills mask
    __device__ int visit_from(int j, bool& mask) const {
        for (; j < j_hi; ++j) {
            if (!GRID) { mask = true; return j; }
            if (!p.block_skip) { mask = true; return j; }
            bool run = false, unmasked = true;
            for (int i = i_first; i <= i_last; ++i) {
                bool fm, fu;
                classify(p, i, j, fm, fu);
                run |= !fm;
                unmasked &= fu;
            }
            if (run) { mask = !unmasked; return j; }
        }
        return j_hi;
    }

    __device__ Cursor start(int j) const {
        Cursor c;
        j = visit_from(max(j, j_lo), c.mask);
        c.valid = j < j_hi;
        c.j = j;
        c.k0 = j * p.bk;
        c.kend = (j + 1) * p.bk;
        return c;
    }

    __device__ Cursor next(const Cursor& c) const {
        if (c.k0 + CHUNK < c.kend) {
            Cursor n = c;
            n.k0 = c.k0 + CHUNK;
            return n;
        }
        return start(c.j + 1);
    }
};

// One chunk's scores s (C n-tiles of 8 keys in the m16n8 accumulator layout:
// rows g and g + 8 of a warp's 16, keys 8 t + 2 tig + {0, 1}) through scale,
// softcap, mask and the online-softmax update of (m, l).  Leaves p in s
// (scaled by 1 / l under eager) and the accumulator's factor in fac;
// returns whether a row of this thread needs the rescale.
template <int C>
__device__ __forceinline__ bool softmax_chunk(
        float (&s)[C][4], float (&m)[2], float (&l)[2], float (&fac)[2],
        const Params& p, const Cursor& cur, const int (&qpos)[2], int tig,
        bool eager) {
    const int nkeys = min(C * 8, cur.kend - cur.k0);
    const float scale2 = p.softcap != 0.f ? p.scale : p.scale * LOG2E;
    if (p.softcap != 0.f) {
#pragma unroll
        for (int t = 0; t < C; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                s[t][e] = p.softcap * tanhf(s[t][e] * scale2 / p.softcap) * LOG2E;
    } else {
#pragma unroll
        for (int t = 0; t < C; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[t][e] *= scale2;
    }
    if (nkeys < C * 8 || cur.mask) {               // a uniform branch per chunk
#pragma unroll
        for (int t = 0; t < C; ++t) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int c = t * 8 + tig * 2 + (e & 1);
                if (c >= nkeys) {
                    s[t][e] = -INFINITY;        // outside this logical block
                } else if (cur.mask) {
                    int key = cur.k0 + c, qp = qpos[e >> 1];
                    bool ok = key < p.Sk;
                    if (p.causal) ok &= key <= qp;
                    if (p.window >= 0) ok &= key > qp - p.window;
                    if (!ok) s[t][e] = NEG_INF2;
                }
            }
        }
    }
    float mx[2] = {NEG_INF2, NEG_INF2};
#pragma unroll
    for (int t = 0; t < C; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
    float alpha[2], inv[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(m[r], mx[r]);             // m_new
        alpha[r] = exp2f(m[r] - mx[r]);
    }
#pragma unroll
    for (int t = 0; t < C; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float pe = exp2f(s[t][e] - mx[e >> 1]);
            s[t][e] = pe;
            sum[e >> 1] += pe;
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        float l_new = l[r] * alpha[r] + sum[r];
        if (eager) {
            float l_safe = fmaxf(l_new, 1e-30f);
            fac[r] = l[r] * alpha[r] / l_safe;
            inv[r] = 1.f / l_safe;
        } else {
            fac[r] = alpha[r];
            inv[r] = 1.f;
        }
        l[r] = l_new;
        m[r] = mx[r];
    }
    if (eager) {
#pragma unroll
        for (int t = 0; t < C; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[t][e] *= inv[e >> 1];
    }
    return eager ? (fac[0] != 1.f || fac[1] != 1.f) : (fac[0] < 1.f || fac[1] < 1.f);
}

template <int N>
__device__ __forceinline__ void scale_rows(float (&o)[N][4], const float (&fac)[2]) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
        o[n][0] *= fac[0]; o[n][1] *= fac[0];
        o[n][2] *= fac[1]; o[n][3] *= fac[1];
    }
}

template <int N>
__device__ __forceinline__ void round_rows(float (&o)[N][4]) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = round_bf16(o[n][e]);
}

// rows `row` and `row + 8` of O (a thread's two rows), divided by dv
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* og, const float (&o)[N][4], int row,
                                           int Sq, int D, int tig, const float (&dv)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int rr = row + 8 * r;
        if (rr >= Sq) continue;
        T* orow = og + (size_t)rr * D + tig * 2;
#pragma unroll
        for (int n = 0; n < N; ++n) {
            if (n * 8 >= D) break;
            float a0 = o[n][2 * r] / dv[r], a1 = o[n][2 * r + 1] / dv[r];
            if constexpr (sizeof(T) == 2) {
                *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
                    __floats2bfloat162_rn(a0, a1);
            } else {
                *reinterpret_cast<float2*>(orow + n * 8) = make_float2(a0, a1);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// mma_sync and fp32 bodies: 64 rows x 64 keys, cp.async staging.
// At most 170 registers a thread, so three CTAs (12 warps) fit on an SM.
template <typename T, bool ACC_BF16, bool GRID>
__global__ void __launch_bounds__(THREADS, 3)
fa_fwd(Params p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int D = p.D;
    const int ldd = D + Pad<T>::v;
    // K/V stage s: K at 2*s, V at 2*s+1.  bf16 keeps Q in registers after the
    // prologue, so the pipelined path stages the Q tile in stage 1's buffers
    constexpr bool Q_IN_STAGE1 = GRID && sizeof(T) == 2;
    T* base = reinterpret_cast<T*>(smem_raw);
    T* KV = Q_IN_STAGE1 ? base : base + BQ * ldd;
    T* Qs = Q_IN_STAGE1 ? base + 2 * BK * ldd : base;
    float* Ps = reinterpret_cast<float*>(KV + (GRID ? 4 : 2) * BK * ldd);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tig = lane % 4;
    const int r0 = blockIdx.x * BQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const int Hkv = p.Hq / p.rep;

    const T* qg = static_cast<const T*>(p.q) + ((size_t)(b * p.Hq + h) * p.Sq) * D;
    const T* kg = static_cast<const T*>(p.k) + ((size_t)(b * Hkv + h / p.rep) * p.Sk) * D;
    const T* vg = static_cast<const T*>(p.v) + ((size_t)(b * Hkv + h / p.rep) * p.Sk) * D;
    T* og = static_cast<T*>(p.o) + ((size_t)(b * p.Hq + h) * p.Sq) * D;

    Walk<GRID, BQ, BK> walk(p, r0);
    Cursor cur = walk.start(0);

    load_rows<T>(Qs, ldd, qg, r0, BQ, p.Sq, D);
    cp_async_commit();
    auto load_chunk = [&](const Cursor& c, int stage) {
        int n = min(BK, c.kend - c.k0);
        load_rows<T>(KV + (2 * stage) * BK * ldd, ldd, kg, c.k0, n, p.Sk, D);
        load_rows<T>(KV + (2 * stage + 1) * BK * ldd, ldd, vg, c.k0, n, p.Sk, D);
        cp_async_commit();
    };
    if (cur.valid) load_chunk(cur, 0);
    cp_async_wait<0>();
    __syncthreads();

    uint32_t qf[MAXD / 16][4];
    if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int kk = 0; kk < MAXD / 16; ++kk) {
            if (kk * 16 >= D) break;
            const T* qa = Qs + (warp * 16 + g) * ldd + kk * 16 + tig * 2;
            qf[kk][0] = *reinterpret_cast<const uint32_t*>(qa);
            qf[kk][1] = *reinterpret_cast<const uint32_t*>(qa + 8 * ldd);
            qf[kk][2] = *reinterpret_cast<const uint32_t*>(qa + 8);
            qf[kk][3] = *reinterpret_cast<const uint32_t*>(qa + 8 * ldd + 8);
        }
        if constexpr (Q_IN_STAGE1) __syncthreads();     // stage 1 is loaded next
    }

    float o[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {NEG_INF2, NEG_INF2}, l[2] = {0.f, 0.f};
    int qpos[2];
    for (int r = 0; r < 2; ++r) {
        int row = r0 + warp * 16 + g + 8 * r;
        qpos[r] = p.seq_mod ? row % p.seq_mod : row;
    }
    const bool eager = GRID && p.eager;
    const bool branched = GRID && p.branched;

    int stage = 0;
    while (cur.valid) {
        Cursor nxt = walk.next(cur);
        if constexpr (GRID) {
            if (nxt.valid) { load_chunk(nxt, stage ^ 1); cp_async_wait<1>(); }
            else cp_async_wait<0>();
            __syncthreads();
        }
        const T* Ks = KV + (2 * stage) * BK * ldd;
        const T* Vs = KV + (2 * stage + 1) * BK * ldd;

        float s[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
        qk_chunk<T>(s, Qs, Ks, qf, D, warp, g, tig);

        float fac[2];
        const bool need = softmax_chunk<NT>(s, m, l, fac, p, cur, qpos, tig, eager);
        if (!branched || __syncthreads_or(need)) scale_rows<ND>(o, fac);
        pv_chunk<T>(o, s, Vs, Ps + warp * 16 * (BK + 4), D, g, tig, lane);
        if (ACC_BF16 && cur.k0 + BK >= cur.kend) round_rows<ND>(o);   // block ends

        if constexpr (GRID) {
            __syncthreads();                          // stage is reloaded next
            stage ^= 1;
        } else {
            __syncthreads();
            if (nxt.valid) {
                load_chunk(nxt, 0);
                cp_async_wait<0>();
                __syncthreads();
            }
        }
        cur = nxt;
    }

    float dv[2] = {1.f, 1.f};
    if (!eager) { dv[0] = fmaxf(l[0], 1e-30f); dv[1] = fmaxf(l[1], 1e-30f); }
    store_rows<T, ND>(og, o, r0 + warp * 16 + g, p.Sq, D, tig, dv);
}

template <typename T, bool ACC_BF16, bool GRID>
cudaError_t launch(const Params& p, cudaStream_t stream) {
    const int ldd = p.D + Pad<T>::v;
    const int rows = (GRID && sizeof(T) == 2) ? 4 * BK : BQ + (GRID ? 4 : 2) * BK;
    size_t smem = (size_t)rows * ldd * sizeof(T);
    if (sizeof(T) == 4) smem += (size_t)WARPS * 16 * (BK + 4) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fa_fwd<T, ACC_BF16, GRID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
    fa_fwd<T, ACC_BF16, GRID><<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int acc_bf16, int kv_in_grid, cudaStream_t s) {
    if (acc_bf16)
        return kv_in_grid ? launch<T, true, true>(p, s) : launch<T, true, false>(p, s);
    return kv_in_grid ? launch<T, false, true>(p, s) : launch<T, false, false>(p, s);
}

// ---------------------------------------------------------------------------
// The wgmma body: bf16, head_dim 64 or 128; warp-specialised, TMA + wgmma.
constexpr int W_BQ = 128;           // query rows per CTA: 64 per consumer
constexpr int W_BK = 128;           // keys per chunk
constexpr int W_THREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr int W_NT = W_BK / 8;      // n-tiles of a score chunk
constexpr int BOX_COLS = 64;        // one TMA box: 64 bf16 (128 bytes, the
constexpr int BOX_ROWS = 128;       // swizzle span) x 128 rows = 16 KB
constexpr uint32_t BOX_BYTES = BOX_COLS * BOX_ROWS * 2;
constexpr uint32_t ROW_BYTES = BOX_COLS * 2;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 64 K

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// returns once the phase of the given parity has completed; a wait that
// never completes (a fault in the pipeline) traps after ~10 s, so the launch
// fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    long long start = 0;
    for (bool first = true;; first = false) {
        uint32_t done;
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (first) start = clock64();
        else if (clock64() - start > (20ll << 30)) __trap();
    }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%3, %4, %5}], [%2];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
                    "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// a wgmma shared-memory descriptor for a 128B-swizzled tile
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e]) :: "memory");
}

#define ACC2(d, j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3]), \
                   "+f"(d[j + 1][0]), "+f"(d[j + 1][1]), "+f"(d[j + 1][2]), "+f"(d[j + 1][3])
#define ACC32(d) ACC2(d, 0), ACC2(d, 2), ACC2(d, 4), ACC2(d, 6)
#define ACC64(d) ACC32(d), ACC2(d, 8), ACC2(d, 10), ACC2(d, 12), ACC2(d, 14)
#define REGS32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define REGS64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// S (64 x 128) (+)= A B^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da, uint64_t db,
                                              int accumulate) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : ACC64(d) : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x N) += A B, A in registers, B N-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 REGS64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
                 : ACC64(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : ACC32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Shared memory, from a 1024-byte aligned base: Q (NB boxes), then per
// stage K (NB boxes) and V (NB boxes), then the mbarriers, then the
// producer's notes: whether the walk visits any chunk, and per stage the
// chunk it holds.
template <int D, int STAGES>
struct WLayout {
    static constexpr int NB = D / BOX_COLS;                 // boxes across head_dim
    __host__ __device__ static constexpr uint32_t k(int s) {
        return (uint32_t)NB * (1 + 2 * s) * BOX_BYTES;
    }
    __host__ __device__ static constexpr uint32_t v(int s) {
        return (uint32_t)NB * (2 + 2 * s) * BOX_BYTES;
    }
    static constexpr uint32_t bars = (uint32_t)NB * (1 + 2 * STAGES) * BOX_BYTES;
    static constexpr uint32_t notes = bars + 64;            // 7 barriers at most
    static constexpr size_t smem = 1024 + notes + 16 * (1 + STAGES);
};

// A chunk as the producer hands it to the consumers (one per stage)
struct ChunkNote {
    int k0, kend;               // the chunk's first key; its logical block's end
    int mask, last;             // apply the mask; no chunk follows
};

// EAGER: div_mode="eager" (kv_in_grid only), a template parameter so the
// deferred path carries none of its arithmetic
template <int D, bool ACC_BF16, bool GRID, bool EAGER>
__global__ void __launch_bounds__(W_THREADS, 1)
fa_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const Params p) {
    static_assert(GRID || !EAGER, "the loop body always divides at the end");
    constexpr int STAGES = GRID ? 2 : 1;
    constexpr int NB = D / BOX_COLS, NO = D / 8;
    using Lay = WLayout<D, STAGES>;
    extern __shared__ __align__(16) unsigned char smem_w[];
    const uint32_t base = (smem_u32(smem_w) + 1023u) & ~1023u;
    const uint32_t q_full = base + Lay::bars;
    // the producer's notes, written before the arrival that publishes them
    int* any_chunk = reinterpret_cast<int*>(smem_w + (base - smem_u32(smem_w)) + Lay::notes);
    ChunkNote* notes = reinterpret_cast<ChunkNote*>(any_chunk + 4);
    // per stage: K landed, V landed, stage released by the consumers
    auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
    auto v_full = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
    auto empty = [&](int s) { return q_full + 8 * (1 + 2 * STAGES + s); };

    const int r0 = (gridDim.x - 1 - blockIdx.x) * W_BQ;    // heaviest rows first
    const int h = blockIdx.y, b = blockIdx.z;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(k_full(s), 1);
            mbar_init(v_full(s), 1);
            mbar_init(empty(s), 8);         // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {
        // ---- producer warpgroup: one thread issues every load ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
        if (threadIdx.x == 0) {
            // the walk runs here alone; the consumers read its chunks from
            // the notes
            const int qh = b * p.Hq + h, kh = b * (p.Hq / p.rep) + h / p.rep;
            Walk<GRID, W_BQ, W_BK> walk(p, r0);
            Cursor c = walk.start(0);
            *any_chunk = c.valid;
            mbar_expect_tx(q_full, NB * BOX_BYTES);
            for (int i = 0; i < NB; ++i)
                tma_load(base + i * BOX_BYTES, &tm_q, q_full, i * BOX_COLS, r0, qh);
            for (int n = 0; c.valid; ++n) {
                const int s = n % STAGES, round = n / STAGES;
                const Cursor nxt = walk.next(c);
                mbar_wait(empty(s), (round & 1) ^ 1);     // round 0 passes at once
                notes[s] = ChunkNote{c.k0, c.kend, c.mask, !nxt.valid};
                mbar_expect_tx(k_full(s), NB * BOX_BYTES);
                for (int i = 0; i < NB; ++i)
                    tma_load(base + Lay::k(s) + i * BOX_BYTES, &tm_k, k_full(s),
                             i * BOX_COLS, c.k0, kh);
                mbar_expect_tx(v_full(s), NB * BOX_BYTES);
                for (int i = 0; i < NB; ++i)
                    tma_load(base + Lay::v(s) + i * BOX_BYTES, &tm_v, v_full(s),
                             i * BOX_COLS, c.k0, kh);
                c = nxt;
            }
        }
    } else {
        // ---- consumer warpgroups: 64 query rows each ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
        const int cw = threadIdx.x / 128 - 1;
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int g = lane / 4, tig = lane % 4;
        const int row0 = r0 + cw * 64 + warp * 16 + g;       // and row0 + 8
        const uint32_t q_tile = base + cw * 64 * ROW_BYTES;   // rows [64 cw, 64 cw + 64)

        float o[NO][4];
#pragma unroll
        for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
        float m[2] = {NEG_INF2, NEG_INF2}, l[2] = {0.f, 0.f};
        int qpos[2];
        for (int r = 0; r < 2; ++r)
            qpos[r] = p.seq_mod ? (row0 + 8 * r) % p.seq_mod : row0 + 8 * r;
        const bool branched = GRID && p.branched;

        mbar_wait(q_full, 0);
        bool more = *any_chunk;
        for (int n = 0; more; ++n) {
            const int s = n % STAGES;
            const uint32_t parity = (n / STAGES) & 1;
            const uint32_t k_tile = base + Lay::k(s), v_tile = base + Lay::v(s);

            float sc[W_NT][4];
            mbar_wait(k_full(s), parity);
            const ChunkNote note = notes[s];
            const Cursor cur{0, note.k0, note.kend, note.mask != 0, true};
            more = !note.last;
            fence_acc<W_NT>(sc);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                // k-slice kk: box kk / 4, 32 bytes per slice inside the swizzle row
                const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
                wgmma_ss_n128(sc, sw128_desc(q_tile + off, 16, 8 * ROW_BYTES),
                              sw128_desc(k_tile + off, 16, 8 * ROW_BYTES), kk > 0);
            }
            wg_commit();
            wg_wait();
            fence_acc<W_NT>(sc);

            float fac[2];
            const bool need = softmax_chunk<W_NT>(sc, m, l, fac, p, cur, qpos, tig, EAGER);
            if (!branched || __any_sync(0xffffffffu, need)) scale_rows<NO>(o, fac);
            // P as the A fragments of the P V products, all made before the
            // fence so no register of a product is written while it runs
            uint32_t pf[W_BK / 16][4];
#pragma unroll
            for (int kk = 0; kk < W_BK / 16; ++kk) {
                pf[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
                pf[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
                pf[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
                pf[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
            }

            mbar_wait(v_full(s), parity);
            fence_acc<NO>(o);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < W_BK / 16; ++kk) {
                // keys [16 kk, 16 kk + 16): 16 rows of 128 bytes; the next
                // 64 head_dim columns lie one box further (LBO)
                wgmma_rs(o, pf[kk], sw128_desc(v_tile + kk * 16 * ROW_BYTES, BOX_BYTES,
                                               8 * ROW_BYTES));
            }
            wg_commit();
            wg_wait();
            fence_acc<NO>(o);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty(s));
            if (ACC_BF16 && cur.k0 + W_BK >= cur.kend) round_rows<NO>(o);   // block ends
        }

        float dv[2] = {1.f, 1.f};
        if (!EAGER) { dv[0] = fmaxf(l[0], 1e-30f); dv[1] = fmaxf(l[1], 1e-30f); }
        __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o)
                          + ((size_t)(b * p.Hq + h) * p.Sq) * D;
        store_rows<__nv_bfloat16, NO>(og, o, row0, p.Sq, D, tig, dv);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the process has loaded
EncodeTiled encode_tiled() {
    static EncodeTiled fn = [] {
        void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
        if (!lib) lib = dlopen("libcuda.so.1", RTLD_LAZY);
        return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
                   : nullptr;
    }();
    return fn;
}

// a (D, S, BH) bf16 tensor as 128-row boxes of 64 columns, 128B-swizzled;
// rows past S read as zeros
cudaError_t make_map(CUtensorMap* map, const void* ptr, int D, int S, int BH) {
    EncodeTiled fn = encode_tiled();
    if (!fn) return cudaErrorSharedObjectSymbolNotFound;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
    const cuuint32_t box[3] = {BOX_COLS, BOX_ROWS, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                    strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, bool ACC_BF16, bool GRID, bool EAGER>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    const int Hkv = p.Hq / p.rep;
    cudaError_t err = make_map(&tq, p.q, D, p.Sq, p.B * p.Hq);
    if (err == cudaSuccess) err = make_map(&tk, p.k, D, p.Sk, p.B * Hkv);
    if (err == cudaSuccess) err = make_map(&tv, p.v, D, p.Sk, p.B * Hkv);
    if (err != cudaSuccess) return err;
    const size_t smem = WLayout<D, GRID ? 2 : 1>::smem;
    err = cudaFuncSetAttribute(fa_fwd_wgmma<D, ACC_BF16, GRID, EAGER>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.Sq + W_BQ - 1) / W_BQ, p.Hq, p.B);
    fa_fwd_wgmma<D, ACC_BF16, GRID, EAGER><<<grid, W_THREADS, smem, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
}

template <int D, bool ACC_BF16>
cudaError_t dispatch_wgmma(const Params& p, int kv_in_grid, cudaStream_t s) {
    if (!kv_in_grid) return launch_wgmma<D, ACC_BF16, false, false>(p, s);
    return p.eager ? launch_wgmma<D, ACC_BF16, true, true>(p, s)
                   : launch_wgmma<D, ACC_BF16, true, false>(p, s);
}

template <int D>
cudaError_t dispatch_wgmma(const Params& p, int acc_bf16, int kv_in_grid, cudaStream_t s) {
    return acc_bf16 ? dispatch_wgmma<D, true>(p, kv_in_grid, s)
                    : dispatch_wgmma<D, false>(p, kv_in_grid, s);
}

}  // namespace

// body: 0 takes the mma_sync body for bf16 and the fp32 body for fp32;
// 1 takes the wgmma body (bf16, head_dim 64 or 128 only)
extern "C" int avo_flash_attention(
        const void* q, const void* k, const void* v, void* o,
        int dtype_bf16, int acc_bf16, int kv_in_grid,
        int B, int Hq, int rep, int Sq, int Sk, int D, int seq_mod,
        int bq, int bk, int nk, int causal, int window,
        float softcap, float scale, int branched, int block_skip, int eager,
        int body, void* stream) {
    if (D % 16 != 0 || D > MAXD || D <= 0 || rep <= 0 || Hq % rep != 0 ||
        bq <= 0 || bk <= 0)
        return (int)cudaErrorInvalidValue;
    Params p{q, k, v, o, B, Hq, rep, Sq, Sk, D, seq_mod, bq, bk, nk,
             causal, window, softcap, scale, branched, block_skip, eager};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (body == 1) {
        if (!dtype_bf16) return (int)cudaErrorInvalidValue;
        if (D == 128) return (int)dispatch_wgmma<128>(p, acc_bf16, kv_in_grid, s);
        if (D == 64) return (int)dispatch_wgmma<64>(p, acc_bf16, kv_in_grid, s);
        return (int)cudaErrorInvalidValue;
    }
    if (body != 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = dtype_bf16 ? dispatch<__nv_bfloat16>(p, acc_bf16, kv_in_grid, s)
                                 : dispatch<float>(p, acc_bf16, kv_in_grid, s);
    return (int)err;
}
