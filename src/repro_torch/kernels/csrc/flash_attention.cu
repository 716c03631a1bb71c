// Genome-parameterized flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention
// (bodies _fa_body_grid and _fa_body_loop).  It computes the same function:
// softmax(Q K^T * scale [softcap] [mask]) V with an online softmax and f32
// statistics, causal / sliding-window / key-padding masks, GQA by h / rep, and
// the genome axes of core/search_space.py.  The Python wrapper
// (kernels/flash_attention.py) does the gqa_pack reshape and passes seq_mod.
//
// Layout.  One CTA of 4 warps owns a physical tile of 64 query rows; each warp
// owns 16 rows in the m16n8k16 accumulator layout (a thread holds rows g and
// g+8, g = lane / 4).  K and V stream through shared memory in physical chunks
// of 64 keys.  The genome's block_q / block_k are LOGICAL blocks (they reach
// 2048, far beyond shared memory); the kernel uses them for
//   * _block_classify and the block_skip loop bounds, so a genome skips
//     exactly the logical blocks the reference skips;
//   * the points where the bf16 accumulator (acc_dtype="bf16") is rounded:
//     once at the end of every visited logical K block.
// A logical K block is walked in chunks of at most 64 keys; keys of a chunk
// that lie outside its logical block take no part at all (p = 0).
//
// Genome axes on the card:
//   kv_in_grid=True  -> reference _fa_body_grid semantics; K/V chunks are
//                       double-buffered with cp.async (the load of chunk t+1
//                       overlaps the compute of chunk t).
//   kv_in_grid=False -> reference _fa_body_loop semantics (always mask, always
//                       rescale without a branch, always divide at the end,
//                       loop bounds narrowed only when seq_mod is unset); a
//                       single-stage K/V load loop with no overlap.
//   rescale_mode     -> "branched" skips the accumulator rescale when no row
//                       of the CTA tile needs it (__syncthreads_or), taken per
//                       chunk; skipping a factor of exactly 1 changes nothing.
//   mask_mode        -> "block_skip" skips fully masked logical blocks and the
//                       mask arithmetic on fully unmasked ones.
//   div_mode         -> "eager" keeps the accumulator normalized after every
//                       chunk (P is scaled by 1 / l before P V).
//   acc_dtype        -> bf16 rounds the accumulator at logical block ends.
//                       The reference's branched path also rounds the
//                       rescaled value before adding P V; the kernel rounds
//                       once.  Both errors sit far above the gate tolerance.
//
// Types.  fp32 inputs (the correctness gate) run both products as IEEE fp32
// FFMA on the CUDA cores, never TF32: the gate's tolerance of 2e-5 fails in
// TF32.  bf16 inputs (the measured rung) run both products on the tensor
// cores with mma.sync m16n8k16 and fp32 accumulation; P is rounded to bf16
// for the P V product, as FlashAttention does.
//
// Bound.  At every mha_suite shape the work is compute-bound on the H100:
// useful FLOPs / 989e12 exceeds (q + k + v + o bytes) / 3.35e12 by two
// orders of magnitude.  The design keeps the tensor cores fed only simply:
// ldmatrix fragments, exp2 with log2(e) folded into the scale, and (bf16,
// kv_in_grid=True) the Q tile staged in the second K/V buffer so three CTAs
// fit on an SM.  It leaves for later: wgmma and TMA, and warp
// specialisation.  (Two m-tiles per warp, as FlashAttention-2 has, measured
// no faster on the H100; PERF.md says what that rules out.)
//
// C interface: avo_flash_attention(...) launches on the given stream and
// returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // physical query rows per CTA
constexpr int BK = 64;          // physical keys per chunk
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

template <bool GRID>
struct Walk {
    const Params& p;
    int i_first, i_last;        // logical q blocks this CTA's rows touch
    int j_lo, j_hi;

    __device__ Walk(const Params& p_, int r0) : p(p_) {
        int r_last = min(r0 + BQ, p.Sq) - 1;
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
        if (c.k0 + BK < c.kend) {
            Cursor n = c;
            n.k0 = c.k0 + BK;
            return n;
        }
        return start(c.j + 1);
    }
};

// at most 170 registers a thread, so three CTAs (12 warps) fit on an SM
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

    Walk<GRID> walk(p, r0);
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
    const float scale2 = p.softcap != 0.f ? p.scale : p.scale * LOG2E;
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
        const int nkeys = min(BK, cur.kend - cur.k0);

        float s[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
        qk_chunk<T>(s, Qs, Ks, qf, D, warp, g, tig);

        float mx[2] = {NEG_INF2, NEG_INF2};
        if (p.softcap != 0.f) {
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    s[t][e] = p.softcap * tanhf(s[t][e] * scale2 / p.softcap) * LOG2E;
        } else {
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[t][e] *= scale2;
        }
        if (nkeys < BK || cur.mask) {               // a uniform branch per chunk
#pragma unroll
            for (int t = 0; t < NT; ++t) {
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
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
        float alpha[2], fac[2], inv[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            mx[r] = fmaxf(m[r], mx[r]);             // m_new
            alpha[r] = exp2f(m[r] - mx[r]);
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
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
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[t][e] *= inv[e >> 1];
        }
        bool rescale = true;
        if (branched) {
            bool need = eager ? (fac[0] != 1.f || fac[1] != 1.f)
                              : (fac[0] < 1.f || fac[1] < 1.f);
            rescale = __syncthreads_or(need);
        }
        if (rescale) {
#pragma unroll
            for (int n = 0; n < ND; ++n) {
                o[n][0] *= fac[0]; o[n][1] *= fac[0];
                o[n][2] *= fac[1]; o[n][3] *= fac[1];
            }
        }
        pv_chunk<T>(o, s, Vs, Ps + warp * 16 * (BK + 4), D, g, tig, lane);
        if (ACC_BF16 && cur.k0 + BK >= cur.kend) {    // logical block ends
#pragma unroll
            for (int n = 0; n < ND; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[n][e] = round_bf16(o[n][e]);
        }

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
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        int row = r0 + warp * 16 + g + 8 * r;
        if (row >= p.Sq) continue;
        T* orow = og + (size_t)row * D + tig * 2;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
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

}  // namespace

extern "C" int avo_flash_attention(
        const void* q, const void* k, const void* v, void* o,
        int dtype_bf16, int acc_bf16, int kv_in_grid,
        int B, int Hq, int rep, int Sq, int Sk, int D, int seq_mod,
        int bq, int bk, int nk, int causal, int window,
        float softcap, float scale, int branched, int block_skip, int eager,
        void* stream) {
    if (D % 16 != 0 || D > MAXD || D <= 0 || rep <= 0 || Hq % rep != 0 ||
        bq <= 0 || bk <= 0)
        return (int)cudaErrorInvalidValue;
    Params p{q, k, v, o, B, Hq, rep, Sq, Sk, D, seq_mod, bq, bk, nk,
             causal, window, softcap, scale, branched, block_skip, eager};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = dtype_bf16 ? dispatch<__nv_bfloat16>(p, acc_bf16, kv_in_grid, s)
                                 : dispatch<float>(p, acc_bf16, kv_in_grid, s);
    return (int)err;
}
