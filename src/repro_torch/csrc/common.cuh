// Shared pieces of the port's CUDA kernels (sm_90a, plain C interface).
//
// Every entry point is `extern "C"`, takes raw device pointers and the
// caller's cudaStream_t, allocates nothing, and returns
// cudaGetLastError() as an int so the Python wrapper can raise on it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace repro {

using bf16 = __nv_bfloat16;

// 16-byte asynchronous copy global -> shared; with !valid nothing is read
// and 16 zero bytes are written.  Groups are committed and waited on with
// the helpers below (wait_prev: all but the most recent group).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// ldmatrix of four 8x8 bf16 matrices (rows of 16 bytes at the addresses
// lanes 0-7, 8-15, 16-23 and 24-31 give), plain or transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// ldmatrix of two 8x8 b16 matrices (rows of 16 bytes at the addresses
// lanes 0-7 and 8-15 give; the other lanes' addresses are not read).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// d(16x8, s32) = a(16x32, s8, row) b(32x8, s8, col) + c in every element:
// an exact int32 dot over k = 32 (one Q8_0 block) per (row, column).
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1, int c) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c), "r"(c),
          "r"(c), "r"(c));
}

// c(16x8, f32) += a(16x16, bf16, row) b(16x8, bf16, col).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two halves of a thread-block-cluster barrier (arrive has relaxed
// order: the caller orders its own shared-memory traffic).
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 2^x on the special-function unit (flushes subnormal results to 0).
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// Two floats rounded to bf16 (hi) and what is left of each rounded to
// bf16 (lo), as A-fragment words: 16 significant bits in two terms.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    const __nv_bfloat162 r = __floats2bfloat162_rn(a - f.x, b - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Launch set-up done once per device.  Each launch keeps a static
// PerDevice<N> of its own (one per instantiation); get() points `vals` at
// the current device's N ints, first calling init(dev, vals) on a device
// not seen yet, which sets the kernels' shared-memory limits and fills in
// what the launch rule needs (the SM count, the clusters that fit).  A
// non-zero return is a CUDA error, and the device then stays unseen.
constexpr int MAX_DEVICES = 64;

template <int N>
struct PerDevice {
    int vals[MAX_DEVICES][N];
    bool ready[MAX_DEVICES];

    template <class Init>
    int get(int*& out, Init init) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
        if (!ready[dev]) {
            err = init(dev, vals[dev]);
            if (err != cudaSuccess) return static_cast<int>(err);
            ready[dev] = true;
        }
        out = vals[dev];
        return 0;
    }
};

// ---------------------------------------------------------------------
// One warp's part of FlashAttention-2 on mma.sync, shared by
// flash_attention.cu and flash_prefill.cu: 16 query rows against 64-key
// tiles of K and V in shared memory, bf16 rows DP + 8 elements apart (an
// odd number of 16-byte units, so ldmatrix on K and ldmatrix.trans on V
// are free of bank conflicts).  Lane (gid = lane / 4, tig = lane % 4)
// holds rows gid and gid + 8.
// - qf: Q as the A fragments of mma.m16n8k16 (bf16 in, f32 accumulate),
//   loaded once by load_q and held for the whole key loop.
// - tile(): S = Q K^T in registers (8 n8-tiles x 4 f32), masked only when
//   the caller says the tile crosses an edge; the row max and sum reduce
//   over the quad of lanes; p = 2^(s*c - m*c) with c = scale*log2(e), one
//   FMA and one ex2 per logit; O and l are rescaled only when a row max
//   of the warp moved.
// - P enters P.V in registers, as one bf16 term (HILO false: the Pallas
//   flash kernel's rounding point) or as two, hi = bf16(p) and lo =
//   bf16(p - hi), two mma per k-step (HILO true: the plain version keeps
//   P in f32).
// - acc: O, DP/8 n8-tiles x 4 f32 (row gid in [0..1], gid + 8 in [2..3]);
//   m, l per row, l summed over the quad by finish().
constexpr int FLASH_BKV = 64;

template <int DP>
struct FlashWarp {
    static constexpr int LD = DP + 8, KS = DP / 16, NS = FLASH_BKV / 8;
    uint32_t qf[KS][4];
    float acc[2 * KS][4];
    float m[2], l[2];

    __device__ __forceinline__ FlashWarp() {
#pragma unroll
        for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = 0.0f;
    }

    // The warp's 16 rows of Q at `rows`; qsign flips their sign (a
    // negative scale, so that the row max is taken on s*|scale|).
    __device__ __forceinline__ void load_q(const bf16* rows, uint32_t qsign) {
        const int lane = threadIdx.x & 31;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            ldsm_x4(qf[kk], rows + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + kk * 16 +
                                (lane >> 4) * 8);
#pragma unroll
            for (int e = 0; e < 4; ++e) qf[kk][e] ^= qsign;
        }
    }

    // Keys k0 .. k0 + 63 from tiles kt and vt.  With edge, key kp is kept
    // for the row at diagonal position qd[r] only if kp < klim, kp <= qd[r]
    // (causal) and kp > qd[r] - window (window > 0).
    template <bool HILO>
    __device__ __forceinline__ void tile(const bf16* kt, const bf16* vt, float c, bool edge,
                                         int k0, int klim, bool causal, int window,
                                         const int (&qd)[2]) {
        const int lane = threadIdx.x & 31, tig = lane & 3;

        // S(16 x 64) = Q K^T.
        float s[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
            for (int jp = 0; jp < NS / 2; ++jp) {
                uint32_t b[4];
                ldsm_x4(b, kt + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                               ((lane >> 3) & 1) * 8);
                mma16816(s[2 * jp], qf[kk], b[0], b[1]);
                mma16816(s[2 * jp + 1], qf[kk], b[2], b[3]);
            }
        if (edge) {
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int kp = k0 + 8 * j + 2 * tig + (e & 1);
                    const int qp = qd[e >> 1];
                    const bool ok = kp < klim && (!causal || kp <= qp) &&
                                    (window <= 0 || kp > qp - window);
                    if (!ok) s[j][e] = -INFINITY;
                }
        }

        // Online softmax of rows gid (r = 0) and gid + 8 (r = 1).
        float mx[2], mc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = m[r];
#pragma unroll
            for (int j = 0; j < NS; ++j)
                mx[r] = fmaxf(mx[r], fmaxf(s[j][2 * r], s[j][2 * r + 1]));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            mc[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * c;   // no unmasked key yet
        }
        if (__any_sync(0xffffffffu, mx[0] != m[0] || mx[1] != m[1])) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float alpha = ex2(m[r] * c - mc[r]);
                l[r] *= alpha;
#pragma unroll
                for (int n = 0; n < 2 * KS; ++n) {
                    acc[n][2 * r] *= alpha;
                    acc[n][2 * r + 1] *= alpha;
                }
            }
        }
        m[0] = mx[0];
        m[1] = mx[1];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[j][e] = ex2(fmaf(s[j][e], c, -mc[e >> 1]));
                l[e >> 1] += s[j][e];
            }

        // O(16 x DP) += P(16 x 64) V(64 x DP).
#pragma unroll
        for (int kk = 0; kk < FLASH_BKV / 16; ++kk) {
            uint32_t hi[4];
            [[maybe_unused]] uint32_t lo[4];
            if constexpr (HILO) {
                split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
                split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
                split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
                split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
            } else {
                hi[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
                hi[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
                hi[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
                hi[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
            }
#pragma unroll
            for (int np = 0; np < KS; ++np) {
                uint32_t b[4];
                ldsm_x4_t(b, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                 np * 16 + (lane >> 4) * 8);
                mma16816(acc[2 * np], hi, b[0], b[1]);
                mma16816(acc[2 * np + 1], hi, b[2], b[3]);
                if constexpr (HILO) {
                    mma16816(acc[2 * np], lo, b[0], b[1]);
                    mma16816(acc[2 * np + 1], lo, b[2], b[3]);
                }
            }
        }
    }

    // Each row's l summed over its quad of lanes.
    __device__ __forceinline__ void finish() {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        }
    }
};

// Q8_0 codes to bf16, exactly as the reference dequantizes them.  Word w
// holds elements 4i..4i+3 (int8, element e in byte e).  r[0] gets elements
// (4i, 4i+1) as a bf16 pair, r[1] elements (4i+2, 4i+3), each bf16(q * d)
// rounded once from the exact f32 product.
__device__ __forceinline__ void q8_unpack_word(uint32_t w, float d, uint32_t (&r)[2]) {
    const uint32_t u = w ^ 0x80808080u;              // byte e: q + 128
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        // 0x4B0000(q + 128): the f32 2^23 + 128 + q.
        const float v = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | e));
        f[e] = __fmul_rn(__fsub_rn(v, 8388736.0f), d);   // q * d, exact
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * h], f[2 * h + 1]);
        r[h] = *reinterpret_cast<const uint32_t*>(&p);
    }
}

// ---------------------------------------------------------------------
// Pieces of the quantized matmuls' decode paths (q8_matmul.cu,
// q3k_matmul.cu, q4_matmul.cu): a CTA owns 16 weight rows, the m16 of
// mma.sync m16n8k16, and NT groups of 8 tokens as its n8 columns.

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[t] of each warp holds rows gid (acc[t][0..1]) and gid + 8 (2..3) of
// the CTA's 16, tokens 8t + 2tig (+1), summed over the warp's K steps.
// The warps' partial tiles are added in warp order through `red`, so the
// sum is the same on every run; rows >= N and tokens >= M are not stored.
template <int NT, int WARPS>
__device__ __forceinline__ void gemv_store(const float (&acc)[NT][4],
                                           float (&red)[WARPS][16 * 8 * NT],
                                           float* __restrict__ y, int M, int N, int n0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarp = blockDim.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = gid + 8 * (i >> 1), tok = 8 * t + 2 * tig + (i & 1);
            red[warp][row * 8 * NT + tok] = acc[t][i];
        }
    __syncthreads();
    for (int i = threadIdx.x; i < 16 * 8 * NT; i += blockDim.x) {
        const int row = i / (8 * NT), tok = i - row * 8 * NT;
        if (n0 + row >= N || tok >= M) continue;
        float s = 0.0f;
        for (int w = 0; w < nwarp; ++w) s += red[w][i];
        y[(size_t)tok * N + n0 + row] = s;
    }
}

// 4- and 8-byte asynchronous copies (cp.async.ca), zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 8 : 0));
}
// A 4-byte copy that reads only the first n (0..4) bytes of src and
// zero-fills the rest.
__device__ __forceinline__ void cp_async4_n(void* dst, const void* src, int n) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A 16-byte copy through L1 (cp.async.ca): for data that other blocks of
// the SM read again.
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// ---------------------------------------------------------------------
// Tile path of the quantized matmuls q8_matmul.cu, q3k_matmul.cu and
// q4_matmul.cu (M > M_GEMV):  y(M,N) f32 = x(M,K) bf16 @ W(N,K)^T, the
// weight dequantized in shared memory and never written to device memory.
//
// What bounds it on the H100: the tensor cores.  A CTA tile of BM tokens
// and BN weight rows does 2 * BM flops per weight it unpacks and 2 * BN
// per x element it copies, so at 256 x 128 Granite-8B's (256, 14336,
// 4096) is far above the card's 295 flops per byte; at the UNet's short
// K the f32 y (4 bytes per output) is most of the bytes.  The unpack (3.75
// integer and f32 instructions per Q8_0 weight, ~4.7 per Q3_K weight,
// ~2.7 per Q4_0 weight) is the other cost, paid once per weight per CTA.
// Design:
// - Warp-specialised CTAs: two warpgroups (TILE_MMA_WARPS = 8 warps) only
//   multiply, on wgmma (m64nNk16, bf16 in, f32 sums in registers), and NP
//   = 256 producer threads (two more warpgroups) only copy and unpack, so
//   that the integer unpack and the copies issue beside the tensor cores.
//   The warpgroups split the tile's rows (BM >= 128) or, at 64 x 64, its
//   columns.  Tokens are wgmma's A and weight rows its B, both K-major in
//   shared memory, read through descriptors.
// - K steps of TILE_BK = 64 weights (two Q8_0 blocks, a quarter of a
//   Q3_K super-block): four k16 steps, WGM wgmma each per warpgroup.
// - A ring of STAGES slots (TILE_STAGES, or 3 when four do not fit in
//   shared memory), each the step's x tile (bf16, 16-byte cp.async), its
//   raw weight bytes and scales (the format's load(): 16-, 8- and 4-byte
//   cp.async, what device memory delivers) and its bf16 weight tile.  The
//   producers copy step k + AHEAD while they unpack step k (the format's
//   unpack(), 16 weights of a row per unit), each weight once per CTA,
//   for BM tokens; the unpack runs STAGES - AHEAD = TILE_LEAD steps ahead
//   of the mma.  The producers fence their writes to the async proxy
//   that wgmma reads through.  A format may keep copies of its own past
//   the ring (Q3_K's scales, once per super-block).
// - Named barriers hand the slots over: FULL[s] (producers arrive when
//   x and the bf16 weights of the slot are in place, mma warps wait),
//   EMPTY[s] (mma warps arrive when their wgmma of the slot completed,
//   producers wait before refilling it) and PROD (the producers' copies of
//   a step have landed before any of them unpacks it).
// - x and weight tiles are rows of 128 bytes (64 weights), 16-byte chunk c
//   of row r at c ^ (r & 7), in slots 1024-byte aligned: the 128-byte
//   swizzle that wgmma's descriptors read, and 8 distinct bank groups for
//   the unpack's 16-byte stores and cp.async.
// - Epilogue: the mma warps store their accumulators straight to y as
//   float2 (4 lanes fill one 32-byte sector of a row), rows >= M and
//   cols >= N masked (element stores when N is odd).
// - The 256 x 128 tile's two m64n128 sums per thread (128 registers) need
//   more than the 128 that 512 threads get: setmaxnreg moves registers
//   from the producers (80) to the mma warps (176).  ptxas (sm_90a, q8 /
//   q3k): 128 / 128 registers at 256 x 128 (before setmaxnreg), 95 / 90
//   at 128 x 128, 64 / 64 at 128 x 64, 56 / 53 at 64 x 64; no spills.
// - CTA rule (tile_launch): of 256 x 128 (M > 128), 128 x 128, 128 x 64
//   (M > 64) and 64 x 64, the tile whose waves of one CTA per SM take the
//   least time, a wave's time being BM * BN over the tile's measured rate
//   (TILE_RATE_*): larger tiles unpack each weight for more tokens, smaller
//   ones fill more SMs.  Granite-8B's chunk (M = 256) gives 112 CTAs of
//   256 x 128 (N = 14336), 128 of 128 x 64 (N = 4096) and 64 of 64 x 64
//   (N = 1024).
// - Deterministic: each output is one thread's accumulator over the K
//   steps in order; no split of K, no atomics.  Rows >= M and >= N and K
//   past the end are zero-filled by cp.async (src-size 0).
constexpr int TILE_BK = 64;            // weights per K step
constexpr int TILE_MMA_WARPS = 8;
constexpr int TILE_STAGES = 4;         // ring slots, at most
constexpr int TILE_LEAD = 2;           // steps the unpack runs ahead of the mma
// CTA rule: one CTA per SM; the time of a wave of CTAs of each tile is
// taken as BM * BN over the tile's rate, in GFLOP/s per SM, as
// tools/kernel_ab.py measured q8_matmul on an H100 80GB HBM3 at 700 W
// (256 x 128 at (256, 14336, 4096), 128 x 128 and 128 x 64 at (256, 4096,
// 14336), 64 x 64 at (256, 1024, 4096)).
constexpr int TILE_RATE_256x128 = 3530;
constexpr int TILE_RATE_128x128 = 2580;
constexpr int TILE_RATE_128x64 = 1720;
constexpr int TILE_RATE_64x64 = 970;
constexpr int TILE_SMEM_MAX = 232448;  // shared memory a block may use (227 KB)

__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Element offset of chunk c (8 bf16) of row r in a swizzled 64-wide tile.
__device__ __forceinline__ int tile_swz(int r, int c) { return r * TILE_BK + ((c ^ (r & 7)) << 3); }

// The block scales of a format that keeps them as Q8_0 and Q4_0 do: fp16
// (N, K/32), one per 32 weights of a row, so two per K step.  A ring slot
// holds BYTES of them: per row two aligned 4-byte words, the words that
// hold the step's two scales (the wrapper aligns wd to 16 bytes; a scale
// is the half of its word that its element index's parity names).  When
// K / 32 is even one word holds both of a step's scales of a row: one
// copy per row, into the first word.  Blocks past K / 32 and rows past N
// copy as zero bytes: scale 0.  Producer t's units are those of the tile
// (unit i = t + NP * u: row i / 4, weights 16 (i % 4) .. + 15, block
// (i % 4) / 2 of the step).
template <int BN, int NP>
struct TileScales {
    static constexpr int BYTES = BN * 8;
    static constexpr int UNITS = BN * 4 / NP;
    static constexpr int COPIES = (BN * 2 + NP - 1) / NP;   // odd K / 32: per (row, block)
    const __half* wd;
    size_t e0;              // odd K / 32: element of (row t / 2, block t % 2), step 0;
                            // + NP / 2 rows per further copy
    size_t ev;              // even K / 32: element of (row t, block 0)
    int n0, N, nblk, t;
    uint32_t par;           // bit u: parity of unit u's scale element

    __device__ __forceinline__ TileScales(const __half* wd_, int n0_, int N_, int K, int t_)
        : wd(wd_), n0(n0_), N(N_), nblk(K / 32), t(t_) {
        e0 = (size_t)(n0 + (t >> 1)) * nblk + (t & 1);
        ev = (size_t)(n0 + t) * nblk;
        par = 0;
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
            const int i = t + NP * u;
            par |= (uint32_t)((((size_t)(n0 + (i >> 2)) * nblk + ((i & 3) >> 1)) & 1) << u);
        }
    }

    // This producer's share of step k's scale copies into dst (BYTES).
    __device__ __forceinline__ void load(unsigned char* dst, int k) const {
        if ((nblk & 1) == 0) {
#pragma unroll
            for (int it = 0; it < (BN + NP - 1) / NP; ++it) {
                const int i = t + NP * it;
                const bool in = i < BN && n0 + i < N && 2 * k < nblk;
                if (i < BN)
                    cp_async4(dst + 8 * i, in ? wd + ev + (size_t)NP * nblk * it + 2 * k : wd, in);
            }
            return;
        }
#pragma unroll
        for (int it = 0; it < COPIES; ++it) {
            const int i = t + NP * it;               // row i / 2, block 2k + i % 2
            if (i < BN * 2) {
                const bool in = n0 + (i >> 1) < N && 2 * k + (i & 1) < nblk;
                const size_t e = e0 + (size_t)(NP / 2) * nblk * it + 2 * k;
                cp_async4(dst + 4 * i, in ? wd + (e & ~(size_t)1) : wd, in);
            }
        }
    }

    // Unit u's scale, from the slot's scale words at src.
    __device__ __forceinline__ float get(const unsigned char* src, int u) const {
        const int i = t + NP * u, r = i >> 2, j = i & 3;
        const int wsel = nblk & 1 ? j >> 1 : 0;      // (even K / 32: one word, half j / 2)
        const uint32_t dw = *reinterpret_cast<const uint32_t*>(src + 8 * r + 4 * wsel);
        return __half2float(__ushort_as_half(
            static_cast<unsigned short>((par >> u) & 1 ? dw >> 16 : dw & 0xFFFFu)));
    }
};

// A tile of BM x BN for format Fmt with NP producers.  The two mma
// warpgroups split the tile's rows (BM >= 128: WGM m64 blocks each, all BN
// columns) or, at BM = 64, its columns (BN / 2 each).
// The format supplies raw_bytes(BN) (raw bytes of one slot), extra_bytes(BN)
// (shared memory of its own past the ring), expert(e) (the format of expert
// e of a batched call: its arrays moved on by their per-expert strides, as
// aligned as expert 0's) and Producer<BN, NP>(fmt, n0, N,
// K, t, extra), producer t's addresses worked out once, with load(raw, k)
// issuing its share of the cp.async copies of step k's weight bytes and
// scales and unpack(raw, wt, k) writing its units of the bf16 tile (unit
// i: row i / 4, weights 16 (i % 4) .. + 15, two swizzled chunks; units t +
// NP * u).
template <class Fmt, int BM_, int BN_, int NP_, int MMA_REGS_ = 0>
struct Tile {
    static constexpr int BM = BM_, BN = BN_, NP = NP_;
    static constexpr int THREADS = TILE_MMA_WARPS * 32 + NP;
    static constexpr bool SPLIT_M = BM >= 128;
    static constexpr int WGM = SPLIT_M ? BM / 128 : 1;         // m64 blocks per warpgroup
    static constexpr int WGN = SPLIT_M ? BN : BN / 2;          // n of each wgmma
    // With MMA_REGS, setmaxnreg gives each mma thread MMA_REGS registers
    // and each producer what is left of the SM's 65536 (multiples of 8).
    static constexpr int MMA_REGS = MMA_REGS_;
    static constexpr int PROD_REGS = (65536 - TILE_MMA_WARPS * 32 * MMA_REGS) / NP / 8 * 8;
    static constexpr int XS = BM * TILE_BK * 2, WB = BN * TILE_BK * 2;
    // Slots start on 1024 bytes, the period of the 128-byte swizzle.
    static constexpr int SLOT = (XS + WB + Fmt::raw_bytes(BN) + 1023) / 1024 * 1024;
    static constexpr int EXTRA = Fmt::extra_bytes(BN);
    static constexpr int STAGES = TILE_STAGES * SLOT + EXTRA <= TILE_SMEM_MAX ? TILE_STAGES : 3;
    static constexpr int AHEAD = STAGES - TILE_LEAD;   // steps the copies run ahead of the unpack
    static constexpr int SMEM = STAGES * SLOT + EXTRA;
    static_assert(TILE_MMA_WARPS == 8 && (SPLIT_M ? BM % 128 == 0 : BM == 64), "warpgroups");
    static_assert(STAGES >= 3 && AHEAD >= 1 && SMEM <= TILE_SMEM_MAX && 2 + 2 * STAGES <= 16,
                  "ring");
    static_assert(BM * 8 % NP == 0 && BN * 4 % NP == 0 && NP % 128 == 0, "producer passes");
    static_assert(MMA_REGS == 0 || (MMA_REGS % 8 == 0 && PROD_REGS >= 24 && MMA_REGS <= 256),
                  "register split");
};

// wgmma.mma_async m64nNk16, bf16 in, f32 sums added to d; A and B from
// shared memory through the descriptors a and b.
template <int N>
struct Wgmma;
template <>
struct Wgmma<128> {
    static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
            "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
            :
              "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
              "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(a), "l"(b), "r"(1));
    }
};
template <>
struct Wgmma<64> {
    static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
            "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
            :
              "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "l"(a), "l"(b), "r"(1));
    }
};
template <>
struct Wgmma<32> {
    static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
            "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
            :
              "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "l"(a), "l"(b), "r"(1));
    }
};

// Descriptor of a K-major bf16 tile in shared memory with the 128-byte
// swizzle (tile_swz's layout): rows of 128 bytes, 8-row groups 1024 bytes
// apart; the start moves by 32 bytes per k16 step.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
           (uint64_t)1 << 62;
}
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}

// The experts of a batched matmul (one launch for E products of the same
// M, N and K): E, and the elements from one expert's x and y to the
// next's.  The weight's strides ride in the format (Fmt::expert).  E = 1
// is the plain two-dimensional call.
struct Batch {
    int E = 1;
    size_t sx = 0, sy = 0;
};

template <class Fmt, class T>
__global__ void __launch_bounds__(T::THREADS, 1)
tile_kernel(const bf16* __restrict__ x, const Fmt fmt, float* __restrict__ y,
            int M, int N, int K, size_t sx, size_t sy) {
    constexpr int STAGES = T::STAGES, THREADS = T::THREADS;
    constexpr int FULL = 1, EMPTY = 1 + STAGES, PROD = 1 + 2 * STAGES;
    extern __shared__ __align__(1024) unsigned char smem[];
    // Expert blockIdx.z of a batched call (0 otherwise): its x, weight
    // and y, sx, the format's and sy elements on per expert.
    x += blockIdx.z * sx;
    y += blockIdx.z * sy;
    const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
    const int nsteps = (K + TILE_BK - 1) / TILE_BK;
    auto xs = [&](int k) { return reinterpret_cast<bf16*>(smem + (k % STAGES) * T::SLOT); };
    auto wt = [&](int k) { return reinterpret_cast<bf16*>(smem + (k % STAGES) * T::SLOT + T::XS); };
    auto raw = [&](int k) { return smem + (k % STAGES) * T::SLOT + T::XS + T::WB; };

    if (threadIdx.x >= TILE_MMA_WARPS * 32) {              // producers
        if constexpr (T::MMA_REGS > 0) setmaxnreg_dec<T::PROD_REGS>();
        const int t = threadIdx.x - TILE_MMA_WARPS * 32;
        const typename Fmt::template Producer<T::BN, T::NP> prod(fmt.expert(blockIdx.z), n0, N,
                                                                 K, t, smem + STAGES * T::SLOT);
        // This thread's x chunks: chunk xc of rows xr + XROWS * it.
        constexpr int XIT = T::BM * 8 / T::NP, XROWS = T::NP / 8;
        const int xr = t >> 3, xc = t & 7;
        const bf16* xsrc = x + (size_t)(m0 + xr) * K + 8 * xc;
        const int xdst = tile_swz(xr, xc);                 // + XROWS * 64 per it
        auto load = [&](int k) {
            if (k < nsteps) {
                if (k >= STAGES) bar_sync(EMPTY + k % STAGES, THREADS);
                const int k0 = k * TILE_BK;
                const bool kin = k0 + 8 * xc < K;
                bf16* dst = xs(k) + xdst;
#pragma unroll
                for (int it = 0; it < XIT; ++it) {
                    const bool in = kin && m0 + xr + XROWS * it < M;
                    cp_async16(dst + XROWS * TILE_BK * it,
                               in ? xsrc + (size_t)XROWS * K * it + k0 : x, in);
                }
                prod.load(raw(k), k);
            }
            cp_async_commit();
        };
#pragma unroll
        for (int k = 0; k < T::AHEAD; ++k) load(k);
        for (int k = 0; k < nsteps; ++k) {
            load(k + T::AHEAD);
            cp_async_wait_n<T::AHEAD>();                   // step k landed ...
            bar_sync(PROD, T::NP);                         // ... for every producer
            prod.unpack(raw(k), wt(k), k);
            // wgmma reads the slot through the async proxy.
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            bar_arrive(FULL + k % STAGES, THREADS);
        }
        return;
    }

    if constexpr (T::MMA_REGS > 0) setmaxnreg_inc<T::MMA_REGS>();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wg = warp >> 2;                              // warpgroup
    const int row0 = T::SPLIT_M ? wg * T::WGM * 64 : 0;    // its rows and columns
    const int col0 = T::SPLIT_M ? 0 : wg * T::WGN;
    float acc[T::WGM][T::WGN / 2];
#pragma unroll
    for (int i = 0; i < T::WGM; ++i)
#pragma unroll
        for (int e = 0; e < T::WGN / 2; ++e) acc[i][e] = 0.0f;

    const uint32_t smem0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    for (int k = 0; k < nsteps; ++k) {
        bar_sync(FULL + k % STAGES, THREADS);
        const uint32_t xa = smem0 + (k % STAGES) * T::SLOT + row0 * 128;
        const uint32_t wa = smem0 + (k % STAGES) * T::SLOT + T::XS + col0 * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE_BK / 16; ++kk)
#pragma unroll
            for (int i = 0; i < T::WGM; ++i)
                Wgmma<T::WGN>::mma(acc[i], wgmma_desc(xa + i * 64 * 128 + 32 * kk),
                                   wgmma_desc(wa + 32 * kk));
        wgmma_commit();
        wgmma_wait<0>();
        // Release the slot only when a producer will refill it.
        if (k + STAGES < nsteps) bar_arrive(EMPTY + k % STAGES, THREADS);
    }

    // acc[i][4j + e]: row row0 + 64 i + 16 (warp % 4) + gid + 8 (e / 2),
    // column col0 + 8 j + 2 tig + e % 2 (the mma.m16n8 layout per 8 columns).
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < T::WGM; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = m0 + row0 + 64 * i + 16 * (warp & 3) + gid + 8 * h;
            if (r >= M) continue;
            float* yr = y + (size_t)r * N;
#pragma unroll
            for (int j = 0; j < T::WGN / 8; ++j) {
                const int c = n0 + col0 + 8 * j + 2 * tig;
                const float v0 = acc[i][4 * j + 2 * h], v1 = acc[i][4 * j + 2 * h + 1];
                if ((N & 1) == 0) {
                    if (c < N) *reinterpret_cast<float2*>(yr + c) = make_float2(v0, v1);
                } else {
                    if (c < N) yr[c] = v0;
                    if (c + 1 < N) yr[c + 1] = v1;
                }
            }
        }
}

template <class Fmt, class T>
cudaError_t tile_setup() {
    return cudaFuncSetAttribute(tile_kernel<Fmt, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                T::SMEM);
}

// Grid (N tiles, M tiles, E experts): a batched call is one launch whose
// experts are its z blocks, each a whole (M, N, K) product.
template <class Fmt, class T>
void tile_run(const bf16* x, const Fmt& fmt, float* y, int M, int N, int K, const Batch& b,
              cudaStream_t st) {
    const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, b.E);
    tile_kernel<Fmt, T><<<grid, T::THREADS, T::SMEM, st>>>(x, fmt, y, M, N, K, b.sx, b.sy);
}

// CTA rule (see above), over the CTAs of all E experts; the SM count and
// the shared-memory limits are set up once per device.
template <class Fmt>
int tile_launch(const bf16* x, const Fmt& fmt, float* y, int M, int N, int K, cudaStream_t st,
                const Batch& b = Batch{}) {
    using T256 = Tile<Fmt, 256, 128, 256, 176>;   // 2 x 64 sums of m64n128: 176 registers
    using T128 = Tile<Fmt, 128, 128, 256>;
    using T128x64 = Tile<Fmt, 128, 64, 256>;
    using T64 = Tile<Fmt, 64, 64, 256>;
    static PerDevice<1> sms_of;
    int* dev_sms = nullptr;
    if (const int err = sms_of.get(dev_sms, [](int dev, int* v) {
            cudaError_t e = cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, dev);
            if (e == cudaSuccess) e = tile_setup<Fmt, T256>();
            if (e == cudaSuccess) e = tile_setup<Fmt, T128>();
            if (e == cudaSuccess) e = tile_setup<Fmt, T128x64>();
            if (e == cudaSuccess) e = tile_setup<Fmt, T64>();
            return e;
        }))
        return err;
    // The tile with the least time: waves of CTAs (one per SM) times a
    // wave's time; ties go to the larger tile.
    const int sms = dev_sms[0];
    auto cost = [&](int bm, int bn, int rate) {
        const long long ctas = (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn) * b.E;
        return (ctas + sms - 1) / sms * (bm * bn * 100000LL / rate);
    };
    const long long c256 = M > 128 ? cost(256, 128, TILE_RATE_256x128) : LLONG_MAX;
    const long long c128 = M > 64 ? cost(128, 128, TILE_RATE_128x128) : LLONG_MAX;
    const long long c128x64 = M > 64 ? cost(128, 64, TILE_RATE_128x64) : LLONG_MAX;
    const long long c64 = cost(64, 64, TILE_RATE_64x64);
    if (c256 <= c128 && c256 <= c128x64 && c256 <= c64)
        tile_run<Fmt, T256>(x, fmt, y, M, N, K, b, st);
    else if (c128 <= c128x64 && c128 <= c64)
        tile_run<Fmt, T128>(x, fmt, y, M, N, K, b, st);
    else if (c128x64 <= c64)
        tile_run<Fmt, T128x64>(x, fmt, y, M, N, K, b, st);
    else
        tile_run<Fmt, T64>(x, fmt, y, M, N, K, b, st);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
