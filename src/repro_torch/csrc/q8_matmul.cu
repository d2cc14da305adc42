// Fused-dequant Q8_0 matmul for Hopper (sm_90a): a streaming decode path
// for M <= M_GEMV and a tensor-core tile path above it.
//
// Replaces: src/repro/kernels/q8_matmul.py :: q8_matmul (_dequant_kernel).
//   y(M,N) f32 = x(M,K) bf16 @ W(N,K)^T,  W[n,k] = bf16(qs[n,k] * d[n,k/32]),
//   d the fp16 block scales of the Q8_0 tensor, widened to f32.
//   Each weight is rounded to bf16 before the product, as the Pallas
//   kernel does; products accumulate in f32.
//
// What bounds it on the H100: at decode (M = 1..16) the weight bytes
// (8.5 bits/weight) and nothing else: Granite-8B's (4,14336,4096) reads
// 62 MB, 18.6 us at 3.35 TB/s.  At the UNet's M = B*h*w (up to 8192 rows)
// the tensor cores.
//
// Decode path (M <= M_GEMV, q8_gemv_kernel), on the plan of q4_matmul.cu's
// q4_gemv_kernel.  A CTA owns GEMV_ROWS = 16 weight rows, the A operand of
// mma.sync m16n8k16; the tokens are B (n = 8 columns, two column groups
// when M > 8).  The warps are interleaved over K steps of 4 Q8_0 blocks
// (128 elements); lane (gid, tig) takes block 4*step + tig of rows gid and
// gid + 8: 32 code bytes (two 16-byte loads) and the fp16 scale per row,
// and x[gid][that block] (four 16-byte loads).  Code word i of a block
// (elements 4i..4i+3) is one mma step: its pairs (4i, 4i+1) and (4i+2,
// 4i+3) are the lane's A registers, and x words 2i and 2i+1 of the same
// block are B as they lie in memory.
// Unpack in f32, exact for every (d, q): xor with 0x80808080 makes each
// byte q + 128, a byte permute puts it under the exponent byte 0x4B (the
// f32 2^23 + 128 + q), minus 2^23 + 128 gives q, q * d (at most 18
// significant bits) is exact in f32, and cvt.rn.bf16x2.f32 rounds each
// product once, as the reference does: 3.75 instructions per weight.  The
// q4 trick (bf16x2 fma with d = dh + dl) is not exact here: for |q| up to
// 128, q * dl needs up to 10 significant bits and rounds in bf16.  At the
// byte rate (3.35 TB/s of 8.5-bit weights, ~13.6 weights per SM-clock) an
// SM can issue ~9.4 thread instructions per weight, so the unpack leaves
// the kernel bound by its bytes.
// Software pipeline: a warp fetches the codes of its next GEMV_UNROLL K
// steps before it unpacks the current ones; x, which L1/L2 hold, is read
// at its step.
// CTA rule: 16 rows per CTA, grid ceil(N / 16), warps = min(8, ceil(K /
// 128)) interleaved over the K steps.  Granite-8B's decode shapes give
// 896 CTAs (N = 14336), 256 (N = 4096), 64 (N = 1024) and 3072 (the
// 49152-row head).
// M_GEMV = 16, two token groups, as far as the decode path's registers
// go: it was faster than the tile path at M = 1, 4, 8 and 16 on the H100
// (PERF.md).
// Determinism: each warp accumulates its K steps in order in the mma's
// f32 registers; the warps' partial tiles are added in warp order through
// shared memory.  No atomics, no split across CTAs.
// Edges: rows >= N, blocks past K/32 and tokens >= M are never read; their
// codes and scales are zero, so their A and B values are 0.
//
// Tile path (M > M_GEMV, q8_matmul_kernel): only int8 quants and one fp16
// scale per 32 weights are read from device memory; each 64x32 weight
// slice is dequantized in registers into shared memory and fed to the
// tensor cores through WMMA (bf16 16x16x16, f32 accumulate).  BK = 32 is
// exactly one Q8_0 block, so one scale covers a thread's 16 weights.  No
// cp.async/TMA pipelining and no wgmma yet.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int BK = 32;           // one Q8_0 block per K step (tile path)
constexpr int M_GEMV = 16;       // decode path for M <= M_GEMV
constexpr int GEMV_ROWS = 16;    // weight rows per CTA: the m16 of the mma
constexpr int GEMV_WARPS = 8;    // most warps per CTA
constexpr int GEMV_UNROLL = 2;   // K steps of loads issued before their math

__global__ void __launch_bounds__(GEMM_THREADS)
q8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
                 const __half* __restrict__ wd, float* __restrict__ y,
                 int M, int N, int K) {
    __shared__ __align__(128) bf16 xs[GEMM_BM * BK];
    __shared__ __align__(128) bf16 ws[GEMM_BN * BK];
    __shared__ __align__(128) float cs[GEMM_BM * GEMM_BN];

    const int n0 = blockIdx.x * GEMM_BN;
    const int m0 = blockIdx.y * GEMM_BM;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1, wn = warp & 1;
    const int nblk = K / BK;

    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    // Weight loader: thread t dequantizes 16 weights of row n = t/2.
    const int wn_row = threadIdx.x >> 1;
    const int wh = threadIdx.x & 1;
    const int gn = n0 + wn_row;

    for (int kb = 0; kb < nblk; ++kb) {
        const int k0 = kb * BK;
        load_x_tile<BK>(x, xs, M, K, m0, k0);
        bf16* dst = ws + wn_row * BK + wh * 16;
        if (gn < N) {
            const int4 raw = *reinterpret_cast<const int4*>(wq + (size_t)gn * K + k0 + wh * 16);
            const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
            const float s = __half2float(wd[(size_t)gn * nblk + kb]);
#pragma unroll
            for (int e = 0; e < 16; ++e) dst[e] = __float2bfloat16((float)q[e] * s);
        } else {
#pragma unroll
            for (int e = 0; e < 16; ++e) dst[e] = __float2bfloat16(0.0f);
        }
        __syncthreads();
        mma_tile<BK>(xs, ws, acc, wm, wn);
        __syncthreads();
    }
    store_tile(acc, cs, y, M, N, m0, n0, wm, wn);
}

// Word w of a block's codes holds its elements 4i..4i+3 (int8, element e
// in byte e).  r[0] gets elements (4i, 4i+1) as a bf16 pair, r[1] elements
// (4i+2, 4i+3), each bf16(q * d) rounded once from the exact f32 product.
__device__ __forceinline__ void unpack_word(uint32_t w, float d, uint32_t (&r)[2]) {
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

// One K step's codes and scales for a lane: block 4*step + tig of rows
// gid and gid + 8, 32 bytes each.
struct Codes {
    uint4 q[2][2];
    __half d[2];
};

// NT column groups of 8 tokens (M <= 8 * NT).
template <int NT>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
q8_gemv_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
               const __half* __restrict__ wd, float* __restrict__ y,
               int M, int N, int K) {
    __shared__ float red[GEMV_WARPS][GEMV_ROWS * 8 * NT];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarp = blockDim.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int n0 = blockIdx.x * GEMV_ROWS;
    const int nblk = K / 32, nstep = (nblk + 3) / 4;
    const int rows[2] = {n0 + gid, n0 + gid + 8};

    // The codes of steps st0 + u * nwarp (zero past K or N: nothing read).
    auto fetch = [&](Codes (&c)[GEMV_UNROLL], int st0) {
#pragma unroll
        for (int u = 0; u < GEMV_UNROLL; ++u) {
            const int st = st0 + u * nwarp, blk = 4 * st + tig;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                c[u].q[r][0] = c[u].q[r][1] = make_uint4(0u, 0u, 0u, 0u);
                c[u].d[r] = __ushort_as_half(0);
                if (st < nstep && blk < nblk && rows[r] < N) {
                    const uint4* src = reinterpret_cast<const uint4*>(
                        wq + (size_t)rows[r] * K + (size_t)blk * 32);
                    c[u].q[r][0] = src[0];
                    c[u].q[r][1] = src[1];
                    c[u].d[r] = wd[(size_t)rows[r] * nblk + blk];
                }
            }
        }
    };

    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[t][i] = 0.0f;

    // Software pipeline: the next steps' codes are in flight while these
    // are unpacked; x comes from L1/L2 at its step.
    Codes cur[GEMV_UNROLL], nxt[GEMV_UNROLL];
    fetch(cur, warp);
    for (int st0 = warp; st0 < nstep; st0 += nwarp * GEMV_UNROLL) {
        fetch(nxt, st0 + nwarp * GEMV_UNROLL);
#pragma unroll
        for (int u = 0; u < GEMV_UNROLL; ++u) {
            const int st = st0 + u * nwarp, blk = 4 * st + tig;
            uint4 xv[NT][4];
#pragma unroll
            for (int t = 0; t < NT; ++t) {
                const int m = gid + 8 * t;
                const bool live = st < nstep && blk < nblk && m < M;
                const uint4* src = reinterpret_cast<const uint4*>(
                    x + (size_t)m * K + (size_t)blk * 32);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    xv[t][j] = live ? src[j] : make_uint4(0u, 0u, 0u, 0u);
            }
            const float d0 = __half2float(cur[u].d[0]), d1 = __half2float(cur[u].d[1]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {       // code word i: one mma step
                uint32_t r0[2], r1[2];
                unpack_word(word(cur[u].q[0][i >> 2], i & 3), d0, r0);
                unpack_word(word(cur[u].q[1][i >> 2], i & 3), d1, r1);
                const uint32_t a[4] = {r0[0], r1[0], r0[1], r1[1]};
#pragma unroll
                for (int t = 0; t < NT; ++t)
                    mma16816(acc[t], a, word(xv[t][i >> 1], 2 * (i & 1)),
                             word(xv[t][i >> 1], 2 * (i & 1) + 1));
            }
        }
#pragma unroll
        for (int u = 0; u < GEMV_UNROLL; ++u) cur[u] = nxt[u];
    }
    gemv_store(acc, red, y, M, N, n0);
}

}  // namespace

// x: (M,K) bf16, wq: (N,K) int8, wd: (N,K/32) fp16, y: (M,N) f32.
// K % 32 == 0; x and wq 16-byte aligned (the wrapper checks both).
extern "C" int q8_matmul_bf16(const void* x, const void* wq, const void* wd, void* y,
                              int M, int N, int K, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bf16* xb = static_cast<const bf16*>(x);
    const int8_t* q = static_cast<const int8_t*>(wq);
    const __half* d = static_cast<const __half*>(wd);
    float* out = static_cast<float*>(y);
    if (M <= M_GEMV) {
        const int steps = (K / 32 + 3) / 4;
        const int threads = 32 * (steps < GEMV_WARPS ? (steps > 0 ? steps : 1) : GEMV_WARPS);
        const dim3 grid((N + GEMV_ROWS - 1) / GEMV_ROWS);
        if (M <= 8)
            q8_gemv_kernel<1><<<grid, threads, 0, st>>>(xb, q, d, out, M, N, K);
        else
            q8_gemv_kernel<2><<<grid, threads, 0, st>>>(xb, q, d, out, M, N, K);
    } else {
        dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
        q8_matmul_kernel<<<grid, GEMM_THREADS, 0, st>>>(xb, q, d, out, M, N, K);
    }
    return static_cast<int>(cudaGetLastError());
}
