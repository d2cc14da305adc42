// Integer-path Q8_0 x Q8_0 matmul (w8a8) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/q8_matmul.py :: q8_matmul_w8a8 (_w8a8_kernel),
// the paper's OP_SML8 (int8 x int8 products) / OP_AD24 (integer sums)
// dataflow:
//   y[m,n] = sum_b (xq[m,b,:] . wq[n,b,:])_int32 * xs[m,b] * ws[n,b]
// over the K/32 blocks b; xq (M,K) and wq (N,K) int8, xs (M,K/32) f32, ws
// (N,K/32) fp16 (the Q8_0 tensor's scales, widened to f32).  Each block
// dot is exact in int32; each term is (float(dot) * xs) * ws in f32, as
// the reference orders it, and the terms are summed in block order in f32.
//
// What bounds it on the H100: at decode shapes the int8 weight bytes
// (8.5 bits/weight with the scales); at large M the int8 operations
// (1,979 TOP/s on the tensor cores, far less on the CUDA cores used
// here).  Design: a 64x64 output tile per block of 256 threads, each
// thread a 4x4 micro-tile (rows ty + 16i, columns tx + 16j).  Per K stage
// four Q8_0 blocks (128 int8 columns) of x and of W and their scales are
// staged in shared memory (rows padded to 132 bytes so the 16 columns a
// warp reads fall in distinct banks); each block dot is eight __dp4a of
// four int8 pairs.  A K that ends inside a stage skips the missing
// blocks.  No tensor cores (mma.sync s8) yet: simple and right first.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int TM = 64, TN = 64;
constexpr int NTHREAD = 256;
constexpr int BPS = 4;                 // Q8_0 blocks per K stage
constexpr int SK = BPS * 32;           // int8 columns per stage
constexpr int LDW = SK / 4 + 1;        // shared row stride in 32-bit words

// Rows [r0, r0 + 64) x columns [k0, k0 + SK) of an int8 matrix into dst
// (row stride LDW words); rows >= rows_total and blocks >= nblk read as 0.
__device__ __forceinline__ void stage_int8(int* dst, const int8_t* __restrict__ src,
                                           int rows_total, int K, int r0, int k0,
                                           int nblk) {
    constexpr int VEC = SK / 16;       // 16-byte pieces per row
    for (int i = threadIdx.x; i < TM * VEC; i += NTHREAD) {
        const int r = i / VEC, c = i % VEC;
        const int gr = r0 + r;
        const int kc = k0 + c * 16;
        int4 v = make_int4(0, 0, 0, 0);
        if (gr < rows_total && kc / 32 < nblk)
            v = *reinterpret_cast<const int4*>(src + (size_t)gr * K + kc);
        int* d = dst + r * LDW + c * 4;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
    }
}

__global__ void __launch_bounds__(NTHREAD)
w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const int8_t* __restrict__ wq, const __half* __restrict__ ws,
            float* __restrict__ y, int M, int N, int K) {
    __shared__ int xt[TM * LDW];
    __shared__ int wt[TN * LDW];
    __shared__ float xsc[TM][BPS];
    __shared__ float wsc[TN][BPS];

    const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int nblk = K / 32;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int b0 = 0; b0 < nblk; b0 += BPS) {
        const int k0 = b0 * 32;
        stage_int8(xt, xq, M, K, m0, k0, nblk);
        stage_int8(wt, wq, N, K, n0, k0, nblk);
        for (int i = threadIdx.x; i < TM * BPS; i += NTHREAD) {
            const int r = i / BPS, bb = i % BPS;
            const bool in = b0 + bb < nblk;
            xsc[r][bb] = (in && m0 + r < M) ? xs[(size_t)(m0 + r) * nblk + b0 + bb] : 0.0f;
            wsc[r][bb] = (in && n0 + r < N)
                             ? __half2float(ws[(size_t)(n0 + r) * nblk + b0 + bb]) : 0.0f;
        }
        __syncthreads();
        const int nb = min(BPS, nblk - b0);
        for (int bb = 0; bb < nb; ++bb) {
            int a[4][8], w[4][8];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    a[i][e] = xt[(ty + 16 * i) * LDW + bb * 8 + e];
                    w[i][e] = wt[(tx + 16 * i) * LDW + bb * 8 + e];
                }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    int dot = 0;
#pragma unroll
                    for (int e = 0; e < 8; ++e) dot = __dp4a(a[i][e], w[j][e], dot);
                    // __fmul_rn keeps each term rounded as the reference's
                    // (no contraction into the sum's FMA).
                    acc[i][j] += __fmul_rn(__fmul_rn((float)dot, xsc[ty + 16 * i][bb]),
                                           wsc[tx + 16 * j][bb]);
                }
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
            if (m < M && n < N) y[(size_t)m * N + n] = acc[i][j];
        }
}

}  // namespace

// xq: (M,K) int8, xs: (M,K/32) f32, wq: (N,K) int8, ws: (N,K/32) fp16,
// y: (M,N) f32.  K % 32 == 0; xq and wq 16-byte aligned (the wrapper
// checks both).
extern "C" int q8_matmul_w8a8_s8(const void* xq, const void* xs, const void* wq,
                                 const void* ws, void* y, int M, int N, int K,
                                 void* stream) {
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    w8a8_kernel<<<grid, NTHREAD, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
        static_cast<const int8_t*>(wq), static_cast<const __half*>(ws),
        static_cast<float*>(y), M, N, K);
    return static_cast<int>(cudaGetLastError());
}
