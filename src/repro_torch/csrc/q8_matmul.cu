// Fused-dequant Q8_0 matmul for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/q8_matmul.py :: q8_matmul (_dequant_kernel).
//   y(M,N) f32 = x(M,K) bf16 @ W(N,K)^T,  W[n,k] = bf16(qs[n,k] * d[n,k/32]),
//   d the fp16 block scales of the Q8_0 tensor, widened to f32.
//   Each weight is rounded to bf16 before the product, as the Pallas
//   kernel does; products accumulate in f32.
//
// What bounds it on the H100: at the UNet's M = B*h*w (up to 8192 rows)
// the product is compute-bound on the tensor cores; at CLIP's M = 154 or
// at decode (M = 1) it is bound by the weight bytes (8.5 bits/weight).
// Design: only int8 quants and one fp16 scale per 32 weights are read
// from device memory; each 64x32 weight slice is dequantized in
// registers into shared memory and fed to the tensor cores through WMMA
// (bf16 16x16x16, f32 accumulate).  BK = 32 is exactly one Q8_0 block,
// so one scale covers a thread's 16 weights.  This first version has no
// cp.async/TMA pipelining and no wgmma: it is simple and right first.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int BK = 32;   // one Q8_0 block per K step

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

}  // namespace

// x: (M,K) bf16, wq: (N,K) int8, wd: (N,K/32) fp16, y: (M,N) f32.
// K % 32 == 0; x and wq 16-byte aligned (the wrapper checks both).
extern "C" int q8_matmul_bf16(const void* x, const void* wq, const void* wd, void* y,
                              int M, int N, int K, void* stream) {
    dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
    q8_matmul_kernel<<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
        static_cast<const __half*>(wd), static_cast<float*>(y), M, N, K);
    return static_cast<int>(cudaGetLastError());
}
