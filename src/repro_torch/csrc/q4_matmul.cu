// Fused-unpack Q4_0 matmul for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/q4_matmul.py :: q4_matmul (_q4_kernel).
//   y(M,N) f32 = x(M,K) bf16 @ W(N,K)^T,
//   W[n,k] = bf16((nibble(qs[n,k/2], k%2) - 8) * d[n,k/32]),
//   byte j of a row holding elements 2j (low nibble) and 2j+1 (high
//   nibble), d the fp16 block scales of the Q4_0 tensor widened to f32.
//   Each weight is rounded to bf16 before the product, as the Pallas
//   kernel does; products accumulate in f32.
//
// What bounds it on the H100: at decode (M = 1..4) and at CLIP's M = 154
// the weight bytes (4.5 bits/weight) set the time; at the UNet's M =
// B*h*w the tensor cores do.  Design: the q8_matmul skeleton of
// common.cuh with a nibble unpack in the weight loader.  Only the packed
// codes and one fp16 scale per 32 weights are read from device memory;
// each 64x32 weight slice is unpacked in registers into shared memory
// and fed to the tensor cores through WMMA (bf16 16x16x16, f32
// accumulate).  BK = 32 is one Q4_0 block, so one scale covers a
// thread's 16 weights (8 bytes).  No cp.async/TMA pipelining and no
// wgmma yet: simple and right first.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int BK = 32;   // one Q4_0 block per K step

__global__ void __launch_bounds__(GEMM_THREADS)
q4_matmul_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ qs,
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
    const size_t row_bytes = (size_t)K / 2;

    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    // Weight loader: thread t unpacks the 16 weights [wh*16, wh*16+16) of
    // the block in row n = t/2, i.e. the 8 bytes [wh*8, wh*8+8).
    const int wn_row = threadIdx.x >> 1;
    const int wh = threadIdx.x & 1;
    const int gn = n0 + wn_row;

    for (int kb = 0; kb < nblk; ++kb) {
        const int k0 = kb * BK;
        load_x_tile<BK>(x, xs, M, K, m0, k0);
        bf16* dst = ws + wn_row * BK + wh * 16;
        if (gn < N) {
            const uint2 raw = *reinterpret_cast<const uint2*>(
                qs + (size_t)gn * row_bytes + kb * (BK / 2) + wh * 8);
            const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
            const float s = __half2float(wd[(size_t)gn * nblk + kb]);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                dst[2 * e] = __float2bfloat16((float)((int)(b[e] & 0x0F) - 8) * s);
                dst[2 * e + 1] = __float2bfloat16((float)((int)(b[e] >> 4) - 8) * s);
            }
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

// x: (M,K) bf16, qs: (N,K/2) uint8, wd: (N,K/32) fp16, y: (M,N) f32.
// K % 32 == 0; x 16-byte and qs 8-byte aligned (the wrapper checks both).
extern "C" int q4_matmul_bf16(const void* x, const void* qs, const void* wd, void* y,
                              int M, int N, int K, void* stream) {
    dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
    q4_matmul_kernel<<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const uint8_t*>(qs),
        static_cast<const __half*>(wd), static_cast<float*>(y), M, N, K);
    return static_cast<int>(cudaGetLastError());
}
