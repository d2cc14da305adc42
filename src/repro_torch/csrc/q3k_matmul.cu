// Fused-unpack Q3_K matmul for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/q3k_matmul.py :: q3k_matmul (_q3k_kernel).
//   y(M,N) f32 = x(M,K) bf16 @ W(N,K)^T with
//   q[n,k]  = (ql 2-bit | qh 1-bit << 2) - 4  in [-4, 3],
//   W[n,k]  = bf16(q * (d[n,k/256] * (sc[n,k/16] - 32))),
//   sc[n,k/16] the 6-bit sub-block code, read straight from the packed
//   12-byte groups of the Q3_K tensor (four codes per three bytes,
//   little-endian; the reference's wrapper unpacks them first), and d the
//   fp16 super-block scale widened to f32.
//
// What bounds it on the H100: the UNet's large-M products are
// compute-bound on the tensor cores; small M (CLIP, decode) is bound by
// the 3.4375 bits/weight of packed storage.  Design: only the packed
// bytes (ql, qh, 12 scale bytes and one fp16 scale per 256) are read;
// each 64x64 weight slice is unpacked and scaled in registers into shared memory
// and fed to the tensor cores through WMMA (bf16, f32 accumulate).
// BK = 64 keeps a thread's 32 weights inside one super-block.  No
// cp.async/TMA pipelining and no wgmma yet: simple and right first.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int BK = 64;

__global__ void __launch_bounds__(GEMM_THREADS)
q3k_matmul_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ ql,
                  const uint8_t* __restrict__ qh, const uint8_t* __restrict__ scales,
                  const __half* __restrict__ d, float* __restrict__ y,
                  int M, int N, int K) {
    __shared__ __align__(128) bf16 xs[GEMM_BM * BK];
    __shared__ __align__(128) bf16 ws[GEMM_BN * BK];
    __shared__ __align__(128) float cs[GEMM_BM * GEMM_BN];

    const int n0 = blockIdx.x * GEMM_BN;
    const int m0 = blockIdx.y * GEMM_BM;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 1, wn = warp & 1;

    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    // Weight loader: thread t unpacks 32 weights of row n = t/2.
    const int wn_row = threadIdx.x >> 1;
    const int wh = threadIdx.x & 1;
    const int gn = n0 + wn_row;
    const size_t row_ql = (size_t)gn * (K / 4);
    const size_t row_qh = (size_t)gn * (K / 8);
    const size_t row_d = (size_t)gn * (K / 256);

    for (int k0 = 0; k0 < K; k0 += BK) {
        load_x_tile<BK>(x, xs, M, K, m0, k0);
        bf16* dst = ws + wn_row * BK + wh * 32;
        if (gn < N) {
            const int kb = k0 + wh * 32;               // first weight of this thread
            const int sb = kb / 256;                   // super-block
            const int j = (kb % 256) / 16;              // first of two sub-blocks
            const float dv = __half2float(d[row_d + sb]);
            const uint8_t* g = scales + (row_d + sb) * 12 + (j / 4) * 3;
            const unsigned word = g[0] | (g[1] << 8) | (g[2] << 16);
            const int sh = 6 * (j % 4);                 // j even: j, j+1 share a group
            const float eff0 = dv * ((float)((word >> sh) & 63u) - 32.0f);
            const float eff1 = dv * ((float)((word >> (sh + 6)) & 63u) - 32.0f);
            uint8_t lo[8], hi[4];
#pragma unroll
            for (int b = 0; b < 8; ++b) lo[b] = ql[row_ql + kb / 4 + b];
#pragma unroll
            for (int b = 0; b < 4; ++b) hi[b] = qh[row_qh + kb / 8 + b];
#pragma unroll
            for (int e = 0; e < 32; ++e) {
                const int low = (lo[e >> 2] >> (2 * (e & 3))) & 3;
                const int h = (hi[e >> 3] >> (e & 7)) & 1;
                const int q = (low | (h << 2)) - 4;
                dst[e] = __float2bfloat16((float)q * (e < 16 ? eff0 : eff1));
            }
        } else {
#pragma unroll
            for (int e = 0; e < 32; ++e) dst[e] = __float2bfloat16(0.0f);
        }
        __syncthreads();
        mma_tile<BK>(xs, ws, acc, wm, wn);
        __syncthreads();
    }
    store_tile(acc, cs, y, M, N, m0, n0, wm, wn);
}

}  // namespace

// x: (M,K) bf16; ql: (N,K/4) u8; qh: (N,K/8) u8; scales: (N,K/256,12) u8
// packed codes; d: (N,K/256) fp16; y: (M,N) f32.  K % 256 == 0; x
// 16-byte aligned.
extern "C" int q3k_matmul_bf16(const void* x, const void* ql, const void* qh,
                               const void* scales, const void* d, void* y,
                               int M, int N, int K, void* stream) {
    dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
    q3k_matmul_kernel<<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const uint8_t*>(ql),
        static_cast<const uint8_t*>(qh), static_cast<const uint8_t*>(scales),
        static_cast<const __half*>(d), static_cast<float*>(y), M, N, K);
    return static_cast<int>(cudaGetLastError());
}
