// Shared pieces of the port's CUDA kernels (sm_90a, plain C interface).
//
// Every entry point is `extern "C"`, takes raw device pointers and the
// caller's cudaStream_t, allocates nothing, and returns
// cudaGetLastError() as an int so the Python wrapper can raise on it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace repro {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

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

// c(16x8, f32) += a(16x16, bf16, row) b(16x8, bf16, col).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// ---------------------------------------------------------------------
// Dequant-GEMM skeleton shared by q8_matmul.cu and q3k_matmul.cu:
//   y(M,N) f32 = x(M,K) bf16 @ W(N,K)^T,  W dequantized tile by tile.
// A block owns a GEMM_BM x GEMM_BN output tile; its 4 warps own 32x32
// quarters (2x2 WMMA fragments each).  Each K step stages a GEMM_BM x BK
// slice of x and a GEMM_BN x BK slice of W (dequantized to bf16 by the
// format's loader) in shared memory; the dequantized weight never
// reaches device memory.  K must be a multiple of BK (the block size of
// the format divides BK), so there is no K tail; M and N edges are
// zero-filled on load and masked on store.
constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_THREADS = 128;

// Stage rows [m0, m0+GEMM_BM) x cols [k0, k0+BK) of x into xs (row-major,
// leading dimension BK) with 16-byte loads; rows >= M read as zero.
template <int BK>
__device__ __forceinline__ void load_x_tile(const bf16* __restrict__ x, bf16* xs,
                                            int M, int K, int m0, int k0) {
    constexpr int VEC_PER_ROW = BK / 8;
    for (int i = threadIdx.x; i < GEMM_BM * VEC_PER_ROW; i += GEMM_THREADS) {
        const int r = i / VEC_PER_ROW, c8 = i % VEC_PER_ROW;
        const int gr = m0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (gr < M)
            val = *reinterpret_cast<const uint4*>(x + (size_t)gr * K + k0 + c8 * 8);
        *reinterpret_cast<uint4*>(xs + r * BK + c8 * 8) = val;
    }
}

// acc[i][j] += xs(warp rows) @ ws(warp cols)^T over one BK slice.
template <int BK>
__device__ __forceinline__ void mma_tile(const bf16* xs, const bf16* ws,
                                         FragC (&acc)[2][2], int wm, int wn) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
        FragA a[2];
        FragBCol b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], xs + (wm * 32 + i * 16) * BK + kk, BK);
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(b[j], ws + (wn * 32 + j * 16) * BK + kk, BK);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
}

// Write the block's accumulators to y through shared memory `cs`
// (GEMM_BM x GEMM_BN floats), masking rows >= M and cols >= N.
__device__ __forceinline__ void store_tile(FragC (&acc)[2][2], float* cs,
                                           float* __restrict__ y, int M, int N,
                                           int m0, int n0, int wm, int wn) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * GEMM_BN + wn * 32 + j * 16,
                                    acc[i][j], GEMM_BN, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < GEMM_BM * GEMM_BN; i += GEMM_THREADS) {
        const int r = i / GEMM_BN, c = i % GEMM_BN;
        if (m0 + r < M && n0 + c < N) y[(size_t)(m0 + r) * N + n0 + c] = cs[i];
    }
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
