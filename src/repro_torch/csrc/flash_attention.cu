// Online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention
// (_flash_kernel).  q: (BH,Sq,D), k/v: (BH,Sk,D), bf16 in, bf16 out.
//   logits = (q . k) * scale  in f32; causal mask bottom-right aligned
//   (kpos <= qpos + Sk - Sq); optional window (kpos > qpos + Sk - Sq - W);
//   keys past Sk masked for any Sk; p = exp(logits - m) in f32, rounded to
//   bf16 for the P.V product (as the Pallas kernel does), f32 accumulate;
//   out = acc / l, and rows with no unmasked key give 0.
//
// What bounds it on the H100: at the UNet's Sq = Sk = 4096 and head dims
// 40/80/160 the work is the two products (4*Sq*Sk*D flops per head) and
// the exp of every logit; the bytes (q, k, v, out once each) are small,
// so it is compute-bound.  Design: one block of 4 warps per (b*h,
// 64-query tile); each warp owns 16 query rows.  A loop over 64-key
// tiles replaces the Pallas kernel's sequential third grid axis.  K and
// V tiles are double-buffered in shared memory with cp.async (16-byte
// copies, zero-filled past Sk and past D), so the next tile streams in
// while the current one is used.  S = Q K^T and O += P V run on the
// tensor cores through WMMA (bf16 16x16x16, f32 accumulate); the running
// max m and sum l live in registers (two lanes per row, interleaved
// columns); the f32 output accumulator lives in shared memory so it can
// be rescaled by exp(m_old - m_new) per row.  Shared-memory rows are
// padded to spread banks.  D is padded to a multiple of 16 with zeros,
// which leaves q.k and P.V unchanged.  Key tiles past the causal
// diagonal or before the window are skipped.  No wgmma/TMA yet.
#include <math.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int BQ = 64;     // query rows per block (16 per warp)
constexpr int BKV = 64;    // keys per tile
constexpr int NWARP = 4;
constexpr int NTHREAD = NWARP * 32;
constexpr int S_LD = BKV + 4;   // f32 score row stride
constexpr int P_LD = BKV + 8;   // bf16 probability row stride

// Shared-memory carve-up for padded head dim dp: Q, K[2], V[2] (bf16,
// row stride dp + 8), S (f32), P (bf16), O (f32, row stride dp + 4).
struct Smem {
    int ld, o_ld;
    size_t q, k, v, s, p, o, total;
};

__host__ __device__ inline Smem smem_layout(int dp) {
    Smem m;
    m.ld = dp + 8;
    m.o_ld = dp + 4;
    const size_t q_bytes = (size_t)BQ * m.ld * 2, kv_bytes = (size_t)BKV * m.ld * 2;
    m.q = 0;
    m.k = m.q + q_bytes;
    m.v = m.k + 2 * kv_bytes;
    m.s = m.v + 2 * kv_bytes;
    m.p = m.s + (size_t)BQ * S_LD * 4;
    m.o = m.p + (size_t)BQ * P_LD * 2;
    m.total = m.o + (size_t)BQ * m.o_ld * 4;
    return m;
}

// Rows [row0, row0+rows) of a (n, d) bf16 matrix into dst (row stride
// ld, dp columns), zero past n and past d.  With vec (d % 8 == 0) the
// copy is asynchronous (cp.async); otherwise element by element.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src,
                                          int row0, int rows, int n, int d, int dp,
                                          int ld, bool vec) {
    if (vec) {
        const int cpr = dp / 8;
        for (int i = threadIdx.x; i < rows * cpr; i += NTHREAD) {
            const int r = i / cpr, c8 = i - r * cpr;
            const int gr = row0 + r;
            const bool in = gr < n && c8 * 8 < d;
            cp_async16(dst + r * ld + c8 * 8, in ? src + (size_t)gr * d + c8 * 8 : src, in);
        }
    } else {
        const bf16 zero = __float2bfloat16(0.0f);
        for (int i = threadIdx.x; i < rows * dp; i += NTHREAD) {
            const int r = i / dp, c = i - r * dp;
            const int gr = row0 + r;
            dst[r * ld + c] = (gr < n && c < d) ? src[(size_t)gr * d + c] : zero;
        }
    }
}

__global__ void __launch_bounds__(NTHREAD)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int sq, int sk, int d, int dp, float scale,
                       int causal, int window) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Smem L = smem_layout(dp);
    const int ld = L.ld, o_ld = L.o_ld;
    bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
    bf16* kbuf = reinterpret_cast<bf16*>(smem + L.k);
    bf16* vbuf = reinterpret_cast<bf16*>(smem + L.v);
    float* ss = reinterpret_cast<float*>(smem + L.s);
    bf16* ps = reinterpret_cast<bf16*>(smem + L.p);
    float* os = reinterpret_cast<float*>(smem + L.o);

    const int q0 = blockIdx.x * BQ;
    const bf16* qb = q + (size_t)blockIdx.y * sq * d;
    const bf16* kb = k + (size_t)blockIdx.y * sk * d;
    const bf16* vb = v + (size_t)blockIdx.y * sk * d;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int offset = sk - sq;              // bottom-right causal alignment
    const bool vec = (d % 8) == 0;

    // Keys any row of this block can see.
    int kend = sk;
    if (causal) kend = min(sk, min(q0 + BQ, sq) - 1 + offset + 1);
    int kstart = 0;
    if (window > 0) kstart = max(0, q0 + offset - window + 1);

    load_rows(qs, qb, q0, BQ, sq, d, dp, ld, vec);
    if (kstart < kend) {
        load_rows(kbuf, kb, kstart, BKV, sk, d, dp, ld, vec);
        load_rows(vbuf, vb, kstart, BKV, sk, d, dp, ld, vec);
    }
    cp_async_commit();
    for (int i = tid; i < BQ * o_ld; i += NTHREAD) os[i] = 0.0f;

    // Softmax state of row `row`, held by lanes 2r and 2r+1 of its warp;
    // lane `half` owns the tile's columns half, half+2, half+4, ...
    const int row = warp * 16 + (lane >> 1);
    const int half = lane & 1;
    const int qpos = q0 + row;
    float m_i = -INFINITY, l_i = 0.0f;
    const size_t kv_elems = (size_t)BKV * ld;

    int buf = 0;
    for (int k0 = kstart; k0 < kend; k0 += BKV, buf ^= 1) {
        // Prefetch the next tile into the other buffer (it was last read
        // in the previous iteration, which ended with a barrier).
        if (k0 + BKV < kend) {
            load_rows(kbuf + (buf ^ 1) * kv_elems, kb, k0 + BKV, BKV, sk, d, dp, ld, vec);
            load_rows(vbuf + (buf ^ 1) * kv_elems, vb, k0 + BKV, BKV, sk, d, dp, ld, vec);
        }
        cp_async_commit();
        cp_async_wait_prev();                // this tile (and Q) has landed
        __syncthreads();
        const bf16* ks = kbuf + buf * kv_elems;
        const bf16* vs = vbuf + buf * kv_elems;

        // S(16 x BKV) = Q(16 x dp) K^T for this warp's rows.
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
            FragC acc;
            wmma::fill_fragment(acc, 0.0f);
            for (int kk = 0; kk < dp; kk += 16) {
                FragA a;
                FragBCol b;
                wmma::load_matrix_sync(a, qs + warp * 16 * ld + kk, ld);
                wmma::load_matrix_sync(b, ks + j * 16 * ld + kk, ld);
                wmma::mma_sync(acc, a, b, acc);
            }
            wmma::store_matrix_sync(ss + warp * 16 * S_LD + j * 16, acc, S_LD,
                                    wmma::mem_row_major);
        }
        __syncwarp();

        // Online softmax over this lane's 32 columns of the row.
        float* srow = ss + row * S_LD;
        bf16* prow = ps + row * P_LD;
        float mx = -INFINITY;
#pragma unroll 8
        for (int i = 0; i < BKV / 2; ++i) {
            const int c = 2 * i + half;
            const int kp = k0 + c;
            bool ok = kp < sk;
            if (causal) ok = ok && kp <= qpos + offset;
            if (window > 0) ok = ok && kp > qpos + offset - window;
            const float s = ok ? srow[c] * scale : -INFINITY;
            srow[c] = s;
            mx = fmaxf(mx, s);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_new = fmaxf(m_i, mx);
        const bool empty = m_new == -INFINITY;   // no unmasked key yet
        const float alpha = empty ? 1.0f : expf(m_i - m_new);
        float lsum = 0.0f;
#pragma unroll 8
        for (int i = 0; i < BKV / 2; ++i) {
            const int c = 2 * i + half;
            const float p = empty ? 0.0f : expf(srow[c] - m_new);
            lsum += p;
            prow[c] = __float2bfloat16(p);
        }
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
        l_i = l_i * alpha + lsum;
        m_i = m_new;
        float* orow = os + row * o_ld;
        for (int c = half; c < dp; c += 2) orow[c] *= alpha;
        __syncwarp();

        // O(16 x dp) += P(16 x BKV) V(BKV x dp).
        for (int j = 0; j < dp / 16; ++j) {
            FragC acc;
            wmma::load_matrix_sync(acc, os + warp * 16 * o_ld + j * 16, o_ld,
                                   wmma::mem_row_major);
#pragma unroll
            for (int kk = 0; kk < BKV; kk += 16) {
                FragA a;
                FragBRow b;
                wmma::load_matrix_sync(a, ps + warp * 16 * P_LD + kk, P_LD);
                wmma::load_matrix_sync(b, vs + kk * ld + j * 16, ld);
                wmma::mma_sync(acc, a, b, acc);
            }
            wmma::store_matrix_sync(os + warp * 16 * o_ld + j * 16, acc, o_ld,
                                    wmma::mem_row_major);
        }
        __syncthreads();                     // K/V[buf] free for the prefetch
    }
    cp_async_wait_all();
    __syncthreads();                         // O zeroed by all, if no tile ran

    if (qpos < sq) {
        const float* orow = os + row * o_ld;
        bf16* out = o + (size_t)blockIdx.y * sq * d + (size_t)qpos * d;
        for (int c = half; c < d; c += 2)
            out[c] = __float2bfloat16(l_i > 0.0f ? orow[c] / l_i : 0.0f);
    }
}

}  // namespace

// q: (BH,Sq,D), k/v: (BH,Sk,D), o: (BH,Sq,D), bf16, contiguous, 16-byte
// aligned.  window <= 0 means no window.  D <= 192.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int bh, int sq, int sk, int d, float scale,
                                    int causal, int window, void* stream) {
    const int dp = (d + 15) / 16 * 16;
    const size_t smem = smem_layout(dp).total;
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((sq + BQ - 1) / BQ, bh);
    flash_attention_kernel<<<grid, NTHREAD, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk, d, dp, scale,
        causal, window);
    return static_cast<int>(cudaGetLastError());
}
