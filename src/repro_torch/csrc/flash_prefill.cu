// Fused paged flash-prefill of one prompt chunk for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_prefill.py :: flash_prefill_paged
// (_prefill_kernel) and flash_prefill_paged_q8 (_prefill_kernel_q8).
//   q (T,Hkv,G,hd) bf16; k_new/v_new (T,Hkv,hd) bf16; pools
//   (NB,Hkv,bs,hd) bf16, or int8 quants + f16 per-32 scales
//   (NB,Hkv,bs,hd/32); table (MB,) int32; the chunk sits at positions
//   pos0 .. pos0+T-1.  The chunk's K/V is written into its blocks in
//   place, and every query row (t, g) of head h attends to keys at
//   kpos <= pos0 + t (and kpos > pos0 + t - window) in f32 softmax;
//   out (T,Hkv,G,hd) bf16.
//
// Write/read race.  The Pallas kernel writes block j and attends to it
// in the same sequential grid step.  Here the CTAs of one head run in
// parallel, and a CTA would read rows that another CTA is writing.  So
// each call is two launches on the caller's stream: a write launch puts
// the chunk's rows (and only those rows: pos0 .. pos0+T-1) into the
// pools, then the attend launch reads every key, history and chunk
// alike, from the pools.  Stream order makes the write complete before
// any read.  The null block, blocks shared read-only by the prefix
// cache and blocks outside the table are never written, so they come
// back bit-identical.  Under Q8_0 the write requantizes each row per 32
// along hd exactly as core/quant.py::quantize_q8_0 (IEEE division and
// round-half-even, no fast math), and the attend dequantizes every key
// through bf16, as the Pallas kernel and the decode scan read the pool;
// so the chunk's own tokens are attended at their quantized values.
//
// NaN in recycled blocks.  Keys at kpos >= pos0 + T (the stale tail of
// a recycled block) are never loaded: their shared-memory rows are
// zero-filled, and their logits are set to -inf before the row max, so
// neither a NaN logit nor 0 * NaN in P.V can occur.
//
// What bounds it on the H100: at the serving shape (T = 256, G = 4,
// hd = 128, ~2k keys) each head does 4*T*G*C*hd flops against C*hd*4
// bytes of K/V read, about 1000 flops per byte: compute-bound.  Design:
// one block of 4 warps per (64 query rows of the flattened (T*G) rows,
// KV head); a loop over 64-key tiles.  K and V tiles come through the
// block table row by row; the bf16 pool streams with cp.async into a
// double buffer, the Q8_0 pool is dequantized on the way into shared
// memory.  S = Q K^T and O += P V run on the tensor cores through WMMA
// (bf16 16x16x16, f32 accumulate), with the running max and sum per row
// in registers and the f32 output tile in shared memory.  The reference
// oracle keeps P in f32; a single bf16 P (the Pallas kernel's choice)
// puts up to 2 bf16 ulps between the two outputs where P.V cancels, so
// P goes in as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi) (16
// significant bits), at the price of a second P.V product.  Key tiles past the block's
// last query position or before its window are skipped.  No wgmma/TMA
// yet.
#include <math.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int BQ = 64;     // query rows (flattened t*G + g) per block
constexpr int BKV = 64;    // keys per tile
constexpr int NWARP = 4;
constexpr int NTHREAD = NWARP * 32;
constexpr int S_LD = BKV + 4;
constexpr int P_LD = BKV + 8;
constexpr int QK = 32;     // Q8_0 block along hd

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
    m.o = m.p + 2 * (size_t)BQ * P_LD * 2;          // P as bf16 hi + lo
    m.total = m.o + (size_t)BQ * m.o_ld * 4;
    return m;
}

// Element offset of row (position kpos, head h) in a (NB,Hkv,bs,width) pool.
__device__ __forceinline__ size_t pool_row(const int* __restrict__ table, int kpos, int h,
                                           int hkv, int bs, int width) {
    const int blk = table[kpos / bs];
    return (((size_t)blk * hkv + h) * bs + kpos % bs) * width;
}

// ------------------------------------------------------------- writes

__global__ void write_bf16_kernel(const bf16* __restrict__ kn, const bf16* __restrict__ vn,
                                  bf16* __restrict__ kp, bf16* __restrict__ vp,
                                  const int* __restrict__ table, int t, int hkv, int hd,
                                  int bs, int pos0) {
    const int vec = hd / 8;                              // 16-byte pieces per row
    const int total = t * hkv * vec;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += gridDim.x * blockDim.x) {
        const int c = i % vec, row = i / vec;            // row = ti * hkv + h
        const int h = row % hkv, ti = row / hkv;
        const size_t dst = pool_row(table, pos0 + ti, h, hkv, bs, hd) + c * 8;
        const size_t src = (size_t)row * hd + c * 8;
        *reinterpret_cast<uint4*>(kp + dst) = *reinterpret_cast<const uint4*>(kn + src);
        *reinterpret_cast<uint4*>(vp + dst) = *reinterpret_cast<const uint4*>(vn + src);
    }
}

// Q8_0 of 32 bf16 values, byte for byte as core/quant.py::quantize_q8_0:
// amax -> d = amax / 127 saturated into [2^-24, 65504] (0 for a zero
// block) and rounded to f16; inv = 1 / float(d) (0 when d == 0);
// q = rint(x * inv) clipped to [-127, 127].
__device__ __forceinline__ void quantize32(const bf16* __restrict__ x, int8_t* __restrict__ q,
                                           __half* __restrict__ d) {
    float v[QK];
#pragma unroll
    for (int j = 0; j < QK / 8; ++j) {
        const uint4 raw = *reinterpret_cast<const uint4*>(x + j * 8);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[j * 8 + i] = __bfloat162float(e[i]);
    }
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < QK; ++i) amax = fmaxf(amax, fabsf(v[i]));
    float dd = 0.0f;
    if (amax > 0.0f)
        dd = fminf(fmaxf(__fdiv_rn(amax, 127.0f), 5.9604644775390625e-08f), 65504.0f);
    const __half dh = __float2half_rn(dd);
    const float df = __half2float(dh);
    const float inv = df > 0.0f ? __fdiv_rn(1.0f, df) : 0.0f;
    __align__(16) int8_t out[QK];
#pragma unroll
    for (int i = 0; i < QK; ++i) {
        const float r = fminf(fmaxf(rintf(__fmul_rn(v[i], inv)), -127.0f), 127.0f);
        out[i] = static_cast<int8_t>(static_cast<int>(r));
    }
    *reinterpret_cast<uint4*>(q) = *reinterpret_cast<const uint4*>(out);
    *reinterpret_cast<uint4*>(q + 16) = *reinterpret_cast<const uint4*>(out + 16);
    *d = dh;
}

__global__ void write_q8_kernel(const bf16* __restrict__ kn, const bf16* __restrict__ vn,
                                int8_t* __restrict__ kq, int8_t* __restrict__ vq,
                                __half* __restrict__ ks, __half* __restrict__ vs,
                                const int* __restrict__ table, int t, int hkv, int hd,
                                int bs, int pos0) {
    const int ng = hd / QK;
    const int total = t * hkv * ng;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += gridDim.x * blockDim.x) {
        const int gi = i % ng, row = i / ng;             // row = ti * hkv + h
        const int h = row % hkv, ti = row / hkv;
        const size_t prow = pool_row(table, pos0 + ti, h, hkv, bs, 1);
        const size_t src = (size_t)row * hd + gi * QK;
        quantize32(kn + src, kq + prow * hd + gi * QK, ks + prow * ng + gi);
        quantize32(vn + src, vq + prow * hd + gi * QK, vs + prow * ng + gi);
    }
}

// ------------------------------------------------------------- attend

// Key rows [k0, k0 + BKV) of head h into dst (row stride ld, dp
// columns), zero past kend and past hd.  bf16 pool: cp.async through
// the table.  Q8_0 pool: 8 quants and their scale per piece, dequantized
// as float(q) * float(d) (exact) and rounded to bf16.
template <bool Q8>
__device__ __forceinline__ void load_keys(bf16* dst, const void* __restrict__ pool,
                                          const __half* __restrict__ scales,
                                          const int* __restrict__ table, int k0, int kend,
                                          int h, int hkv, int bs, int hd, int dp, int ld) {
    const int cpr = dp / 8;
    for (int i = threadIdx.x; i < BKV * cpr; i += NTHREAD) {
        const int r = i / cpr, c8 = i - r * cpr;
        const int kp = k0 + r;
        const bool in = kp < kend && c8 * 8 < hd;
        bf16* out = dst + r * ld + c8 * 8;
        if constexpr (!Q8) {
            const bf16* base = static_cast<const bf16*>(pool);
            const bf16* src = in ? base + pool_row(table, kp, h, hkv, bs, hd) + c8 * 8 : base;
            cp_async16(out, src, in);
        } else {
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (in) {
                const size_t prow = pool_row(table, kp, h, hkv, bs, 1);
                const int8_t* qsrc = static_cast<const int8_t*>(pool) + prow * hd + c8 * 8;
                const uint2 raw = *reinterpret_cast<const uint2*>(qsrc);
                const int8_t* qv = reinterpret_cast<const int8_t*>(&raw);
                const float d = __half2float(scales[prow * (hd / QK) + (c8 * 8) / QK]);
                bf16* o = reinterpret_cast<bf16*>(&val);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    o[e] = __float2bfloat16_rn(static_cast<float>(qv[e]) * d);
            }
            *reinterpret_cast<uint4*>(out) = val;
        }
    }
}

template <bool Q8>
__global__ void __launch_bounds__(NTHREAD)
attend_kernel(const bf16* __restrict__ q, const void* __restrict__ kpool,
              const void* __restrict__ vpool, const __half* __restrict__ kscale,
              const __half* __restrict__ vscale, const int* __restrict__ table,
              bf16* __restrict__ out, int t, int hkv, int g, int hd, int dp, int bs,
              int pos0, float scale, int window) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Smem L = smem_layout(dp);
    const int ld = L.ld, o_ld = L.o_ld;
    bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
    bf16* kbuf = reinterpret_cast<bf16*>(smem + L.k);
    bf16* vbuf = reinterpret_cast<bf16*>(smem + L.v);
    float* ss = reinterpret_cast<float*>(smem + L.s);
    bf16* ps = reinterpret_cast<bf16*>(smem + L.p);
    float* os = reinterpret_cast<float*>(smem + L.o);

    const int h = blockIdx.y;
    const int q0 = blockIdx.x * BQ;
    const int nrows = t * g;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

    // Keys any row of this block can see: [kstart, kend).
    const int kend = pos0 + (min(q0 + BQ, nrows) - 1) / g + 1;
    const int kstart = window > 0 ? max(0, pos0 + q0 / g - window + 1) : 0;

    // Q rows: flattened row r = ti * g + gi lives at q[ti, h, gi, :].
    {
        const int cpr = dp / 8;
        for (int i = tid; i < BQ * cpr; i += NTHREAD) {
            const int r = i / cpr, c8 = i - r * cpr;
            const int gr = q0 + r;
            const bool in = gr < nrows && c8 * 8 < hd;
            const bf16* src = in ? q + (((size_t)(gr / g) * hkv + h) * g + gr % g) * hd + c8 * 8 : q;
            cp_async16(qs + r * ld + c8 * 8, src, in);
        }
    }
    if (kstart < kend) {
        load_keys<Q8>(kbuf, kpool, kscale, table, kstart, kend, h, hkv, bs, hd, dp, ld);
        load_keys<Q8>(vbuf, vpool, vscale, table, kstart, kend, h, hkv, bs, hd, dp, ld);
    }
    cp_async_commit();
    for (int i = tid; i < BQ * o_ld; i += NTHREAD) os[i] = 0.0f;

    // Row `row` is held by lanes 2r and 2r+1 of its warp; lane `half`
    // owns the tile's columns half, half+2, ...
    const int row = warp * 16 + (lane >> 1);
    const int half = lane & 1;
    const int qpos = pos0 + (q0 + row) / g;
    float m_i = -INFINITY, l_i = 0.0f;
    const size_t kv_elems = (size_t)BKV * ld;

    int buf = 0;
    for (int k0 = kstart; k0 < kend; k0 += BKV, buf ^= 1) {
        if (k0 + BKV < kend) {
            load_keys<Q8>(kbuf + (buf ^ 1) * kv_elems, kpool, kscale, table, k0 + BKV, kend,
                          h, hkv, bs, hd, dp, ld);
            load_keys<Q8>(vbuf + (buf ^ 1) * kv_elems, vpool, vscale, table, k0 + BKV, kend,
                          h, hkv, bs, hd, dp, ld);
        }
        cp_async_commit();
        cp_async_wait_prev();
        __syncthreads();
        const bf16* ks = kbuf + buf * kv_elems;
        const bf16* vs = vbuf + buf * kv_elems;

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

        float* srow = ss + row * S_LD;
        bf16* prow = ps + row * P_LD;
        float mx = -INFINITY;
#pragma unroll 8
        for (int i = 0; i < BKV / 2; ++i) {
            const int c = 2 * i + half;
            const int kp = k0 + c;
            bool ok = kp < kend && kp <= qpos;
            if (window > 0) ok = ok && kp > qpos - window;
            const float s = ok ? srow[c] * scale : -INFINITY;
            srow[c] = s;
            mx = fmaxf(mx, s);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_new = fmaxf(m_i, mx);
        const bool empty = m_new == -INFINITY;
        const float alpha = empty ? 1.0f : expf(m_i - m_new);
        float lsum = 0.0f;
#pragma unroll 8
        for (int i = 0; i < BKV / 2; ++i) {
            const int c = 2 * i + half;
            const float p = empty ? 0.0f : expf(srow[c] - m_new);
            lsum += p;
            const bf16 hi = __float2bfloat16(p);
            prow[c] = hi;
            prow[BQ * P_LD + c] = __float2bfloat16(p - __bfloat162float(hi));
        }
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
        l_i = l_i * alpha + lsum;
        m_i = m_new;
        float* orow = os + row * o_ld;
        for (int c = half; c < dp; c += 2) orow[c] *= alpha;
        __syncwarp();

        for (int j = 0; j < dp / 16; ++j) {
            FragC acc;
            wmma::load_matrix_sync(acc, os + warp * 16 * o_ld + j * 16, o_ld,
                                   wmma::mem_row_major);
#pragma unroll
            for (int kk = 0; kk < BKV; kk += 16) {
                FragA a;
                FragBRow b;
                wmma::load_matrix_sync(b, vs + kk * ld + j * 16, ld);
                wmma::load_matrix_sync(a, ps + warp * 16 * P_LD + kk, P_LD);
                wmma::mma_sync(acc, a, b, acc);
                wmma::load_matrix_sync(a, ps + BQ * P_LD + warp * 16 * P_LD + kk, P_LD);
                wmma::mma_sync(acc, a, b, acc);
            }
            wmma::store_matrix_sync(os + warp * 16 * o_ld + j * 16, acc, o_ld,
                                    wmma::mem_row_major);
        }
        __syncthreads();
    }
    cp_async_wait_all();
    __syncthreads();

    const int gr = q0 + row;
    if (gr < nrows) {
        const float* orow = os + row * o_ld;
        bf16* dst = out + (((size_t)(gr / g) * hkv + h) * g + gr % g) * hd;
        for (int c = half; c < hd; c += 2)
            dst[c] = __float2bfloat16(l_i > 0.0f ? orow[c] / l_i : 0.0f);
    }
}

template <bool Q8>
int launch_attend(const void* q, const void* kpool, const void* vpool, const void* kscale,
                  const void* vscale, const void* table, void* out, int t, int hkv, int g,
                  int hd, int bs, int pos0, float scale, int window, cudaStream_t stream) {
    const int dp = (hd + 15) / 16 * 16;
    const size_t smem = smem_layout(dp).total;
    cudaError_t err = cudaFuncSetAttribute(attend_kernel<Q8>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((t * g + BQ - 1) / BQ, hkv);
    attend_kernel<Q8><<<grid, NTHREAD, smem, stream>>>(
        static_cast<const bf16*>(q), kpool, vpool, static_cast<const __half*>(kscale),
        static_cast<const __half*>(vscale), static_cast<const int*>(table),
        static_cast<bf16*>(out), t, hkv, g, hd, dp, bs, pos0, scale, window);
    return static_cast<int>(cudaGetLastError());
}

int write_grid(int pieces) {
    const int blocks = (pieces + 255) / 256;
    return blocks < 1024 ? blocks : 1024;
}

}  // namespace

// bf16 pools.  q (T,Hkv,G,hd), k_new/v_new (T,Hkv,hd), pools
// (NB,Hkv,bs,hd), out (T,Hkv,G,hd): bf16, contiguous, 16-byte aligned;
// table (MB,) int32 with pos0 + T <= MB * bs.  hd % 8 == 0, hd <= 192.
// window <= 0 means no window.  Writes the chunk into the pools in place.
extern "C" int flash_prefill_paged_bf16(const void* q, const void* k_new, const void* v_new,
                                        void* k_pool, void* v_pool, const void* table,
                                        void* out, int t, int hkv, int g, int hd, int bs,
                                        int pos0, float scale, int window, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    write_bf16_kernel<<<write_grid(t * hkv * (hd / 8)), 256, 0, st>>>(
        static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
        static_cast<bf16*>(k_pool), static_cast<bf16*>(v_pool),
        static_cast<const int*>(table), t, hkv, hd, bs, pos0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_attend<false>(q, k_pool, v_pool, nullptr, nullptr, table, out, t, hkv, g,
                                hd, bs, pos0, scale, window, st);
}

// Q8_0 pools: kq/vq (NB,Hkv,bs,hd) int8, ks/vs (NB,Hkv,bs,hd/32) f16;
// k_new/v_new bf16 (requantized here).  hd % 32 == 0, hd <= 192.
extern "C" int flash_prefill_paged_q8(const void* q, const void* k_new, const void* v_new,
                                      void* kq_pool, void* vq_pool, void* ks_pool,
                                      void* vs_pool, const void* table, void* out, int t,
                                      int hkv, int g, int hd, int bs, int pos0, float scale,
                                      int window, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    write_q8_kernel<<<write_grid(t * hkv * (hd / QK)), 256, 0, st>>>(
        static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
        static_cast<int8_t*>(kq_pool), static_cast<int8_t*>(vq_pool),
        static_cast<__half*>(ks_pool), static_cast<__half*>(vs_pool),
        static_cast<const int*>(table), t, hkv, hd, bs, pos0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_attend<true>(q, kq_pool, vq_pool, ks_pool, vs_pool, table, out, t, hkv, g,
                               hd, bs, pos0, scale, window, st);
}
