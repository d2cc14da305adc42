// Flash-decode (one new token per row, GQA) for Hopper (sm_90a): the
// paged entry and the contiguous entry share the three kernels below,
// templated on how a key's row is addressed.
//
// Replaces: src/repro/kernels/flash_decode.py :: flash_decode_paged
// (_paged_decode_kernel) and :: flash_decode (_decode_kernel).
//
// Paged (flash_decode_paged_bf16): q (B,Hkv,G,hd) bf16; pools
// (NB,Hkv,bs,hd) bf16; tables (B,MB) int32; positions (B,) int32, the
// last valid logical index of each row (inclusive).  Row b's query group
// attends to the keys at idx <= positions[b] (and idx > positions[b] -
// window) of its table.
// Contiguous (flash_decode_bf16): k/v (B,Hkv,C,hd) bf16 and kv_len (1,)
// int32 on the card, read by the kernels themselves (no host sync): every
// row attends to the slots idx < kv_len[0].  It is the paged layout with
// one block of C rows per row (block b of row b).
//
// Both compute what the reference's decode step computes when it reads a
// bf16 cache (models/attention.py: _update_read_paged /
// _update_read_contiguous and the einsums of attention_decode): logits
// q.k * scale in f32, softmax in f32, the normalised probabilities
// rounded to bf16, P.V summed in f32; out (B,Hkv,G,hd) bf16.  (The Pallas
// kernels round the unnormalised p instead; the port follows the path it
// replaces.)  Keys past the valid range (a recycled block's stale bytes,
// the null block of an idle row, unwritten cache slots) are never
// loaded: their rows are zero-filled and their logits are -inf before
// any max.
//
// What bounds it on the H100: each (row, head) reads its whole cache
// (2 * C * hd * 2 bytes) for 4 * G * C * hd flops, 4 flops per byte at
// G = 4: memory-bound, so the aim is to keep every SM streaming.  At 4
// rows one block per (row, KV head) would be 32 blocks and leave 100 of
// the 132 SMs idle, so the key range is split into 128-key pieces, one
// block per (split, KV head, row), in three launches:
//   1. logits: stage the split's keys with cp.async (16-byte pieces),
//      G x 128 logits into a scratch row, and the split's max m_s and sum
//      l_s = sum exp(s - m_s);
//   2. P.V: each block merges the splits' (m_s, l_s) of its row into the
//      row's max M and sum L, forms p = bf16(exp(s - M) / L) (the
//      normalised, rounded probabilities of the reference), stages its
//      values and writes a partial P.V;
//   3. sum: the partials of each (row, head), added in f32.
// The logits scratch adds 16 bytes per key and query group to the 512
// of K and V.  Splits wholly outside the valid range exit at once and
// are skipped.  Plain FMA arithmetic on CUDA cores: with G = 4 query
// rows a tensor-core tile would be 3/4 padding, and the bytes, not the
// flops, set the time.
#include <math.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int KEYS = 128;        // keys per split (one per thread)
constexpr int NTHREAD = 128;
constexpr int MAX_G = 16;

// Shared memory of passes 1 and 2: one bf16 K or V tile (row stride hd + 8,
// a 16-byte multiple that spreads the banks) and G x KEYS f32 scores.
struct Smem {
    int ld;
    size_t kv, s, q, total;
};

__host__ __device__ inline Smem smem_layout(int hd, int g) {
    Smem m;
    m.ld = hd + 8;
    m.kv = 0;
    m.s = m.kv + (size_t)KEYS * m.ld * 2;
    m.q = m.s + (size_t)g * KEYS * 4;
    m.total = m.q + (size_t)g * hd * 4;
    return m;
}

struct Split {
    int k0, pos, kmin;
    __device__ bool empty() const { return k0 > pos || k0 + KEYS <= kmin; }
    __device__ bool valid(int kp, int limit) const {
        return kp <= pos && kp >= kmin && kp < limit;
    }
};

// PAGED: positions[b] is row b's last valid index; contiguous: positions
// is kv_len, the same count of valid slots for every row.
template <bool PAGED>
__device__ __forceinline__ Split split_of(const int* __restrict__ positions, int b,
                                          int split, int window) {
    Split s;
    s.k0 = split * KEYS;
    s.pos = PAGED ? positions[b] : positions[0] - 1;
    s.kmin = window > 0 ? max(0, s.pos - window + 1) : 0;
    return s;
}

// Rows [k0, k0 + KEYS) of head h of row b into dst, zero where invalid.
// Contiguous: bs = C, mb = 1 and row b is block b (no table).
template <bool PAGED>
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ pool,
                                      const int* __restrict__ table, const Split& sp,
                                      int b, int h, int hkv, int hd, int bs, int mb, int ld) {
    const int vec = hd / 8;
    for (int i = threadIdx.x; i < KEYS * vec; i += NTHREAD) {
        const int r = i / vec, c8 = i - r * vec;
        const int kp = sp.k0 + r;
        const bool in = sp.valid(kp, mb * bs);
        size_t off = 0;
        if (in) {
            const size_t blk = PAGED ? (size_t)table[kp / bs] : (size_t)b;
            off = ((blk * hkv + h) * bs + kp % bs) * hd + c8 * 8;
        }
        cp_async16(dst + r * ld + c8 * 8, pool + off, in);
    }
    cp_async_commit();
}

template <bool PAGED>
__global__ void __launch_bounds__(NTHREAD)
decode_logits_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kpool,
                     const int* __restrict__ tables, const int* __restrict__ positions,
                     float* __restrict__ logits, float* __restrict__ part_ml, int hkv,
                     int g, int hd, int bs, int mb, int nsplit, float scale, int window) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Smem L = smem_layout(hd, g);
    bf16* ks = reinterpret_cast<bf16*>(smem + L.kv);
    float* qs = reinterpret_cast<float*>(smem + L.q);
    float* sc = reinterpret_cast<float*>(smem + L.s);
    const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const Split sp = split_of<PAGED>(positions, b, split, window);
    const size_t bh = (size_t)b * hkv + h;
    float* ml = part_ml + (bh * nsplit + split) * g * 2;
    if (sp.empty()) {
        for (int gi = tid; gi < g; gi += NTHREAD) {
            ml[2 * gi] = -INFINITY;
            ml[2 * gi + 1] = 0.0f;
        }
        return;
    }
    stage<PAGED>(ks, kpool, PAGED ? tables + (size_t)b * mb : nullptr, sp, b, h, hkv, hd,
                 bs, mb, L.ld);
    const bf16* qb = q + bh * g * hd;
    for (int i = tid; i < g * hd; i += NTHREAD) qs[i] = __bfloat162float(qb[i]);
    cp_async_wait_all();
    __syncthreads();

    {   // thread r owns key r for every query row of the group
        const int r = tid;
        const bool in = sp.valid(sp.k0 + r, mb * bs);
        float* out = logits + bh * g * nsplit * KEYS + (size_t)split * KEYS + r;
        for (int gi = 0; gi < g; ++gi) {
            const float* qrow = qs + gi * hd;
            float dot = 0.0f;
            for (int c8 = 0; c8 < hd / 8; ++c8) {
                const uint4 raw = *reinterpret_cast<const uint4*>(ks + r * L.ld + c8 * 8);
                const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    dot = fmaf(qrow[c8 * 8 + j], __bfloat162float(e[j]), dot);
            }
            const float s = in ? dot * scale : -INFINITY;
            sc[gi * KEYS + r] = s;
            out[(size_t)gi * nsplit * KEYS] = s;
        }
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += NTHREAD / 32) {    // one warp per row
        const float* srow = sc + gi * KEYS;
        float mx = -INFINITY;
        for (int r = lane; r < KEYS; r += 32) mx = fmaxf(mx, srow[r]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.0f;
        for (int r = lane; r < KEYS; r += 32)
            sum += srow[r] == -INFINITY ? 0.0f : expf(srow[r] - mx);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
            ml[2 * gi] = mx;
            ml[2 * gi + 1] = sum;
        }
    }
}

template <bool PAGED>
__global__ void __launch_bounds__(NTHREAD)
decode_pv_kernel(const bf16* __restrict__ vpool, const int* __restrict__ tables,
                 const int* __restrict__ positions, const float* __restrict__ logits,
                 const float* __restrict__ part_ml, float* __restrict__ part_acc, int hkv,
                 int g, int hd, int bs, int mb, int nsplit, int window) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Smem L = smem_layout(hd, g);
    bf16* vs = reinterpret_cast<bf16*>(smem + L.kv);
    float* ps = reinterpret_cast<float*>(smem + L.s);
    float* stat = reinterpret_cast<float*>(smem + L.q);   // (M, L) per query row
    const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const Split sp = split_of<PAGED>(positions, b, split, window);
    if (sp.empty()) return;
    const size_t bh = (size_t)b * hkv + h;
    stage<PAGED>(vs, vpool, PAGED ? tables + (size_t)b * mb : nullptr, sp, b, h, hkv, hd,
                 bs, mb, L.ld);

    // The row's softmax max M and sum L from the splits' (m_s, l_s).
    const float* ml = part_ml + bh * nsplit * g * 2;
    for (int gi = tid; gi < g; gi += NTHREAD) {
        float m = -INFINITY;
        for (int s = 0; s < nsplit; ++s)
            if (ml[(s * g + gi) * 2 + 1] > 0.0f) m = fmaxf(m, ml[(s * g + gi) * 2]);
        float l = 0.0f;
        for (int s = 0; s < nsplit; ++s) {
            const float ls = ml[(s * g + gi) * 2 + 1];
            if (ls > 0.0f) l += ls * expf(ml[(s * g + gi) * 2] - m);
        }
        stat[2 * gi] = m;
        stat[2 * gi + 1] = l;
    }
    __syncthreads();
    const float* lrow = logits + bh * g * nsplit * KEYS + (size_t)split * KEYS;
    for (int i = tid; i < g * KEYS; i += NTHREAD) {
        const int gi = i / KEYS, r = i - gi * KEYS;
        const float s = lrow[(size_t)gi * nsplit * KEYS + r];
        const float p = s == -INFINITY ? 0.0f
                                       : __fdiv_rn(expf(s - stat[2 * gi]), stat[2 * gi + 1]);
        ps[i] = __bfloat162float(__float2bfloat16(p));
    }
    cp_async_wait_all();
    __syncthreads();

    float* acc = part_acc + (bh * nsplit + split) * g * hd;
    for (int o = tid; o < g * hd; o += NTHREAD) {       // output element (gi, d)
        const int gi = o / hd, d = o - gi * hd;
        const float* prow = ps + gi * KEYS;
        float a = 0.0f;
#pragma unroll 8
        for (int r = 0; r < KEYS; ++r) a = fmaf(prow[r], __bfloat162float(vs[r * L.ld + d]), a);
        acc[o] = a;
    }
}

template <bool PAGED>
__global__ void __launch_bounds__(NTHREAD)
decode_sum_kernel(const float* __restrict__ part_acc, const int* __restrict__ positions,
                  bf16* __restrict__ out, int hkv, int g, int hd, int nsplit, int window) {
    const int bh = blockIdx.x, b = bh / hkv;
    const float* acc = part_acc + (size_t)bh * nsplit * g * hd;
    for (int o = threadIdx.x; o < g * hd; o += NTHREAD) {
        float a = 0.0f;
        for (int s = 0; s < nsplit; ++s)
            if (!split_of<PAGED>(positions, b, s, window).empty()) a += acc[(size_t)s * g * hd + o];
        out[(size_t)bh * g * hd + o] = __float2bfloat16(a);
    }
}

// The three launches on one stream.  PAGED: tables (B,MB) and positions
// (B,); contiguous: tables unused, positions = kv_len (1,), bs = C, mb = 1.
template <bool PAGED>
int launch_decode(const void* q, const void* k, const void* v, const void* tables,
                  const void* positions, void* logits, void* part_ml, void* part_acc,
                  void* out, int b, int hkv, int g, int hd, int bs, int mb, float scale,
                  int window, void* stream) {
    if (g > MAX_G) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nsplit = (mb * bs + KEYS - 1) / KEYS;
    const size_t smem = smem_layout(hd, g).total;
    const void* staged[] = {reinterpret_cast<const void*>(decode_logits_kernel<PAGED>),
                            reinterpret_cast<const void*>(decode_pv_kernel<PAGED>)};
    for (const void* fn : staged) {
        cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(nsplit, hkv, b);
    decode_logits_kernel<PAGED><<<grid, NTHREAD, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const int*>(tables), static_cast<const int*>(positions),
        static_cast<float*>(logits), static_cast<float*>(part_ml), hkv, g, hd, bs, mb,
        nsplit, scale, window);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_pv_kernel<PAGED><<<grid, NTHREAD, smem, st>>>(
        static_cast<const bf16*>(v), static_cast<const int*>(tables),
        static_cast<const int*>(positions), static_cast<const float*>(logits),
        static_cast<const float*>(part_ml), static_cast<float*>(part_acc), hkv, g, hd, bs,
        mb, nsplit, window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_sum_kernel<PAGED><<<b * hkv, NTHREAD, 0, st>>>(
        static_cast<const float*>(part_acc), static_cast<const int*>(positions),
        static_cast<bf16*>(out), hkv, g, hd, nsplit, window);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,Hkv,G,hd), pools (NB,Hkv,bs,hd), out (B,Hkv,G,hd): bf16,
// contiguous, 16-byte aligned; tables (B,MB) and positions (B,) int32.
// f32 scratch with nsplit = ceil(MB*bs / 128): logits (B,Hkv,G,nsplit*128),
// part_ml (B,Hkv,nsplit,G,2), part_acc (B,Hkv,nsplit,G,hd).
// hd % 8 == 0, hd <= 256, G <= 16.  window <= 0 means no window.
extern "C" int flash_decode_paged_bf16(const void* q, const void* k_pool, const void* v_pool,
                                       const void* tables, const void* positions,
                                       void* logits, void* part_ml, void* part_acc, void* out,
                                       int b, int hkv, int g, int hd, int bs, int mb,
                                       float scale, int window, void* stream) {
    return launch_decode<true>(q, k_pool, v_pool, tables, positions, logits, part_ml,
                               part_acc, out, b, hkv, g, hd, bs, mb, scale, window, stream);
}

// q (B,Hkv,G,hd), k/v (B,Hkv,C,hd), out (B,Hkv,G,hd): bf16, contiguous,
// 16-byte aligned; kv_len (1,) int32 on the card, 0 <= kv_len <= C.
// f32 scratch with nsplit = ceil(C / 128) shaped as for the paged entry.
// hd % 8 == 0, hd <= 256, G <= 16.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* kv_len, void* logits, void* part_ml,
                                 void* part_acc, void* out, int b, int hkv, int g, int hd,
                                 int c, float scale, void* stream) {
    return launch_decode<false>(q, k, v, nullptr, kv_len, logits, part_ml, part_acc, out, b,
                                hkv, g, hd, c, 1, scale, -1, stream);
}
