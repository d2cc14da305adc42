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
// bytes of K/V read, about 1000 flops per byte: the tensor cores.  The
// attend launch is FlashAttention-2 on mma.sync, in one launch of
// thread-block clusters:
// - Templated on the padded head dim DP (bf16 pools: 16, 32, ..., 192;
//   Q8_0 pools: 32, 64, ..., 192) and the pool type, one template for
//   both.  A CTA of 8 warps owns BQ = 128 flattened query rows (t*G + g)
//   of one KV head, 16 per warp.  Q is copied once and held as the A
//   fragments of mma.m16n8k16 (bf16 in, f32 accumulate) for the whole key
//   loop.  At DP = 128 a thread holds O (64 f32), S (32), Q (32) and P
//   hi + lo, about 210 registers, so one such CTA fills an SM's register
//   file; 64-row CTAs, two to an SM (and a 2-slot ring), were slower.
// - The block's keys [kstart, kend) (its first row's window start, its
//   last row's causal end) are cut into 64-key tiles, and the tiles into
//   S contiguous runs, one per CTA of a cluster of S.  S comes from the
//   host's split rule (split_rule) over the clusters of 1, 2, 4 and 8
//   CTAs that fit on the card at once, queried once per device and
//   instantiation.  Row blocks run heaviest (last) first.
// - K and V tiles stream through a ring of STAGES = 3 slots by 16-byte
//   cp.async, addressed through the block table: each thread copies one
//   16-byte column chunk of every rpp-th row of a tile and walks the table
//   from the tile's first key, one division per tile.  Keys at or past
//   kend are zero-filled.  Rows are DP + 8 elements apart, an odd number
//   of 16-byte units, so ldmatrix (K) and ldmatrix.trans (V) are free of
//   bank conflicts.  One barrier per tile.
// - Q8_0 pool: the ring holds the int8 rows (DP bytes) and, per scale,
//   the aligned 4-byte word that holds it (with each row's parity; of an
//   even scale only its 2 bytes are read): about
//   half the bytes of a bf16 key.  Each tile is dequantized from shared
//   memory, bf16(float(q) * float(d)) by q8_matmul's exact f32 route, into
//   one of two bf16 tile pairs one tile ahead of its products, so warps
//   that finish a tile early unpack the next while the others multiply.
// - A warp's step over a tile is common.cuh's FlashWarp, which
//   flash_attention.cu shares: S = Q K^T stays in registers; the row max
//   and sum reduce over the quad of lanes; p = 2^(s*c - m*c) with c =
//   scale*log2(e).  Masks are applied only on tiles that cross a warp's
//   causal diagonal, its window's edge or kend; tiles wholly masked for a
//   warp are skipped.
// - The plain version keeps P in f32, and a single bf16 P puts up to 2
//   bf16 ulps between the outputs where P.V cancels; so P enters P.V as
//   two bf16 A fragments, hi = bf16(p) and lo = bf16(p - hi) (16
//   significant bits), two mma per k-step.  O is rescaled in registers.
// - Merge: each CTA leaves its unnormalised O and, per row, its max
//   (times c, as its p used it) and sum in its own shared memory; after a
//   cluster barrier CTA r owns rows r*BQ/S .. (r+1)*BQ/S - 1 of the block,
//   reads the S partials from its peers' shared memory (distributed
//   shared memory) in rank order, and writes out = sum w_j O_j / sum w_j
//   l_j with w_j = 2^(m_j - M) (0 where no key) as bf16.  Every sum has a
//   fixed order: the same inputs give the same bits.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int BQ = 128;          // query rows (flattened t*G + g) per CTA, 16 per warp
constexpr int NT = 256;          // threads per CTA
constexpr int BKV = FLASH_BKV;   // keys per tile
constexpr int STAGES = 3;        // ring slots
constexpr int QK = 32;           // Q8_0 block along hd
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory.  bf16 pools: Q (BQ rows), then the ring of K and V
// tiles.  Q8_0 pools: two bf16 (K, V) tile pairs, of which the second
// holds Q until Q is in registers, then the ring of K and V codes, K and
// V scale words and one parity byte per row.  After the key loop the
// same bytes hold the CTA's partial O (f32, O_LD apart) and (m*c, l)
// per row.
template <int DP, bool Q8>
struct Cfg {
    static constexpr int LD = DP + 8;                // bf16 row stride of Q and the tiles
    static constexpr int TILE = BKV * LD;            // elements of one K or V tile
    static constexpr int PAIR = 2 * TILE * 2;        // bytes of a K and a V tile
    static constexpr int NSC = DP / QK;              // Q8_0 scales per row
    static constexpr int CODES = BKV * DP;           // int8 bytes of one K or V tile
    static constexpr int SCALES = BKV * NSC * 4;     // scale-word bytes of one K or V tile
    static constexpr int SLOT = Q8 ? 2 * CODES + 2 * SCALES + BKV : PAIR;
    static constexpr int RING = Q8 ? 2 * PAIR : BQ * LD * 2;
    static constexpr int O_LD = DP + 4;
    static constexpr int PART = BQ * O_LD * 4 + BQ * 2 * 4;
    static constexpr int MAIN = RING + STAGES * SLOT;
    static constexpr int SMEM = MAIN > PART ? MAIN : PART;
    // 16-byte chunks per pool row and the least rows per pass of NT threads.
    static constexpr int CPR = Q8 ? DP / 16 : DP / 8;
    static constexpr int PER = (BKV + NT / CPR - 1) / (NT / CPR);   // rows per thread
    static_assert(SMEM <= 232448, "shared memory of one CTA");
    static_assert(!Q8 || (DP % QK == 0 && BQ * LD * 2 == PAIR), "Q8_0: Q overlays a pair");
};

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

// Grid (S, row blocks, Hkv), clusters of (S, 1, 1): CTA rank r of a
// cluster takes the r-th run of the row block's key tiles.
template <int DP, bool Q8>
__global__ void __launch_bounds__(NT, 1)
attend_kernel(const bf16* __restrict__ q, const void* __restrict__ kpool,
              const void* __restrict__ vpool, const __half* __restrict__ kscale,
              const __half* __restrict__ vscale, const int* __restrict__ table,
              bf16* __restrict__ out, int t, int hkv, int g, int hd, int bs, int pos0,
              float scale, int window) {
    using C = Cfg<DP, Q8>;
    constexpr int LD = C::LD, KS = DP / 16;
    constexpr int LEAD = Q8 ? STAGES : STAGES - 1;     // tiles in flight before the loop
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* qs = reinterpret_cast<bf16*>(smem + (Q8 ? C::PAIR : 0));
    unsigned char* ring = smem + C::RING;

    const int split = gridDim.x;
    const int rank = static_cast<int>(cluster.block_rank());
    const int h = blockIdx.z;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest row blocks first
    const int nrows = t * g;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;

    // The block's keys [kstart, kend) in 64-key tiles; this CTA's run.
    const int kend = pos0 + (min(q0 + BQ, nrows) - 1) / g + 1;
    const int kstart = window > 0 ? max(0, pos0 + q0 / g - window + 1) : 0;
    const int nt = kend > kstart ? (kend - kstart + BKV - 1) / BKV : 0;
    const int per = (nt + split - 1) / split;
    const int t0 = min(rank * per, nt);
    const int ntl = min(t0 + per, nt) - t0;
    const int kbeg = kstart + t0 * BKV;

    // This thread's share of a tile's 16-byte copies: column chunk cc of
    // rows row0, row0 + rpp, ... (threads with row0 >= rpp idle).
    const int cpr = Q8 ? DP / 16 : hd / 8;
    const int rpp = NT / cpr, row0 = tid / cpr, cc = tid - row0 * cpr;

    // Tile `it` of the run into its ring slot.  The thread walks the
    // table from its first row: one division per tile.
    auto issue = [&](int it) {
        unsigned char* slot = ring + (it % STAGES) * C::SLOT;
        int kp = kbeg + it * BKV + row0;
        int b = kp / bs, o = kp - b * bs;
#pragma unroll
        for (int j = 0; j < C::PER; ++j) {
            const int r = row0 + j * rpp;
            if (row0 < rpp && r < BKV) {
                const bool in = kp < kend;
                const size_t prow = in ? ((size_t)__ldg(table + b) * hkv + h) * bs + o : 0;
                if constexpr (!Q8) {
                    const size_t e = prow * hd + cc * 8;
                    bf16* dk = reinterpret_cast<bf16*>(slot) + r * LD + cc * 8;
                    cp_async16(dk, static_cast<const bf16*>(kpool) + e, in);
                    cp_async16(dk + C::TILE, static_cast<const bf16*>(vpool) + e, in);
                } else {
                    const size_t e = prow * DP + cc * 16;
                    unsigned char* dk = slot + r * DP + cc * 16;
                    cp_async16(dk, static_cast<const int8_t*>(kpool) + e, in);
                    cp_async16(dk + C::CODES, static_cast<const int8_t*>(vpool) + e, in);
                    if (cc < C::NSC) {             // scale cc: the word that holds it
                        // An even scale is the word's low half: only its 2
                        // bytes are read, so none past the pool's last scale.
                        const size_t si = prow * C::NSC + cc, s = si & ~(size_t)1;
                        const int n = in ? (si & 1 ? 4 : 2) : 0;
                        unsigned char* ds = slot + 2 * C::CODES + (r * C::NSC + cc) * 4;
                        cp_async4_n(ds, kscale + s, n);
                        cp_async4_n(ds + C::SCALES, vscale + s, n);
                    }
                    if (cc == 0) slot[2 * C::CODES + 2 * C::SCALES + r] = prow & 1;
                }
            }
            kp += rpp;
            o += rpp;
            while (o >= bs) {
                o -= bs;
                ++b;
            }
        }
    };

    // Q8_0: tile `it`'s codes in the ring to bf16 tile pair `buf`.
    auto dequant = [&](int it, int buf) {
        const unsigned char* slot = ring + (it % STAGES) * C::SLOT;
        bf16* dst = reinterpret_cast<bf16*>(smem + buf * C::PAIR);
        constexpr int CH = DP / 16;                   // 16-code chunks per row
#pragma unroll
        for (int u = 0; u < 2 * BKV * CH / NT; ++u) {
            const int i = tid + u * NT;
            const int kv = i / (BKV * CH), rem = i - kv * BKV * CH;
            const int r = rem / CH, c = rem - r * CH, j = c >> 1;
            const uint4 code =
                *reinterpret_cast<const uint4*>(slot + kv * C::CODES + r * DP + c * 16);
            const uint32_t w = *reinterpret_cast<const uint32_t*>(
                slot + 2 * C::CODES + kv * C::SCALES + (r * C::NSC + j) * 4);
            const int odd = (slot[2 * C::CODES + 2 * C::SCALES + r] * C::NSC + j) & 1;
            const float d = __half2float(
                __ushort_as_half(static_cast<unsigned short>(odd ? w >> 16 : w & 0xFFFFu)));
            uint32_t v[8];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                uint32_t p[2];
                q8_unpack_word(word(code, x), d, p);
                v[2 * x] = p[0];
                v[2 * x + 1] = p[1];
            }
            bf16* o = dst + kv * C::TILE + r * LD + c * 16;
            *reinterpret_cast<uint4*>(o) = make_uint4(v[0], v[1], v[2], v[3]);
            *reinterpret_cast<uint4*>(o + 8) = make_uint4(v[4], v[5], v[6], v[7]);
        }
    };

    // The warp's rows on the key axis: qlo/qhi the positions of its first
    // and last live row, qd[r] those of this thread's rows gid, gid + 8.
    const int qw0 = q0 + warp * 16;
    const bool live = qw0 < nrows;
    const int qlo = pos0 + qw0 / g, qhi = pos0 + min(qw0 + 15, nrows - 1) / g;
    const int qd[2] = {pos0 + (qw0 + gid) / g, pos0 + (qw0 + gid + 8) / g};
    // p = 2^(s*c - m*c); a negative scale flips the sign of q (exact in
    // bf16) so that the row max is taken on s*|scale|.
    const float c = fmaxf(fabsf(scale) * LOG2E, 1e-30f);
    const uint32_t qsign = scale < 0.0f ? 0x80008000u : 0u;

    FlashWarp<DP> fw;

    if (ntl > 0) {
        for (int i = tid; i < BQ * (DP / 8); i += NT) {
            const int r = i / (DP / 8), c8 = i - r * (DP / 8);
            const int gr = q0 + r;
            const bool in = gr < nrows && c8 * 8 < hd;
            const bf16* src =
                in ? q + (((size_t)(gr / g) * hkv + h) * g + gr % g) * hd + c8 * 8 : q;
            cp_async16(qs + r * LD + c8 * 8, src, in);
        }
        if (!Q8 && hd < DP)                  // the ring's pad columns, once
            for (int r = tid; r < 2 * STAGES * BKV; r += NT)
                *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(ring) + r * LD + hd) =
                    make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int s = 0; s < LEAD; ++s) {
            if (s < ntl) issue(s);
            cp_async_commit();
        }
        cp_async_wait_n<LEAD - 1>();         // Q and tile 0
        __syncthreads();
        fw.load_q(qs + warp * 16 * LD, qsign);
        if constexpr (Q8) {
            __syncthreads();                 // Q read by all: its pair is free
            dequant(0, 0);
        }
    }

    for (int it = 0; it < ntl; ++it) {
        cp_async_wait_n<STAGES - 2>();       // bf16: tile it; Q8_0: tile it + 1
        __syncthreads();                     // ... for all; the slot of it - 1 free
        if (it + LEAD < ntl) issue(it + LEAD);
        cp_async_commit();
        const int k0 = kbeg + it * BKV;
        const bf16* kt = Q8 ? reinterpret_cast<const bf16*>(smem + (it & 1) * C::PAIR)
                            : reinterpret_cast<const bf16*>(ring + (it % STAGES) * C::SLOT);
        const bf16* vt = kt + C::TILE;
        if (live && k0 <= qhi && !(window > 0 && k0 + BKV - 1 <= qlo - window)) {
            const bool edge = k0 + BKV - 1 > qlo || k0 + BKV > kend ||
                              (window > 0 && k0 <= qhi - window);
            fw.template tile<true>(kt, vt, c, edge, k0, kend, true, window, qd);
        }
        if constexpr (Q8)
            if (it + 1 < ntl) dequant(it + 1, (it + 1) & 1);
    }

    // This CTA's partial into its own shared memory (over the ring, now
    // idle): unnormalised O, and per row (m*c, l) as its p used them.
    cp_async_wait_all();
    __syncthreads();
    float* part = reinterpret_cast<float*>(smem);
    float* ml = part + BQ * C::O_LD;
    fw.finish();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + gid + 8 * r;
#pragma unroll
        for (int n = 0; n < 2 * KS; ++n)
            *reinterpret_cast<float2*>(part + row * C::O_LD + 8 * n + 2 * tig) =
                make_float2(fw.acc[n][2 * r], fw.acc[n][2 * r + 1]);
        if (tig == 0) {
            ml[2 * row] = fw.m[r] == -INFINITY ? 0.0f : fw.m[r] * c;
            ml[2 * row + 1] = fw.l[r];
        }
    }
    cluster.sync();

    // Rows rank*BQ/S .. of the block: the S partials in rank order.
    const int rows = BQ / split;
    for (int i = tid; i < rows * (DP / 8); i += NT) {
        const int row = rank * rows + i / (DP / 8), c8 = i % (DP / 8);
        const int gr = q0 + row;
        if (gr >= nrows || c8 * 8 >= hd) continue;
        float mj[8], lj[8], big = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            lj[j] = 0.0f;
            if (j < split) {
                const float2 v = *reinterpret_cast<const float2*>(
                    cluster.map_shared_rank(ml, j) + 2 * row);
                mj[j] = v.x;
                lj[j] = v.y;
                if (v.y > 0.0f) big = fmaxf(big, v.x);
            }
        }
        float sum = 0.0f, o[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (j < split && lj[j] > 0.0f) {
                const float w = ex2(mj[j] - big);
                sum += lj[j] * w;
                const float4* po = reinterpret_cast<const float4*>(
                    cluster.map_shared_rank(part, j) + row * C::O_LD + c8 * 8);
                const float4 a = po[0], b = po[1];
                o[0] += a.x * w; o[1] += a.y * w; o[2] += a.z * w; o[3] += a.w * w;
                o[4] += b.x * w; o[5] += b.y * w; o[6] += b.z * w; o[7] += b.w * w;
            }
        }
        uint32_t v[4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
            v[x] = sum > 0.0f ? pack_bf16(o[2 * x] / sum, o[2 * x + 1] / sum) : 0u;
        *reinterpret_cast<uint4*>(out + (((size_t)(gr / g) * hkv + h) * g + gr % g) * hd +
                                  c8 * 8) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    cluster_arrive();                        // peers may still read this CTA's partial
    cluster_wait();
}

// CTAs per cluster, the key splits of a row block: of S = 1, 2, 4, 8 the
// one whose waves of clusters, at ceil(nt / S) tiles per CTA, take the
// fewest tile steps; ties go to the smaller S.  blocks: (row block, KV
// head) pairs; nt: the heaviest row block's tiles; fit[i]: clusters of
// 2^i CTAs that run on the card at once (0: none fits).
int split_rule(long long blocks, int nt, const int* fit) {
    int best = 1;
    long long best_cost = LLONG_MAX;
    for (int i = 0; i < 4; ++i) {
        if (fit[i] < 1) continue;
        const long long cost = (blocks + fit[i] - 1) / fit[i] * ((nt + (1 << i) - 1) >> i);
        if (cost < best_cost) {
            best = 1 << i;
            best_cost = cost;
        }
    }
    return best;
}

// The attend launch's arguments.
struct Attend {
    const void *q, *kpool, *vpool, *kscale, *vscale, *table;
    void* out;
    int t, hkv, g, hd, bs, pos0;
    float scale;
    int window;
    cudaStream_t stream;
};

// Clusters of 1, 2, 4 and 8 CTAs of attend_kernel<DP, Q8> that run on the
// current device at once (0: that size cannot run), queried once per
// device; its shared-memory limit is set up on the way.
template <int DP, bool Q8>
int attend_fit(int*& fit) {
    static PerDevice<4> fit_of;
    return fit_of.get(fit, [](int, int* v) {
        cudaError_t err = cudaFuncSetAttribute(
            attend_kernel<DP, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<DP, Q8>::SMEM);
        if (err != cudaSuccess) return err;
        cudaLaunchConfig_t cfg = {};
        cfg.blockDim = dim3(NT);
        cfg.dynamicSmemBytes = Cfg<DP, Q8>::SMEM;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        for (int i = 0; i < 4; ++i) {
            cfg.gridDim = dim3(1 << i);
            attr[0].val.clusterDim.x = 1 << i;
            err = cudaOccupancyMaxActiveClusters(&v[i], attend_kernel<DP, Q8>, &cfg);
            if (err != cudaSuccess) {
                if (i == 0) return err;
                (void)cudaGetLastError();
                v[i] = 0;
            }
        }
        return v[0] < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
    });
}

template <int DP, bool Q8>
int launch_attend(const Attend& a) {
    int* fit = nullptr;
    if (const int err = attend_fit<DP, Q8>(fit)) return err;
    const int nrows = a.t * a.g, nrb = (nrows + BQ - 1) / BQ;
    int nt = 0;                              // the heaviest row block's key tiles
    for (int rb = 0; rb < nrb; ++rb) {
        const int kend = a.pos0 + (min((rb + 1) * BQ, nrows) - 1) / a.g + 1;
        const int kstart = a.window > 0 ? max(0, a.pos0 + rb * BQ / a.g - a.window + 1) : 0;
        nt = max(nt, (kend - kstart + BKV - 1) / BKV);
    }
    const int split = split_rule((long long)nrb * a.hkv, nt, fit);

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(split, nrb, a.hkv);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = Cfg<DP, Q8>::SMEM;
    cfg.stream = a.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, attend_kernel<DP, Q8>, static_cast<const bf16*>(a.q), a.kpool, a.vpool,
        static_cast<const __half*>(a.kscale), static_cast<const __half*>(a.vscale),
        static_cast<const int*>(a.table), static_cast<bf16*>(a.out), a.t, a.hkv, a.g, a.hd,
        a.bs, a.pos0, a.scale, a.window);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

int write_grid(int pieces) {
    const int blocks = (pieces + 255) / 256;
    return blocks < 1024 ? blocks : 1024;
}

// op.run<DP, Q8>() for the padded head dim of a bf16 (hd % 8 == 0) or
// Q8_0 (hd % 32 == 0) pool: the instantiations that are built.
template <class Op>
int by_head_dim(bool q8, int hd, const Op& op) {
    if (q8) {
        switch (hd) {
            case 32: return op.template run<32, true>();
            case 64: return op.template run<64, true>();
            case 96: return op.template run<96, true>();
            case 128: return op.template run<128, true>();
            case 160: return op.template run<160, true>();
            case 192: return op.template run<192, true>();
        }
        return static_cast<int>(cudaErrorInvalidValue);
    }
    switch ((hd + 15) / 16 * 16) {
        case 16: return op.template run<16, false>();
        case 32: return op.template run<32, false>();
        case 48: return op.template run<48, false>();
        case 64: return op.template run<64, false>();
        case 80: return op.template run<80, false>();
        case 96: return op.template run<96, false>();
        case 112: return op.template run<112, false>();
        case 128: return op.template run<128, false>();
        case 144: return op.template run<144, false>();
        case 160: return op.template run<160, false>();
        case 176: return op.template run<176, false>();
        case 192: return op.template run<192, false>();
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

struct LaunchOp {
    const Attend& a;
    template <int DP, bool Q8>
    int run() const { return launch_attend<DP, Q8>(a); }
};

struct FitOp {
    int* out;
    template <int DP, bool Q8>
    int run() const {
        int* fit = nullptr;
        const int err = attend_fit<DP, Q8>(fit);
        for (int i = 0; i < 4 && err == 0; ++i) out[i] = fit[i];
        return err;
    }
};

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
    const Attend a{q, k_pool, v_pool, nullptr, nullptr, table, out, t, hkv, g, hd, bs,
                   pos0, scale, window, st};
    return by_head_dim(false, hd, LaunchOp{a});
}

// Q8_0 pools: kq/vq (NB,Hkv,bs,hd) int8, ks/vs (NB,Hkv,bs,hd/32) f16;
// k_new/v_new bf16 (requantized here).  hd % 32 == 0, hd <= 192.
extern "C" int flash_prefill_paged_q8(const void* q, const void* k_new, const void* v_new,
                                      void* k_pool, void* v_pool, void* ks_pool,
                                      void* vs_pool, const void* table, void* out, int t,
                                      int hkv, int g, int hd, int bs, int pos0, float scale,
                                      int window, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    write_q8_kernel<<<write_grid(t * hkv * (hd / QK)), 256, 0, st>>>(
        static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
        static_cast<int8_t*>(k_pool), static_cast<int8_t*>(v_pool),
        static_cast<__half*>(ks_pool), static_cast<__half*>(vs_pool),
        static_cast<const int*>(table), t, hkv, hd, bs, pos0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const Attend a{q, k_pool, v_pool, ks_pool, vs_pool, table, out, t, hkv, g, hd, bs,
                   pos0, scale, window, st};
    return by_head_dim(true, hd, LaunchOp{a});
}

// The clusters of 1, 2, 4 and 8 CTAs of the attend launch for head dim hd
// (a Q8_0 pool when q8) that run on the current device at once, into
// fit[0..3]: what split_rule picks the key splits from.
extern "C" int flash_prefill_fit(int hd, int q8, int* fit) {
    return by_head_dim(q8 != 0, hd, FitOp{fit});
}
