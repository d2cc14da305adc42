// Flash-decode (one new token per row, GQA) for Hopper (sm_90a): a
// contiguous entry and a paged entry, each one thread-block-cluster
// launch per call, one kernel templated on where the K and V rows come
// from.
//
// Replaces: src/repro/kernels/flash_decode.py :: flash_decode
// (_decode_kernel) and :: flash_decode_paged (_paged_decode_kernel).
//
// Contiguous (flash_decode_bf16): q (B,Hkv,G,hd), k/v (B,Hkv,C,hd) bf16
// and kv_len (1,) int32 on the card, read by the kernel itself (no host
// sync): every row attends to the slots idx < kv_len[0].
// Paged (flash_decode_paged_bf16): q (B,Hkv,G,hd) bf16; pools
// (NB,Hkv,bs,hd) bf16; tables (B,MB) int32; positions (B,) int32, the
// last valid logical index of each row (inclusive), read by the kernel.
// Row b's query group attends to the keys at idx <= positions[b] (and
// idx > positions[b] - window) of its table.
//
// Both compute what the reference's decode step computes when it reads a
// bf16 cache (models/attention.py: _update_read_contiguous /
// _update_read_paged and the einsums of attention_decode): logits
// q.k * scale in f32, softmax in f32, the normalised probabilities
// rounded to bf16, P.V summed in f32; out (B,Hkv,G,hd) bf16.  (The Pallas
// kernels round the unnormalised p instead; the port follows the path it
// replaces.)  Every key's p needs its row's global max M and sum L, so the
// keys of one (row, head) are seen twice: once for M and L, once for P.V.
// Keys past the valid range (unwritten cache slots, a recycled block's
// stale bytes, the null block of an idle row past its one key, keys
// before a sliding window) are never loaded: their rows are zero-filled
// and their logits are -inf before any max.
//
// What bounds it on the H100: each (row, head) reads its K and V
// (2 * keys * hd * 2 bytes) for 4 * G * keys * hd flops, 4 flops per
// byte at G = 4: device-memory bytes, 9.8 us at the contiguous headline
// shape, 9.2 us at the paged one.  At 4 rows and 8 KV heads there are
// only 32 (row, head) pairs for 132 SMs, so each pair is cut over its
// keys, and the pieces have to agree on M and L.
//
// Design (both entries): one launch, grid (CLUSTER, Hkv, B) with cluster
// dims (CLUSTER, 1, 1), one cluster of CLUSTER = 8 CTAs (the portable
// size) per (row, KV head).  16 (non-portable) was measured too, on the
// contiguous entry: a cluster has to fit in one GPC, which bounds how
// many 16-CTA clusters run at once, and 16 was slower with Granite-8B's
// 32 (row, head) pairs at 4 rows, at the headline shape
// (4,8,4,128,2048,2000) and at the generation path's 160 keys; it was
// faster only at one row (PERF.md).
// Each CTA reads its row's key range [kbase, kend) on the card and takes
// the keys [kbase + r*Kc, min(kbase + (r+1)*Kc, kend)), Kc = ceil((kend -
// kbase) / CLUSTER) rounded up to 16: the split follows the range, not C
// or the table, so at position 159 of a 2048-slot cache five CTAs take
// 32 keys each and three find nothing.  An empty CTA keeps m = -inf,
// l = 0 and has a zero partial.  Contiguous: [0, kv_len).  Paged: kend =
// positions[b] + 1 and, under a window, the first key kmin = max(0, kend
// - window) and kbase = kmin rounded down to 16; keys in [kbase, kmin)
// are masked like keys past kend.  An idle row (position 0, its table all
// NULL_BLOCK) attends its one key, as the plain version does.
// Paged rows: the 64-key tiles start on multiples of 16 keys, and a pool
// block holds bs rows of hd contiguous per head ((NB,Hkv,bs,hd)), so when
// bs % 16 == 0 each 16 keys are one table entry and one run of rows
// (other block sizes: one entry per key).  Each CTA first turns the
// entries of its keys into pool rows in shared memory (one table read
// each, all in flight at once): a lookup at each ring fill would put a
// dependent table read and a division in front of every copy.
//   1. K and V rows go through a 2-slot ring of 64-key tiles with
//      cp.async (16-byte pieces), in the order K tiles, then V tiles: a
//      CTA with one tile issues its K and V at once, and V loads hide
//      behind the logits and the cluster barrier.  (64-key tiles keep a
//      CTA at ~50 KB of shared memory at hd 128, so 4 fit per SM.)
//   2. Logits on the tensor cores: the G query rows (zero-padded to 16)
//      are the A operand of mma.sync m16n8k16, 16 keys per warp and tile
//      the B operand (ldmatrix from the ring), f32 accumulate: the same
//      f32 dot of bf16 values as q.k in f32.  The G x Kc logits stay in
//      shared memory and each tile updates the CTA's (m, l) per query row
//      online.  Where G * Kc * 4 bytes would exceed LOGITS_MAX_BYTES = 32
//      KB (G = 4: C > 16384; G = 16: C > 4096) they are not kept: phase 2
//      recomputes them tile by tile from K with the same arithmetic (the
//      ring then carries K0 V0 K1 V1 ...).
//   3. Each CTA stores its (m, l) into every peer's shared memory at its
//      rank (distributed shared memory), once a cluster barrier arrived
//      at on entry shows every peer has started; cluster.sync(); each
//      CTA forms
//      M = max m, L = sum l * exp(m - M) over the ranks in order (pieces
//      with l = 0 left out).
//   4. For each V tile, P = bf16(__fdiv_rn(exp(s - M), L)) of its keys
//      into shared memory, and the CTA's f32 partial P.V (16 x hd) on the
//      tensor cores, P as A, V as B (ldmatrix.trans), each warp a quarter
//      of the columns.
//   5. Each CTA keeps its partial in its own shared memory;
//      cluster.sync(); CTA r owns 1/CLUSTER of the G*hd outputs, adds the
//      CLUSTER partials of its slice in rank order from its peers' shared
//      memory, and writes bf16 out.  A last cluster barrier keeps each
//      CTA's shared memory alive until its peers have read it.
// The tensor cores matter here for issue slots, not for flops: with
// CUDA-core FMAs every 8 FMAs of the logits need two shared-memory loads
// of q, where one mma.sync instruction does 16 x 8 x 16 products.
// Nothing but q, K, V, kv_len (positions and tables) and out touches
// device memory: no scratch.  Every sum has a fixed order: the same
// inputs give the same bits.  Rows of a tile are hdp + 8 elements apart
// (hdp = hd rounded up to 16), an odd number of 16-byte units, so each
// ldmatrix's 8 rows hit distinct banks; the pad columns of q and of the
// ring are zeroed once.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int NTHREAD = 128;
constexpr int MAX_G = 16;

constexpr int CLUSTER = 8;       // CTAs per (row, KV head)
constexpr int KT = 64;           // keys per ring tile
constexpr int LOGITS_MAX_BYTES = 32768;
constexpr int SMEM_MAX = 232448;  // shared memory a block may use (227 KB)
constexpr int NWARP = NTHREAD / 32;
constexpr int MAX_PAIRS = 4;     // 16-column output pairs per warp: hd <= 256
constexpr int MAX_QV = MAX_G * 256 / 8 / NTHREAD;   // q's 16-byte pieces per thread
static_assert(KT == 16 * NWARP, "each warp takes 16 keys of a tile in the logits");
static_assert(KT == 64, "the online (m, l) update reads two logits per lane");

// Shared memory of the cluster kernel.  Rows of 16 bf16 (query rows past
// G are zero) or of KT keys; bf16 row strides are an odd number of 16-byte
// units, so the 8 rows of an ldmatrix hit distinct banks.
struct ClusterSmem {
    int hdp, ld, ldp;        // hd rounded up to 16; K/V/Q row stride; P row stride
    size_t slots, q, p, logits, mlbox, stat, part, blocks, total;
};

// ntab: the most table entries a CTA keeps (0 for a contiguous cache).
__host__ __device__ inline ClusterSmem cluster_smem(int hd, int g, int ldl, int ntab) {
    ClusterSmem m;
    m.hdp = (hd + 15) / 16 * 16;
    m.ld = m.hdp + 8;
    m.ldp = KT + 8;
    m.slots = 0;                                          // 2 x KT rows
    m.q = m.slots + (size_t)2 * KT * m.ld * 2;            // 16 rows, bf16
    m.p = m.q + (size_t)16 * m.ld * 2;                    // 16 x KT, bf16
    m.logits = m.p + (size_t)16 * m.ldp * 2;              // G x ldl, f32
    m.mlbox = m.logits + (size_t)g * ldl * 4;             // (m, l) of each rank
    m.stat = m.mlbox + (size_t)CLUSTER * MAX_G * 2 * 4;   // merged (M, L)
    m.part = m.stat + MAX_G * 2 * 4;                      // partial P.V, G x hd
    m.blocks = m.part + (size_t)g * hd * 4;               // the CTA's table entries
    m.total = m.blocks + (size_t)ntab * 4;
    return m;
}

// Where the K and V rows of (row b, KV head h) come from.  range(b) gives
// the keys [kbase, kend) that the cluster splits (kbase a multiple of 16)
// and kmin, the first key read: keys in [kbase, kmin) are masked (PAGED
// only: a contiguous range starts at its first key).  fetch(b, h, hkv,
// k0, nk, tab) has the CTA's threads copy what it needs to find the rows
// of its keys [k0, k0 + nk) into tab (PAGED: the caller then waits for
// it).  The K (V when val) row of key k0 + i is at start(val, b, h, hkv,
// hd, k0) + row(i, tab) * hd.
struct ContiguousRows {
    static constexpr bool PAGED = false;
    const bf16* k;
    const bf16* v;
    const int* kv_len;
    int c;
    __device__ __forceinline__ void range(int, int& kbase, int& kmin, int& kend) const {
        kbase = kmin = 0;
        kend = min(max(kv_len[0], 0), c);
    }
    __device__ __forceinline__ void fetch(int, int, int, int, int, int*) const {}
    __device__ __forceinline__ const bf16* start(bool val, int b, int h, int hkv, int hd,
                                                 int k0) const {
        return (val ? v : k) + (((size_t)b * hkv + h) * c + k0) * hd;
    }
    __device__ __forceinline__ size_t row(int i, const int*) const { return i; }
};

// The pool row of the first key of each of the CTA's groups of 1 <<
// gshift keys (16 when bs % 16 == 0, so that a group lies in one block,
// else 1) goes to shared memory once, its table entry read by one thread
// each, all in flight together: the ring's copies then wait on no table
// read and do no division.
struct PagedRows {
    static constexpr bool PAGED = true;
    const bf16* k;
    const bf16* v;
    const int* tables;
    const int* positions;
    int bs, mb, window, gshift;
    __device__ __forceinline__ void range(int b, int& kbase, int& kmin, int& kend) const {
        const int pos = positions[b];
        kend = max(0, min(pos + 1, mb * bs));
        kmin = window > 0 ? max(0, pos - window + 1) : 0;
        kbase = kmin & ~15;
    }
    __device__ __forceinline__ void fetch(int b, int h, int hkv, int k0, int nk, int* tab) const {
        for (int i = threadIdx.x; i < (nk + (1 << gshift) - 1) >> gshift; i += blockDim.x) {
            const int kg = k0 + (i << gshift);
            tab[i] = (tables[(size_t)b * mb + kg / bs] * hkv + h) * bs + kg % bs;
        }
    }
    __device__ __forceinline__ const bf16* start(bool val, int, int, int, int, int) const {
        return val ? v : k;
    }
    __device__ __forceinline__ size_t row(int i, const int* tab) const {
        return (size_t)tab[i >> gshift] + (i & ((1 << gshift) - 1));
    }
};

template <class Rows>
__global__ void __launch_bounds__(NTHREAD)
decode_cluster_kernel(const bf16* __restrict__ q, const Rows rows, bf16* __restrict__ out,
                      int g, int hd, int ldl, int ntab, int recompute, float scale) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_arrive();                    // this CTA has started (waited on below)
    extern __shared__ __align__(128) unsigned char smem[];
    const ClusterSmem S = cluster_smem(hd, g, ldl, ntab);
    bf16* slots = reinterpret_cast<bf16*>(smem + S.slots);
    bf16* qs = reinterpret_cast<bf16*>(smem + S.q);
    bf16* ps = reinterpret_cast<bf16*>(smem + S.p);
    float* lg = reinterpret_cast<float*>(smem + S.logits);
    float* mlbox = reinterpret_cast<float*>(smem + S.mlbox);
    float* stat = reinterpret_cast<float*>(smem + S.stat);
    float* part = reinterpret_cast<float*>(smem + S.part);
    int* tab = reinterpret_cast<int*>(smem + S.blocks);
    const int rank = static_cast<int>(cluster.block_rank());
    const int h = blockIdx.y, b = blockIdx.z, hkv = gridDim.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int nc = hd / 8, ld = S.ld, hdp = S.hdp;

    int kbase, kmin, kend;
    rows.range(b, kbase, kmin, kend);
    const int n = max(kend - kbase, 0);
    const int kc = ((n + CLUSTER - 1) / CLUSTER + 15) / 16 * 16;
    const int lo = min(rank * kc, n);
    const int nk = min(lo + kc, n) - lo;
    const int nt = (nk + KT - 1) / KT;
    const int items = nt * (recompute ? 3 : 2);
    const size_t bh = (size_t)b * hkv + h;
    const int k0 = kbase + lo;                     // this CTA's first key
    // Keys of tile t (from k0 + t * KT) read: [first(t), valid(t)).
    auto first = [&](int t) { return max(kmin - k0 - t * KT, 0); };
    auto valid = [&](int t) { return nk - t * KT; };

    // Ring item j: K tiles 0..nt-1, then V tiles (K0 V0 K1 V1 ... when
    // the logits are recomputed).  Every call commits one group, empty
    // past the last item, so "all but the newest group" is always item j
    // when item j is consumed.  A warp copies 32 / lpr rows at a time.
    const int lpr = nc <= 16 ? 16 : 32;
    auto is_v = [&](int j) { return j >= nt && (!recompute || ((j - nt) & 1)); };
    auto tile = [&](int j) { return j < nt ? j : recompute ? (j - nt) >> 1 : j - nt; };
    auto slot = [&](int j) { return slots + (j & 1) * KT * ld; };
    const int r0 = warp * (32 / lpr) + lane / lpr;   // this thread's first row of a tile
    auto issue = [&](int j) {
        const int c8 = lane % lpr;
        if (j < items && c8 < nc) {
            const int t = tile(j), lo_in = first(t), hi_in = valid(t);
            const bf16* src = rows.start(is_v(j), b, h, hkv, hd, k0) + c8 * 8;
            bf16* dst = slot(j) + c8 * 8;
            for (int r = r0; r < KT; r += NTHREAD / lpr) {
                const bool in = r < hi_in && (!Rows::PAGED || r >= lo_in);
                cp_async16(dst + r * ld, in ? src + rows.row(t * KT + r, tab) * hd : src, in);
            }
        }
        cp_async_commit();
    };
    // s = q.k * scale for the tile's keys (-inf outside [lo_in, hi_in))
    // into dst (row stride ldl): warp w takes keys 16w..16w+15, two
    // m16n8k16 per 16 columns of hd, the query rows as A.
    auto logits = [&](const bf16* ks, float* dst, int lo_in, int hi_in) {
        float s[2][4] = {};
        for (int kk = 0; kk < hdp / 16; ++kk) {
            uint32_t a[4], bk[4];
            ldsm_x4(a, qs + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
            ldsm_x4(bk, ks + (warp * 16 + (lane >> 4) * 8 + (lane & 7)) * ld + kk * 16
                            + ((lane >> 3) & 1) * 8);
            mma16816(s[0], a, bk[0], bk[1]);
            mma16816(s[1], a, bk[2], bk[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = gid + 8 * (e >> 1), key = warp * 16 + 8 * j + 2 * tig + (e & 1);
                const bool in = key < hi_in && (!Rows::PAGED || key >= lo_in);
                if (row < g) dst[row * ldl + key] = in ? s[j][e] * scale : -INFINITY;
            }
    };
    // The CTA's (m, l) per query row, updated online by one tile's logits.
    float* ml = mlbox + rank * MAX_G * 2;          // this CTA's own entry
    auto update = [&](const float* src) {
        for (int gi = warp; gi < g; gi += NWARP) {
            const float x0 = src[gi * ldl + lane], x1 = src[gi * ldl + lane + 32];
            float mx = fmaxf(x0, x1);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_old = ml[2 * gi], l_old = ml[2 * gi + 1];
            const float m = fmaxf(m_old, mx);
            float sum = (x0 == -INFINITY ? 0.0f : expf(x0 - m))
                        + (x1 == -INFINITY ? 0.0f : expf(x1 - m));
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
            if (lane == 0) {
                ml[2 * gi] = m;
                ml[2 * gi + 1] = (l_old > 0.0f ? l_old * expf(m_old - m) : 0.0f) + sum;
            }
        }
    };
    // One tile's logits (from column col of src) -> P, the bf16-rounded
    // normalised probabilities (0 at -inf).
    auto probs = [&](const float* src, int col) {
        for (int i = tid; i < g * KT; i += NTHREAD) {
            const int gi = i / KT, r = i - gi * KT;
            const float s = src[gi * ldl + col + r];
            const float p = s == -INFINITY ? 0.0f
                                           : __fdiv_rn(expf(s - stat[2 * gi]), stat[2 * gi + 1]);
            ps[gi * S.ldp + r] = __float2bfloat16(p);
        }
    };
    // acc += P (16 x nv keys) . V: warp w takes the 16-column pairs w,
    // w + NWARP, ... of hd.
    float acc[MAX_PAIRS][2][4] = {};
    auto pv = [&](const bf16* vs, int nv) {
        for (int kk = 0; kk < (nv + 15) / 16; ++kk) {
            uint32_t a[4];
            ldsm_x4(a, ps + (lane & 15) * S.ldp + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int i = 0; i < MAX_PAIRS; ++i) {
                const int pair = warp + NWARP * i;
                if (pair < hdp / 16) {
                    uint32_t bv[4];
                    ldsm_x4_t(bv, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld
                                      + pair * 16 + (lane >> 4) * 8);
                    mma16816(acc[i][0], a, bv[0], bv[1]);
                    mma16816(acc[i][1], a, bv[2], bv[3]);
                }
            }
        }
    };

    // q's 16-byte pieces into registers before the ring's first copies, so
    // that they do not queue behind them; then q as 16 bf16 rows in shared
    // memory.  The ring's and q's columns past hd, q's rows past G and P's
    // rows past G stay zero.
    const uint4* qb = reinterpret_cast<const uint4*>(q + bh * g * hd);
    uint4 qv[MAX_QV];
#pragma unroll
    for (int i = 0; i < MAX_QV; ++i)
        if (tid + i * NTHREAD < g * nc) qv[i] = qb[tid + i * NTHREAD];
    rows.fetch(b, h, hkv, k0, nk, tab);
    if constexpr (Rows::PAGED) __syncthreads();
    issue(0);
    issue(1);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const int units = ld / 8;                  // 16-byte units per q/ring row
#pragma unroll
    for (int i = 0; i < MAX_QV; ++i) {
        const int u = tid + i * NTHREAD;
        if (u < g * nc)
            *reinterpret_cast<uint4*>(qs + (u / nc) * ld + (u % nc) * 8) = qv[i];
    }
    for (int u = tid; u < 16 * units; u += NTHREAD) {
        const int r = u / units, cu = u - r * units;
        if (r >= g || cu >= nc) *reinterpret_cast<uint4*>(qs + r * ld + cu * 8) = zero;
    }
    for (int u = tid; u < 2 * KT * (units - nc); u += NTHREAD) {
        const int r = u / (units - nc), cu = nc + u - r * (units - nc);
        *reinterpret_cast<uint4*>(slots + r * ld + cu * 8) = zero;
    }
    for (int u = g * (S.ldp / 8) + tid; u < 16 * (S.ldp / 8); u += NTHREAD)
        reinterpret_cast<uint4*>(ps)[u] = zero;
    for (int gi = tid; gi < g; gi += NTHREAD) {
        ml[2 * gi] = -INFINITY;
        ml[2 * gi + 1] = 0.0f;
    }

    // Phase 1: logits and the CTA's (m, l).
    for (int j = 0; j < nt; ++j) {
        cp_async_wait_prev();
        __syncthreads();
        float* dst = lg + (recompute ? 0 : j * KT);
        logits(slot(j), dst, first(j), valid(j));
        __syncthreads();
        issue(j + 2);
        update(dst);
    }

    // Every peer's (m, l) pushed into this CTA's box at its rank; then the
    // row's M and L in rank order.
    __syncthreads();
    cluster_wait();                      // every CTA of the cluster has started
    for (int i = tid; i < CLUSTER * g; i += NTHREAD) {
        const int peer = i / g, gi = i - peer * g;
        float* box = cluster.map_shared_rank(mlbox, peer) + (rank * MAX_G + gi) * 2;
        box[0] = ml[2 * gi];
        box[1] = ml[2 * gi + 1];
    }
    cluster.sync();
    for (int gi = tid; gi < g; gi += NTHREAD) {
        float m = -INFINITY;
        for (int rr = 0; rr < CLUSTER; ++rr)
            if (mlbox[(rr * MAX_G + gi) * 2 + 1] > 0.0f) m = fmaxf(m, mlbox[(rr * MAX_G + gi) * 2]);
        float l = 0.0f;
        for (int rr = 0; rr < CLUSTER; ++rr) {
            const float lr = mlbox[(rr * MAX_G + gi) * 2 + 1];
            if (lr > 0.0f) l += lr * expf(mlbox[(rr * MAX_G + gi) * 2] - m);
        }
        stat[2 * gi] = m;
        stat[2 * gi + 1] = l;
    }
    __syncthreads();

    // Phase 2: P.V, each tile's P formed from the kept logits while its V
    // lands (or from logits recomputed from K when they were not kept).
    for (int j = nt; j < items; ++j) {
        const int t = tile(j);
        if (is_v(j) && !recompute) probs(lg, t * KT);
        cp_async_wait_prev();
        __syncthreads();
        if (is_v(j)) {
            pv(slot(j), min(KT, valid(t)));
            __syncthreads();
            issue(j + 2);
        } else {
            logits(slot(j), lg, first(t), valid(t));
            __syncthreads();
            issue(j + 2);
            probs(lg, 0);
        }
    }

    // This CTA's partial (rows < G, columns < hd) into its own shared
    // memory; cluster.sync(); the owner of each slice of the G*hd outputs
    // adds the CLUSTER partials in rank order from its peers' shared
    // memory and writes bf16 out; a last cluster barrier keeps every
    // CTA's shared memory alive until its peers have read it.
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
        const int pair = warp + NWARP * i;
        if (pair >= hdp / 16) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
                const int row = gid + 8 * (e >> 1), d = pair * 16 + 8 * j + 2 * tig;
                if (row < g && d < hd)
                    *reinterpret_cast<float2*>(part + row * hd + d) =
                        make_float2(acc[i][j][e], acc[i][j][e + 1]);
            }
    }
    cluster.sync();
    const int total = g * hd, per = (total + CLUSTER - 1) / CLUSTER;
    const int o1 = min((rank + 1) * per, total);
    for (int o = rank * per + tid; o < o1; o += NTHREAD) {
        float a = 0.0f;
#pragma unroll
        for (int rr = 0; rr < CLUSTER; ++rr) a += cluster.map_shared_rank(part, rr)[o];
        out[bh * total + o] = __float2bfloat16(a);
    }
    cluster_arrive();
    cluster_wait();
}

// One cluster launch; c is the longest key range a row can have.
template <class Rows>
int launch_cluster(const bf16* q, const Rows& rows, bf16* out, int b, int hkv, int g, int hd,
                   int c, float scale, cudaStream_t stream) {
    if (g > MAX_G || hd > MAX_PAIRS * NWARP * 16) return static_cast<int>(cudaErrorInvalidValue);
    // The logits are kept when they fit for the longest range c allows.
    const int kc_max = ((c + CLUSTER - 1) / CLUSTER + 15) / 16 * 16;
    const int tiles_max = (kc_max + KT - 1) / KT;
    const int recompute = (size_t)g * tiles_max * KT * 4 > LOGITS_MAX_BYTES;
    const int ldl = recompute ? KT : tiles_max * KT;
    // A paged CTA's table: an entry for every group its tiles span.
    int ntab = 0;
    if constexpr (Rows::PAGED) ntab = tiles_max * KT >> rows.gshift;
    const size_t smem = cluster_smem(hd, g, ldl, ntab).total;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER, hkv, b);
    cfg.blockDim = dim3(NTHREAD);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;

    // Once per device: allow the most shared memory a block may have (and
    // a cluster past the portable 8); once per device and larger shared
    // memory than checked so far (checked[0]): make sure one cluster fits
    // on the card.
    static PerDevice<1> checked_of;
    int* checked = nullptr;
    if (const int err = checked_of.get(checked, [](int, int* v) {
            cudaError_t e = cudaSuccess;
            if (CLUSTER > 8)
                e = cudaFuncSetAttribute(decode_cluster_kernel<Rows>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (e == cudaSuccess)
                e = cudaFuncSetAttribute(decode_cluster_kernel<Rows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_MAX);
            v[0] = 0;
            return e;
        }))
        return err;
    if (smem > static_cast<size_t>(SMEM_MAX)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSuccess;
    if (smem > static_cast<size_t>(checked[0])) {
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, decode_cluster_kernel<Rows>, &cfg);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
        checked[0] = static_cast<int>(smem);
    }
    err = cudaLaunchKernelEx(&cfg, decode_cluster_kernel<Rows>, q, rows, out, g, hd, ldl, ntab,
                             recompute, scale);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,Hkv,G,hd), pools (NB,Hkv,bs,hd), out (B,Hkv,G,hd): bf16,
// contiguous, 16-byte aligned; tables (B,MB) and positions (B,) int32 on
// the card.  hd % 8 == 0, hd <= 256, G <= 16.  window <= 0 means no
// window.  No scratch: one cluster launch.
extern "C" int flash_decode_paged_bf16(const void* q, const void* k_pool, const void* v_pool,
                                       const void* tables, const void* positions, void* out,
                                       int b, int hkv, int g, int hd, int bs, int mb,
                                       float scale, int window, void* stream) {
    const PagedRows rows{static_cast<const bf16*>(k_pool), static_cast<const bf16*>(v_pool),
                         static_cast<const int*>(tables), static_cast<const int*>(positions),
                         bs, mb, window, bs % 16 == 0 ? 4 : 0};
    return launch_cluster(static_cast<const bf16*>(q), rows, static_cast<bf16*>(out), b, hkv, g,
                          hd, mb * bs, scale, static_cast<cudaStream_t>(stream));
}

// q (B,Hkv,G,hd), k/v (B,Hkv,C,hd), out (B,Hkv,G,hd): bf16, contiguous,
// 16-byte aligned; kv_len (1,) int32 on the card, 0 <= kv_len <= C.
// hd % 8 == 0, hd <= 256, G <= 16.  No scratch: one cluster launch.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* kv_len, void* out, int b, int hkv, int g,
                                 int hd, int c, float scale, void* stream) {
    const ContiguousRows rows{static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                              static_cast<const int*>(kv_len), c};
    return launch_cluster(static_cast<const bf16*>(q), rows, static_cast<bf16*>(out), b, hkv, g,
                          hd, c, scale, static_cast<cudaStream_t>(stream));
}
