// Integer-path Q8_0 x Q8_0 matmul (w8a8) for Hopper (sm_90a): int8 tensor
// cores (mma.sync m16n8k32, s8 in, s32 out) on whole Q8_0 blocks, with a
// streaming decode path for M <= M_GEMV and a tile path above it.
//
// Replaces: src/repro/kernels/q8_matmul.py :: q8_matmul_w8a8 (_w8a8_kernel),
// the paper's OP_SML8 (int8 x int8 products) / OP_AD24 (integer sums)
// dataflow:
//   y[m,n] = sum_b (xq[m,b,:] . wq[n,b,:])_int32 * xs[m,b] * ws[n,b]
// over the K/32 blocks b; xq (M,K) and wq (N,K) int8, xs (M,K/32) f32, ws
// (N,K/32) fp16 (the Q8_0 tensor's scales, widened to f32).
//
// Arithmetic, the same on both paths.  The k = 32 of one mma is one Q8_0
// block: it gives every (row, column) of its 16 x 8 fragment the block's
// exact int32 dot (|dot| <= 32 * 128 * 128 = 2^19).  Its C operand adds
// W8A8_MAGIC = 0x4B400000 to each dot, so the int32 it returns is the f32
// 1.5 * 2^23 + dot (exact for |dot| < 2^22), and one FADD of -1.5 * 2^23
// gives float(dot) exactly, without I2F (a quarter-rate instruction).  Each
// term is rounded as the reference rounds it, (float(dot) * xs) * ws, and
// added to the output's f32 sum: four FP32 instructions per (m, n, block),
// no contraction.  Every output's terms are added in block order from 0.0,
// so y is the block-order sum of the reference's terms bit for bit, on both
// paths and on every run (as the earlier dp4a kernel's was).
//
// What bounds it on the H100:
// - Decode (M <= 16): the weight bytes, 8.5 bits per weight.  Granite-8B's
//   (4, 14336, 4096) and (4, 4096, 14336) read 62.4 MB, 18.7 us at 3.35
//   TB/s; their 4 * 14336 * 128 terms are small beside that.
// - Tile (M > 16): not the tensor cores.  At (256, 14336, 4096) the bytes
//   are 78.3 MB (23.4 us) and the int8 products 3.0e10 (15.2 us at 1,979
//   TOP/s), but the per-block scaling is f32 work on the CUDA cores: 4.7e8
//   terms of a multiply, a multiply and an add are 1.41e9 instructions, 42
//   us at 128 lanes x 132 SMs x 1.98 GHz (the epilogue floor); with the
//   exact conversion's FADD, 1.88e9 and 56 us.  Measured on an H100 80GB
//   HBM3 at 700 W (tools/kernel_ab.py, PERF.md): the slots' copies alone
//   take 0.061 ms there (every CTA reads all of x from L2: about 190 MB into
//   the SMs) and the multiplies alone 0.124 ms; the kernel, 0.167 ms,
//   overlaps them only in part.
//
// Design: a CTA owns a tile of y and all of K, and each output's terms are
// added in block order by one thread (no atomics, no split of K across
// CTAs).  Operands are int8 rows in shared memory, read with ldmatrix (an 8
// x 8 b16 matrix is 8 rows of 16 bytes, the s8 fragment layout, so the k
// positions need no permutation), filled by a cp.async ring of STAGES
// slots; code rows lie KB * 32 + 16 bytes apart, so the 8 rows of each
// ldmatrix phase fall in 8 distinct 16-byte bank groups.  xs is copied
// transposed ([block][row] f32); ws as the aligned 4-byte words that hold a
// row's fp16 scales (a scale is the half its own address names; the
// array's last word is read only as far as the array goes).
// - Decode path (M <= M_GEMV, w8a8_gemv_kernel), on the plan of
//   q8_gemv_kernel: a row group of 16 weight rows is the mma's A, the tokens
//   are B (n = 8 columns, two groups when M > 8).  Slots of GEMV_KB = 32
//   blocks (1 KB of each weight row: longer runs per row read faster, 8 and
//   16 blocks were slower); warp w multiplies blocks w, w + 8, ... of each
//   slot and writes its terms to shared memory, and after the slot 16 * 8 NG
//   threads add them in block order (so the warps' terms go in warp order).
//   The loads in flight are the ring's (3 slots ahead at M <= 5: 48 KB per
//   CTA, two CTAs per SM), not registers; the tokens' rows come through L1
//   (cp.async.ca: the SM's next row groups read them again).  A CTA takes
//   ceil(G / (2 x SMs)) of the G row groups one after another through its
//   ring; an uneven split over all resident CTAs was slower.  Bulk (TMA) 1D
//   copies of the code rows were slower than cp.async here.
// - Tile path (M > M_GEMV, w8a8_tile_kernel): KB = 2, 4 slots; CTA tiles of
//   256 x 112 (16 warps of 32 x 56), 128 x 80, 64 x 80 and 64 x 64, chosen
//   by the CTA rule in q8_matmul_w8a8_s8 (rates measured): Granite-
//   8B's (256, 14336, 4096) gives 128 CTAs of 256 x 112 (each weight tile
//   read once), the UNet's (4096, 320, 320) 256 CTAs of 64 x 80.  The M
//   tiles of a weight tile are neighbours in the grid and share its reads in
//   L2.  Each slot's scales are converted to f32 once per CTA, a slot ahead.
//   Tried and not kept (PERF.md): contracting (dot * xs) * ws + acc into
//   FMUL + FFMA (-6.5%, one rounding fewer), an exact one-FFMA product for
//   scales with 1.5 xs exact (slower: two slot bodies spill), 6 slots, 4
//   blocks per slot, 8 warps of 64 x 56 (255 registers, spills).
// - mma.sync and not wgmma: a wgmma k-step would also be one block, but its
//   accumulators would have to be read and cleared after every block (a
//   wgmma.wait per block, or a second accumulator set of ~128 registers);
//   mma.sync hands the dots to the issuing warp, which scales them while
//   its next mma runs.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int M_GEMV = 16;              // decode path for M <= M_GEMV
constexpr int W8A8_MAGIC = 0x4B400000;  // f32 1.5 * 2^23; + dot is f32 1.5 * 2^23 + dot
// CTA rule of the tile path: a wave of OCC x SMs CTAs of a tile takes
// OCC * BM * BN over the tile's rate (as common.cuh's tile_launch).  Rates:
// each tile alone at (256, 14336, 4096), outputs per SM and ms relative to
// 256 x 112, tools/kernel_ab.py on an NVIDIA H100 80GB HBM3 at 700 W; 128 x
// 80 runs a partial second wave there and keeps an estimate.
constexpr int W8A8_RATE_256x112 = 100;
constexpr int W8A8_RATE_128x80 = 96;
constexpr int W8A8_RATE_64x80 = 79;
constexpr int W8A8_RATE_64x64 = 77;

// Decode path: 16 weight rows (the mma's A) and NG groups of 8 tokens (its
// B) per row group; GEMV_WARPS warps; slots of GEMV_KB blocks, warp w
// multiplying blocks w, w + GEMV_WARPS, ... of each slot.  Shared memory:
// the slot's terms [KB][16][8 NG] f32, then STAGES slots, each (bytes) the
// weight codes (16 rows RS apart), the scale words, xs [KB][8 NG] f32 and
// the codes of the M token rows (runtime: M * RS bytes), then a guard of
// 8 NG - M rows that the tokens' ldmatrix reads past row M.
constexpr int GEMV_WARPS = 8;
constexpr int GEMV_KB = 32;
template <int NG_, int STAGES_>
struct W8Gemv {
    static constexpr int NG = NG_, STAGES = STAGES_, TOK = 8 * NG_, KB = GEMV_KB;
    static constexpr int THREADS = 32 * GEMV_WARPS, BPW = KB / GEMV_WARPS;
    static constexpr int RS = KB * 32 + 16, WPR = KB / 2 + 1, BN = 16;
    static constexpr int WQ = 0, WS = 16 * RS, XS = WS + 4 * WPR * 16, XQ = XS + 4 * KB * TOK;
    static constexpr int RING = 4 * KB * 16 * TOK;          // bytes before the ring
    __host__ __device__ static constexpr int slot(int M) { return XQ + M * RS; }
    __host__ __device__ static constexpr int smem(int M) {
        return RING + STAGES * slot(M) + (TOK - M) * RS;
    }
    static_assert(KB % GEMV_WARPS == 0 && (KB & (KB - 1)) == 0, "blocks per warp");
    static_assert(STAGES >= 2 && smem(TOK) <= TILE_SMEM_MAX, "ring");
};
// One token group: two rings, of GEMV_STAGES1 and one more slot (the rule
// in q8_matmul_w8a8_s8 picks one).  Two token groups: one ring of
// GEMV_STAGES2 slots (with one more, one CTA fits on an H100 SM where two
// fit without it, and the rule would never take it).
constexpr int GEMV_STAGES1 = 3;
constexpr int GEMV_STAGES2 = 2;
using Gemv1S3 = W8Gemv<1, GEMV_STAGES1>;
using Gemv1S4 = W8Gemv<1, GEMV_STAGES1 + 1>;
using Gemv2S2 = W8Gemv<2, GEMV_STAGES2>;

// Tile path: WM x WN warps of MT m16 x NT n8 fragments (BM = 16 MT WM
// tokens, BN = 8 NT WN weight rows), KB blocks per slot, STAGES slots, OCC
// CTAs per SM.  A slot (bytes from its start): x codes, weight codes (rows
// RS = KB * 32 + 16 bytes apart: the 8 rows of an ldmatrix phase fall in 8
// distinct 16-byte bank groups), xs as [KB][BM] f32, the WPR = KB / 2 + 1
// aligned words per weight row that hold its KB fp16 scales, and those
// scales as f32 [KB][BN], converted once per CTA.
template <int MT_, int NT_, int WM_, int WN_, int KB_, int STAGES_, int OCC_>
struct W8Tile {
    static constexpr int MT = MT_, NT = NT_, WN = WN_, KB = KB_, STAGES = STAGES_, OCC = OCC_;
    static constexpr int THREADS = 32 * WM_ * WN_, BM = 16 * MT * WM_, BN = 8 * NT * WN_;
    static constexpr int RS = KB * 32 + 16, WPR = KB / 2 + 1;
    static constexpr int XQ = 0, WQ = BM * RS, XS = WQ + BN * RS, WS = XS + 4 * KB * BM;
    static constexpr int WSF = (WS + 4 * WPR * BN + 15) / 16 * 16;
    static constexpr int SLOT = (WSF + 4 * KB * BN + 15) / 16 * 16;
    static constexpr int SMEM = STAGES * SLOT;
    static_assert(KB >= 2 && (KB & (KB - 1)) == 0 && STAGES >= 3 && SMEM <= TILE_SMEM_MAX,
                  "ring");
};

using T256x112 = W8Tile<2, 7, 8, 2, 2, 4, 1>;   // 16 warps of 32 x 56
using T128x80 = W8Tile<2, 5, 4, 2, 2, 4, 2>;
using T64x80 = W8Tile<1, 5, 4, 2, 2, 4, 2>;
using T64x64 = W8Tile<1, 4, 4, 2, 2, 4, 2>;

// float(dot) from the mma's d = dot + MAGIC, exactly.
__device__ __forceinline__ float w8a8_dot(int d) {
    return __fsub_rn(__int_as_float(d), 12582912.0f);
}
// (float(dot) * xs) * ws, each product rounded once: the reference's term.
__device__ __forceinline__ float w8a8_term(int d, float xs, float ws) {
    return __fmul_rn(__fmul_rn(w8a8_dot(d), xs), ws);
}

// Copy the scale words of one slot of weight row n: word w (to dst + 4 w
// BN) holds the scales of the slot's blocks 2w - par and 2w + 1 - par, par
// the parity of the row's first scale address / 2, for w < WPR; words that
// hold no scale of the slot's nb blocks are not copied.  A word may begin 2
// bytes before the tensor, inside its allocation (only a tensor at an offset
// has an address of 2 mod 4); the array's last word is read only as far as
// the array goes (wend).
template <int BN>
__device__ __forceinline__ void w8a8_copy_scales(unsigned char* dst, uintptr_t wsa,
                                                 uintptr_t wend, int n, int nblk, int kb0,
                                                 int nb, int w) {
    const uintptr_t a = wsa + 2 * ((uintptr_t)n * nblk + kb0);
    const int par = static_cast<int>(a >> 1) & 1;
    const uintptr_t wa = (a & ~(uintptr_t)3) + 4 * w;
    if (2 * w - par < nb)
        cp_async4_n(dst + 4 * w * BN, reinterpret_cast<const void*>(wa),
                    wend - wa >= 4 ? 4 : static_cast<int>(wend - wa));
}

// Copy slot s of the ring: blocks s KB .. s KB + KB - 1 of the CTA's rows
// below M (tokens from m0) and below N (weight rows from n0).  Codes and xs
// of blocks past nblk are zero-filled (no read); the scale words as
// w8a8_copy_scales copies them.
template <class S>
__device__ __forceinline__ void w8a8_copy(unsigned char* slot, const int8_t* __restrict__ xq,
                                          const float* __restrict__ xs,
                                          const int8_t* __restrict__ wq, uintptr_t wsa,
                                          uintptr_t wend, int M, int N, int K, int m0, int n0,
                                          int s) {
    const int tid = threadIdx.x, nblk = K / 32;
    const int kb0 = s * S::KB, nb = min(S::KB, nblk - kb0);
    constexpr int CH = 2 * S::KB;              // 16-byte chunks per code row
#pragma unroll
    for (int it = 0; it < (S::BM * CH + S::THREADS - 1) / S::THREADS; ++it) {
        const int i = tid + S::THREADS * it, r = i / CH, c = i % CH;
        if (i < S::BM * CH && m0 + r < M)
            cp_async16(slot + S::XQ + r * S::RS + 16 * c,
                       c < 2 * nb ? xq + (size_t)(m0 + r) * K + 32 * kb0 + 16 * c : xq,
                       c < 2 * nb);
    }
#pragma unroll
    for (int it = 0; it < (S::BN * CH + S::THREADS - 1) / S::THREADS; ++it) {
        const int i = tid + S::THREADS * it, r = i / CH, c = i % CH;
        if (i < S::BN * CH && n0 + r < N)
            cp_async16(slot + S::WQ + r * S::RS + 16 * c,
                       c < 2 * nb ? wq + (size_t)(n0 + r) * K + 32 * kb0 + 16 * c : wq,
                       c < 2 * nb);
    }
#pragma unroll
    for (int it = 0; it < (S::BM * S::KB + S::THREADS - 1) / S::THREADS; ++it) {
        const int i = tid + S::THREADS * it, r = i / S::KB, j = i % S::KB;
        if (i < S::BM * S::KB && m0 + r < M)
            cp_async4(slot + S::XS + 4 * (j * S::BM + r),
                      j < nb ? xs + (size_t)(m0 + r) * nblk + kb0 + j : xs, j < nb);
    }
#pragma unroll
    for (int it = 0; it < (S::BN * S::WPR + S::THREADS - 1) / S::THREADS; ++it) {
        const int i = tid + S::THREADS * it, r = i / S::WPR, w = i % S::WPR;
        if (i < S::BN * S::WPR && n0 + r < N)
            w8a8_copy_scales<S::BN>(slot + S::WS + 4 * r, wsa, wend, n0 + r, nblk, kb0, nb, w);
    }
}

// The fp16 scale of weight row r (CTA-relative) and block j of a slot, from
// the slot's words; par: the row's parity (see w8a8_copy).
template <class S>
__device__ __forceinline__ float w8a8_scale(const unsigned char* slot, int r, int j, int par) {
    const int h = j + par;
    return __half2float(*reinterpret_cast<const __half*>(
        slot + S::WS + 4 * ((h >> 1) * S::BN + r) + 2 * (h & 1)));
}

// ------------------------------------------------------------ tile path

// One slot of the tile path: KB blocks of the warp's MT x NT fragments.  No
// branch inside a slot: rows past M or N hold whatever the slot held (their
// outputs are not stored); blocks past nblk have zero codes, xs and scales,
// so their terms are +0.0 and change no sum.
template <class T>
__device__ __forceinline__ void w8a8_tile_slot(const unsigned char* slot, int a_off, int b_off,
                                               int xs_off, int ws_off,
                                               float (&acc)[T::MT][T::NT][4]) {
#pragma unroll
    for (int j = 0; j < T::KB; ++j) {
        uint32_t b[T::NT][2];
#pragma unroll
        for (int p = 0; p < T::NT / 2; ++p) {
            uint32_t r[4];
            ldsm_x4(r, reinterpret_cast<const bf16*>(slot + b_off + 16 * p * T::RS + 32 * j));
            b[2 * p][0] = r[0];
            b[2 * p][1] = r[1];
            b[2 * p + 1][0] = r[2];
            b[2 * p + 1][1] = r[3];
        }
        if constexpr (T::NT % 2 == 1) {
            uint32_t r[2];
            ldsm_x2(r, slot + b_off + 16 * (T::NT / 2) * T::RS + 32 * j);
            b[T::NT - 1][0] = r[0];
            b[T::NT - 1][1] = r[1];
        }
        float2 wv[T::NT];
#pragma unroll
        for (int jn = 0; jn < T::NT; ++jn)
            wv[jn] = *reinterpret_cast<const float2*>(slot + ws_off + 4 * (j * T::BN + 8 * jn));
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
            uint32_t a[4];
            ldsm_x4(a, reinterpret_cast<const bf16*>(slot + a_off + 16 * i * T::RS + 32 * j));
            const float* xsp =
                reinterpret_cast<const float*>(slot + xs_off + 4 * (j * T::BM + 16 * i));
            const float x[2] = {xsp[0], xsp[8]};
#pragma unroll
            for (int jn = 0; jn < T::NT; ++jn) {
                int d[4];
                mma_s8_16832(d, a, b[jn][0], b[jn][1], W8A8_MAGIC);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    acc[i][jn][e] = __fadd_rn(acc[i][jn][e],
                                              w8a8_term(d[e], x[e >> 1], e & 1 ? wv[jn].y : wv[jn].x));
            }
        }
    }
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::OCC)
w8a8_tile_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ wq, const __half* __restrict__ ws,
                 float* __restrict__ y, int M, int N, int K) {
    extern __shared__ __align__(16) unsigned char w8a8_smem[];
    unsigned char* smem = w8a8_smem;
    const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
    const int nblk = K / 32, nslot = (nblk + T::KB - 1) / T::KB;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int mw = (warp / T::WN) * 16 * T::MT, nw = (warp % T::WN) * 8 * T::NT;
    const uintptr_t wsa = reinterpret_cast<uintptr_t>(ws);
    const uintptr_t wend = wsa + 2 * (uintptr_t)N * nblk;
    auto slot_of = [&](int s) { return smem + (s % T::STAGES) * T::SLOT; };
    auto copy = [&](int s) {
        if (s < nslot)
            w8a8_copy<T>(slot_of(s), xq, xs, wq, wsa, wend, M, N, K, m0, n0, s);
        cp_async_commit();
    };
    // Slot s's scales as f32 [KB][BN]: 0 past nblk and N.
    auto convert = [&](int s) {
        if (s >= nslot) return;
        unsigned char* slot = slot_of(s);
        const int nb = min(T::KB, nblk - s * T::KB);
#pragma unroll
        for (int it = 0; it < (T::KB * T::BN + T::THREADS - 1) / T::THREADS; ++it) {
            const int i = tid + T::THREADS * it, j = i / T::BN, c = i % T::BN;
            if (i < T::KB * T::BN) {
                const int par = static_cast<int>(((wsa >> 1) + (uintptr_t)(n0 + c) * nblk) & 1);
                const bool in = j < nb && n0 + c < N;
                reinterpret_cast<float*>(slot + T::WSF)[i] =
                    in ? w8a8_scale<T>(slot, c, j, par) : 0.0f;
            }
        }
    };

    float acc[T::MT][T::NT][4];
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int jn = 0; jn < T::NT; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.0f;

    // This lane's ldmatrix rows (A: token rows, B: weight rows), xs and scales.
    const int a_off = T::XQ + (mw + (lane & 15)) * T::RS + 16 * (lane >> 4);
    const int b_off = T::WQ + (nw + (lane & 7) + ((lane >> 4) << 3)) * T::RS + 16 * ((lane >> 3) & 1);
    const int xs_off = T::XS + 4 * (mw + gid);
    const int ws_off = T::WSF + 4 * (nw + 2 * tig);
    const bool live = n0 + nw < N;      // the warp has columns below N

#pragma unroll
    for (int s = 0; s < T::STAGES - 1; ++s) copy(s);
    cp_async_wait_n<T::STAGES - 2>();
    __syncthreads();
    convert(0);
    for (int s = 0; s < nslot; ++s) {
        cp_async_wait_n<T::STAGES - 3>();   // slot s + 1 landed for this thread ...
        __syncthreads();                    // ... and for all; slot s converted; s - 1 free
        copy(s + T::STAGES - 1);
        convert(s + 1);
        if (live) w8a8_tile_slot<T>(slot_of(s), a_off, b_off, xs_off, ws_off, acc);
    }
    cp_async_wait_all();

    // acc[i][jn][e]: token m0 + mw + 16 i + gid + 8 (e / 2), weight row
    // n0 + nw + 8 jn + 2 tig + e % 2 (the mma's C layout).
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = m0 + mw + 16 * i + gid + 8 * h;
            if (r >= M) continue;
            float* yr = y + (size_t)r * N;
#pragma unroll
            for (int jn = 0; jn < T::NT; ++jn) {
                const int c = n0 + nw + 8 * jn + 2 * tig;
                const float v0 = acc[i][jn][2 * h], v1 = acc[i][jn][2 * h + 1];
                if ((N & 1) == 0) {
                    if (c < N) *reinterpret_cast<float2*>(yr + c) = make_float2(v0, v1);
                } else {
                    if (c < N) yr[c] = v0;
                    if (c + 1 < N) yr[c + 1] = v1;
                }
            }
        }
}

// ---------------------------------------------------------- decode path

// Row groups [blockIdx.x * per, + per) of 16 weight rows, one after the
// other through one ring: item i is slot i % nslot of row group i / nslot.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 2)
w8a8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ wq, const __half* __restrict__ ws,
                 float* __restrict__ y, int M, int N, int K, int per) {
    extern __shared__ __align__(16) unsigned char w8a8_smem[];
    unsigned char* smem = w8a8_smem;
    float* terms = reinterpret_cast<float*>(smem);        // [KB][16][TOK]
    const int nblk = K / 32, nslot = (nblk + T::KB - 1) / T::KB;
    const int ngrp = (N + 15) / 16;
    const int rg0 = blockIdx.x * per, rg1 = min(rg0 + per, ngrp);
    const int items = nslot * max(0, rg1 - rg0);
    const int slot_bytes = T::slot(M);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const uintptr_t wsa = reinterpret_cast<uintptr_t>(ws);
    const uintptr_t wend = wsa + 2 * (uintptr_t)N * nblk;
    auto slot_of = [&](int i) { return smem + T::RING + (i % T::STAGES) * slot_bytes; };

    // Item i's weight codes and scale words, and the tokens' codes and xs
    // (blocks past nblk are not copied: the fold leaves them out).
    auto copy = [&](int i) {
        if (i < items) {
            unsigned char* slot = slot_of(i);
            const int g = i / nslot, sl = i - g * nslot;
            const int grp = rg0 + g, kb0 = sl * T::KB, nb = min(T::KB, nblk - kb0);
            constexpr int CH = 2 * T::KB;
#pragma unroll
            for (int it = 0; it < 16 * CH / T::THREADS; ++it) {
                const int c = tid % CH, r = tid / CH + it * (T::THREADS / CH);
                const int n = 16 * grp + r;
                if (c < 2 * nb && n < N)
                    cp_async16(slot + T::WQ + r * T::RS + 16 * c,
                               wq + (size_t)n * K + 32 * kb0 + 16 * c, true);
            }
            for (int i2 = tid; i2 < M * CH; i2 += T::THREADS) {
                const int r = i2 / CH, c = i2 % CH;
                if (c < 2 * nb) {
                    unsigned char* dst = slot + T::XQ + r * T::RS + 16 * c;
                    const int8_t* src = xq + (size_t)r * K + 32 * kb0 + 16 * c;
                    cp_async16_ca(dst, src);    // read again by the SM's next row groups
                }
            }
            for (int i2 = tid; i2 < M * T::KB; i2 += T::THREADS) {
                const int r = i2 / T::KB, j = i2 % T::KB;
                if (j < nb)
                    cp_async4(slot + T::XS + 4 * (j * T::TOK + r), xs + (size_t)r * nblk + kb0 + j,
                              true);
            }
            for (int i2 = tid; i2 < 16 * T::WPR; i2 += T::THREADS) {
                const int r = i2 / T::WPR, w = i2 % T::WPR;
                const int n = 16 * grp + r;
                if (n < N)
                    w8a8_copy_scales<T::BN>(slot + T::WS + 4 * r, wsa, wend, n, nblk, kb0, nb, w);
            }
        }
        cp_async_commit();
    };

    // Warp w multiplies blocks w + GEMV_WARPS q of each slot: weight rows as
    // A (ldmatrix x4 of 16 rows), tokens as B (x2: tokens 0-7; x4: and 8-15).
    const int a_off = T::WQ + (lane & 15) * T::RS + 16 * (lane >> 4) + 32 * warp;
    const int b_off = T::XQ + ((lane & 7) + ((lane >> 4) << 3)) * T::RS + 16 * ((lane >> 3) & 1) +
                      32 * warp;
    // The fold: thread t < 16 TOK owns weight row t / TOK, token t % TOK.
    const bool folds = tid < 16 * T::TOK;
    float acc = 0.0f;

#pragma unroll
    for (int i = 0; i < T::STAGES - 1; ++i) copy(i);
    for (int i = 0; i < items; ++i) {
        const int g = i / nslot, sl = i - g * nslot;
        const int grp = rg0 + g, nb = min(T::KB, nblk - sl * T::KB);
        cp_async_wait_n<T::STAGES - 2>();   // item i landed for this thread ...
        __syncthreads();                    // ... and for all; the terms of i - 1 are folded
        copy(i + T::STAGES - 1);
        const unsigned char* slot = slot_of(i);
        int par[2];                         // rows gid and gid + 8
#pragma unroll
        for (int h = 0; h < 2; ++h)
            par[h] = static_cast<int>(((wsa >> 1) + (uintptr_t)(16 * grp + gid + 8 * h) * nblk) & 1);
#pragma unroll
        for (int q = 0; q < T::BPW; ++q) {
            const int j = warp + GEMV_WARPS * q;
            uint32_t a[4], b[2 * T::NG];
            ldsm_x4(a, reinterpret_cast<const bf16*>(slot + a_off + 32 * GEMV_WARPS * q));
            if constexpr (T::NG == 1) {
                uint32_t r[2];
                ldsm_x2(r, slot + b_off + 32 * GEMV_WARPS * q);
                b[0] = r[0];
                b[1] = r[1];
            } else {
                uint32_t r[4];
                ldsm_x4(r, reinterpret_cast<const bf16*>(slot + b_off + 32 * GEMV_WARPS * q));
#pragma unroll
                for (int k = 0; k < 4; ++k) b[k] = r[k];
            }
            const float w[2] = {w8a8_scale<T>(slot, gid, j, par[0]),
                                w8a8_scale<T>(slot, gid + 8, j, par[1])};
            float* tb = terms + j * 16 * T::TOK;
#pragma unroll
            for (int gg = 0; gg < T::NG; ++gg) {
                int d[4];
                mma_s8_16832(d, a, b[2 * gg], b[2 * gg + 1], W8A8_MAGIC);
                const int tok = 8 * gg + 2 * tig;
                const float2 xv =
                    *reinterpret_cast<const float2*>(slot + T::XS + 4 * (j * T::TOK + tok));
                // d[0..1]: weight row gid, tokens tok, tok + 1; d[2..3]: row gid + 8.
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    *reinterpret_cast<float2*>(tb + (gid + 8 * h) * T::TOK + tok) =
                        make_float2(w8a8_term(d[2 * h], xv.x, w[h]),
                                    w8a8_term(d[2 * h + 1], xv.y, w[h]));
            }
        }
        __syncthreads();                    // the slot's terms are written
        if (folds) {
            for (int jj = 0; jj < nb; ++jj) acc = __fadd_rn(acc, terms[jj * 16 * T::TOK + tid]);
            if (sl == nslot - 1) {          // the row group's last slot
                const int row = tid / T::TOK, tok = tid % T::TOK;
                const int n = 16 * grp + row;
                if (tok < M && n < N) y[(size_t)tok * N + n] = acc;
                acc = 0.0f;
            }
        }
    }
    cp_async_wait_all();
    if (nslot == 0 && folds) {               // K = 0: the empty sums
        const int row = tid / T::TOK, tok = tid % T::TOK;
        for (int g = rg0; g < rg1; ++g)
            if (tok < M && 16 * g + row < N) y[(size_t)tok * N + 16 * g + row] = 0.0f;
    }
}

struct Args {
    const int8_t* xq;
    const float* xs;
    const int8_t* wq;
    const __half* ws;
    float* y;
    int M, N, K;
    cudaStream_t st;
};

template <class T>
void run_gemv(const Args& a, int ctas, int per) {
    w8a8_gemv_kernel<T><<<ctas, T::THREADS, T::smem(a.M), a.st>>>(a.xq, a.xs, a.wq, a.ws, a.y,
                                                                   a.M, a.N, a.K, per);
}

template <class T>
void run_tile(const Args& a) {
    // M tiles first: the CTAs that share a weight tile run side by side.
    const dim3 grid((a.M + T::BM - 1) / T::BM, (a.N + T::BN - 1) / T::BN);
    w8a8_tile_kernel<T><<<grid, T::THREADS, T::SMEM, a.st>>>(a.xq, a.xs, a.wq, a.ws, a.y, a.M,
                                                             a.N, a.K);
}

template <class Kernel>
cudaError_t smem_limit(Kernel* fn, int bytes) {
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// xq: (M,K) int8, xs: (M,K/32) f32, wq: (N,K) int8, ws: (N,K/32) fp16,
// y: (M,N) f32.  K % 32 == 0; xq and wq 16-byte aligned (the wrapper
// checks both).
extern "C" int q8_matmul_w8a8_s8(const void* xq, const void* xs, const void* wq,
                                 const void* ws, void* y, int M, int N, int K,
                                 void* stream) {
    // Per device: the SM count, the shared memory of an SM and the part of
    // it each block leaves to the system.
    static PerDevice<3> dev_of;
    int* dev = nullptr;
    if (const int err = dev_of.get(dev, [](int d, int* v) {
            cudaError_t e = cudaDeviceGetAttribute(&v[0], cudaDevAttrMultiProcessorCount, d);
            if (e == cudaSuccess)
                e = cudaDeviceGetAttribute(&v[1], cudaDevAttrMaxSharedMemoryPerMultiprocessor, d);
            if (e == cudaSuccess)
                e = cudaDeviceGetAttribute(&v[2], cudaDevAttrReservedSharedMemoryPerBlock, d);
            if (e == cudaSuccess) e = smem_limit(w8a8_gemv_kernel<Gemv1S3>, Gemv1S3::smem(8));
            if (e == cudaSuccess) e = smem_limit(w8a8_gemv_kernel<Gemv1S4>, Gemv1S4::smem(8));
            if (e == cudaSuccess) e = smem_limit(w8a8_gemv_kernel<Gemv2S2>, Gemv2S2::smem(16));
            if (e == cudaSuccess) e = smem_limit(w8a8_tile_kernel<T256x112>, T256x112::SMEM);
            if (e == cudaSuccess) e = smem_limit(w8a8_tile_kernel<T128x80>, T128x80::SMEM);
            if (e == cudaSuccess) e = smem_limit(w8a8_tile_kernel<T64x80>, T64x80::SMEM);
            if (e == cudaSuccess) e = smem_limit(w8a8_tile_kernel<T64x64>, T64x64::SMEM);
            return e;
        }))
        return err;
    const int sms = dev[0];
    const Args a{static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
                 static_cast<const int8_t*>(wq), static_cast<const __half*>(ws),
                 static_cast<float*>(y), M, N, K, static_cast<cudaStream_t>(stream)};
    if (M <= M_GEMV) {
        // One token group: the ring with the most slots in flight per SM
        // (CTAs per SM, at most two, times slots ahead; ties to more CTAs).
        // Then every CTA takes the same number of row groups, as few as fill
        // the SMs (an uneven split over every CTA that fits was slower).
        auto occ = [&](int smem) { return min(2, dev[1] / (smem + dev[2])); };
        const int groups = (N + 15) / 16;
        auto split = [&](int o, auto run) {
            const int per = (groups + o * sms - 1) / (o * sms);
            run((groups + per - 1) / per, per);
        };
        if (M > 8) {
            split(occ(Gemv2S2::smem(M)), [&](int c, int p) { run_gemv<Gemv2S2>(a, c, p); });
        } else {
            const int occ_a = occ(Gemv1S4::smem(M)), occ_b = occ(Gemv1S3::smem(M));
            const int st = Gemv1S4::STAGES;
            const bool deep = occ_a * (st - 1) > occ_b * (st - 2) ||
                              (occ_a * (st - 1) == occ_b * (st - 2) && occ_a >= occ_b);
            if (deep)
                split(occ_a, [&](int c, int p) { run_gemv<Gemv1S4>(a, c, p); });
            else
                split(occ_b, [&](int c, int p) { run_gemv<Gemv1S3>(a, c, p); });
        }
        return static_cast<int>(cudaGetLastError());
    }
    // The tile with the least time: waves of OCC CTAs per SM times a wave's
    // time; ties go to the earlier (larger) tile.
    auto cost = [&](int bm, int bn, int occ, int rate) {
        const long long ctas = (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
        const long long wave = (long long)occ * sms;
        return (ctas + wave - 1) / wave * (occ * bm * bn * 1000LL / rate);
    };
    const long long c[4] = {cost(256, 112, T256x112::OCC, W8A8_RATE_256x112),
                            cost(128, 80, T128x80::OCC, W8A8_RATE_128x80),
                            cost(64, 80, T64x80::OCC, W8A8_RATE_64x80),
                            cost(64, 64, T64x64::OCC, W8A8_RATE_64x64)};
    int best = 0;
    for (int i = 1; i < 4; ++i)
        if (c[i] < c[best]) best = i;
    switch (best) {
        case 0: run_tile<T256x112>(a); break;
        case 1: run_tile<T128x80>(a); break;
        case 2: run_tile<T64x80>(a); break;
        default: run_tile<T64x64>(a); break;
    }
    return static_cast<int>(cudaGetLastError());
}
