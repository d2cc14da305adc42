// Fused-dequant Q8_0 matmul for Hopper (sm_90a): a streaming decode path
// for M <= M_GEMV and a tensor-core tile path above it.
//
// Replaces: src/repro/kernels/q8_matmul.py :: q8_matmul (_dequant_kernel).
//   y(M,N) f32 = x(M,K) bf16 @ W(N,K)^T,  W[n,k] = bf16(qs[n,k] * d[n,k/32]),
//   d the fp16 block scales of the Q8_0 tensor, widened to f32.
//   Each weight is rounded to bf16 before the product, as the Pallas
//   kernel does; products accumulate in f32.
//
// What bounds it on the H100: at decode (M = 1..16) the weight bytes
// (8.5 bits/weight) and nothing else: Granite-8B's (4,14336,4096) reads
// 62 MB, 18.6 us at 3.35 TB/s.  At the UNet's M = B*h*w (up to 8192 rows)
// the tensor cores.
//
// Decode path (M <= M_GEMV, q8_gemv_kernel), on the plan of q4_matmul.cu's
// q4_gemv_kernel.  A CTA owns GEMV_ROWS = 16 weight rows, the A operand of
// mma.sync m16n8k16; the tokens are B (n = 8 columns, two column groups
// when M > 8).  The warps are interleaved over K steps of 4 Q8_0 blocks
// (128 elements); lane (gid, tig) takes block 4*step + tig of rows gid and
// gid + 8: 32 code bytes (two 16-byte loads) and the fp16 scale per row,
// and x[gid][that block] (four 16-byte loads).  Code word i of a block
// (elements 4i..4i+3) is one mma step: its pairs (4i, 4i+1) and (4i+2,
// 4i+3) are the lane's A registers, and x words 2i and 2i+1 of the same
// block are B as they lie in memory.
// Unpack in f32, exact for every (d, q): xor with 0x80808080 makes each
// byte q + 128, a byte permute puts it under the exponent byte 0x4B (the
// f32 2^23 + 128 + q), minus 2^23 + 128 gives q, q * d (at most 18
// significant bits) is exact in f32, and cvt.rn.bf16x2.f32 rounds each
// product once, as the reference does: 3.75 instructions per weight.  The
// q4 trick (bf16x2 fma with d = dh + dl) is not exact here: for |q| up to
// 128, q * dl needs up to 10 significant bits and rounds in bf16.  At the
// byte rate (3.35 TB/s of 8.5-bit weights, ~13.6 weights per SM-clock) an
// SM can issue ~9.4 thread instructions per weight, so the unpack leaves
// the kernel bound by its bytes.
// Software pipeline: a warp fetches the codes of its next GEMV_UNROLL K
// steps before it unpacks the current ones; x, which L1/L2 hold, is read
// at its step.
// CTA rule: 16 rows per CTA, grid ceil(N / 16), warps = min(8, ceil(K /
// 128)) interleaved over the K steps.  Granite-8B's decode shapes give
// 896 CTAs (N = 14336), 256 (N = 4096), 64 (N = 1024) and 3072 (the
// 49152-row head).
// M_GEMV = 16, two token groups, as far as the decode path's registers
// go: it was faster than the earlier WMMA tile path at M = 1, 4, 8 and 16
// on the H100 (PERF.md); not yet measured against the wgmma tile path.
// Determinism: each warp accumulates its K steps in order in the mma's
// f32 registers; the warps' partial tiles are added in warp order through
// shared memory.  No atomics, no split across CTAs.
// Edges: rows >= N, blocks past K/32 and tokens >= M are never read; their
// codes and scales are zero, so their A and B values are 0.
//
// Tile path (M > M_GEMV, the Pallas kernel's large-M calls): common.cuh's
// tile_kernel with the Q8Tile format below.  At Granite-8B's 256-token
// prefill chunk and the UNet's M = 154..8192 the product is bound by the
// tensor cores (at the UNet's K = 320 the f32 y is most of the bytes).
// Warp-specialised CTAs of 256 x 128 (or 128 x 128, 128 x 64, 64 x 64 by
// the CTA rule) on wgmma, fed by producer warps through a cp.async ring of
// x tiles, code bytes and scale words; each 64-weight K step (two Q8_0
// blocks) is unpacked once per CTA by the exact f32 route of the decode
// path into a swizzled bf16 tile.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int M_GEMV = 16;       // decode path for M <= M_GEMV
constexpr int GEMV_ROWS = 16;    // weight rows per CTA: the m16 of the mma
constexpr int GEMV_WARPS = 8;    // most warps per CTA
constexpr int GEMV_UNROLL = 2;   // K steps of loads issued before their math

// One K step's codes and scales for a lane: block 4*step + tig of rows
// gid and gid + 8, 32 bytes each.
struct Codes {
    uint4 q[2][2];
    __half d[2];
};

// Elements from one expert's x, codes, scales and y to the next's in a
// batched call (csrc/common.cuh's Batch; all 0 for a two-dimensional one).
struct ExpertStrides {
    size_t x, q, d, y;
};

// NT column groups of 8 tokens (M <= 8 * NT).
template <int NT>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
q8_gemv_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
               const __half* __restrict__ wd, float* __restrict__ y,
               int M, int N, int K, ExpertStrides es) {
    __shared__ float red[GEMV_WARPS][GEMV_ROWS * 8 * NT];
    // Expert blockIdx.z of a batched call (0 otherwise).
    x += blockIdx.z * es.x;
    wq += blockIdx.z * es.q;
    wd += blockIdx.z * es.d;
    y += blockIdx.z * es.y;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarp = blockDim.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int n0 = blockIdx.x * GEMV_ROWS;
    const int nblk = K / 32, nstep = (nblk + 3) / 4;
    const int rows[2] = {n0 + gid, n0 + gid + 8};

    // The codes of steps st0 + u * nwarp (zero past K or N: nothing read).
    auto fetch = [&](Codes (&c)[GEMV_UNROLL], int st0) {
#pragma unroll
        for (int u = 0; u < GEMV_UNROLL; ++u) {
            const int st = st0 + u * nwarp, blk = 4 * st + tig;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                c[u].q[r][0] = c[u].q[r][1] = make_uint4(0u, 0u, 0u, 0u);
                c[u].d[r] = __ushort_as_half(0);
                if (st < nstep && blk < nblk && rows[r] < N) {
                    const uint4* src = reinterpret_cast<const uint4*>(
                        wq + (size_t)rows[r] * K + (size_t)blk * 32);
                    c[u].q[r][0] = src[0];
                    c[u].q[r][1] = src[1];
                    c[u].d[r] = wd[(size_t)rows[r] * nblk + blk];
                }
            }
        }
    };

    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[t][i] = 0.0f;

    // Software pipeline: the next steps' codes are in flight while these
    // are unpacked; x comes from L1/L2 at its step.
    Codes cur[GEMV_UNROLL], nxt[GEMV_UNROLL];
    fetch(cur, warp);
    for (int st0 = warp; st0 < nstep; st0 += nwarp * GEMV_UNROLL) {
        fetch(nxt, st0 + nwarp * GEMV_UNROLL);
#pragma unroll
        for (int u = 0; u < GEMV_UNROLL; ++u) {
            const int st = st0 + u * nwarp, blk = 4 * st + tig;
            uint4 xv[NT][4];
#pragma unroll
            for (int t = 0; t < NT; ++t) {
                const int m = gid + 8 * t;
                const bool live = st < nstep && blk < nblk && m < M;
                const uint4* src = reinterpret_cast<const uint4*>(
                    x + (size_t)m * K + (size_t)blk * 32);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    xv[t][j] = live ? src[j] : make_uint4(0u, 0u, 0u, 0u);
            }
            const float d0 = __half2float(cur[u].d[0]), d1 = __half2float(cur[u].d[1]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {       // code word i: one mma step
                uint32_t r0[2], r1[2];
                q8_unpack_word(word(cur[u].q[0][i >> 2], i & 3), d0, r0);
                q8_unpack_word(word(cur[u].q[1][i >> 2], i & 3), d1, r1);
                const uint32_t a[4] = {r0[0], r1[0], r0[1], r1[1]};
#pragma unroll
                for (int t = 0; t < NT; ++t)
                    mma16816(acc[t], a, word(xv[t][i >> 1], 2 * (i & 1)),
                             word(xv[t][i >> 1], 2 * (i & 1) + 1));
            }
        }
#pragma unroll
        for (int u = 0; u < GEMV_UNROLL; ++u) cur[u] = nxt[u];
    }
    gemv_store(acc, red, y, M, N, n0);
}

// Tile path (M > M_GEMV): common.cuh's tile_kernel on this format.  A
// ring slot holds the K step's 64 code bytes of each of the BN rows (four
// 16-byte copies) and the step's scale words (common.cuh's TileScales).
// A unit is 16 weights of one row (chunks 2j and 2j + 1, block j / 2),
// unpacked by q8_unpack_word's exact f32 route into two 16-byte stores.
// Blocks past K / 32 and rows past N load as zero bytes: scale 0, weight
// 0.
struct Q8Tile {
    const int8_t* wq;
    const __half* wd;
    size_t sq = 0, sd = 0;      // per-expert strides of a batched call
    __device__ Q8Tile expert(size_t e) const { return {wq + e * sq, wd + e * sd, sq, sd}; }
    __host__ __device__ static constexpr int raw_bytes(int BN) { return BN * (TILE_BK + 8); }
    __host__ __device__ static constexpr int extra_bytes(int) { return 0; }

    template <int BN, int NP>
    struct Producer {
        static constexpr int CODES = BN * 4 / NP;   // 16-byte code copies
        static constexpr int UNITS = BN * 4 / NP;
        static constexpr int ROWS = NP / 4;         // rows per pass
        const int8_t* wq;       // source of zero-filled copies
        const int8_t* code;     // chunk t % 4 of row t / 4, K step 0
        TileScales<BN, NP> sc;
        int n0, N, K, t;

        __device__ __forceinline__ Producer(const Q8Tile& fmt, int n0_, int N_, int K_, int t_,
                                            unsigned char*)
            : wq(fmt.wq), sc(fmt.wd, n0_, N_, K_, t_), n0(n0_), N(N_), K(K_), t(t_) {
            code = wq + (size_t)(n0 + (t >> 2)) * K + 16 * (t & 3);
        }

        __device__ __forceinline__ void load(unsigned char* raw, int k) const {
            const int k0 = k * TILE_BK;
            const bool kin = k0 + 16 * (t & 3) < K;
#pragma unroll
            for (int it = 0; it < CODES; ++it) {
                const int r = (t >> 2) + ROWS * it;
                const bool in = kin && n0 + r < N;
                cp_async16(raw + TILE_BK * r + 16 * (t & 3),
                           in ? code + (size_t)ROWS * K * it + k0 : wq, in);
            }
            sc.load(raw + BN * TILE_BK, k);
        }

        __device__ __forceinline__ void unpack(const unsigned char* raw, bf16* wt, int) const {
#pragma unroll
            for (int u = 0; u < UNITS; ++u) {
                const int i = t + NP * u, r = i >> 2, j = i & 3;
                const uint4 q = *reinterpret_cast<const uint4*>(raw + TILE_BK * r + 16 * j);
                const float d = sc.get(raw + BN * TILE_BK, u);
                uint32_t v[8];
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                    uint32_t p[2];
                    q8_unpack_word(word(q, w), d, p);
                    v[2 * w] = p[0];
                    v[2 * w + 1] = p[1];
                }
                *reinterpret_cast<uint4*>(wt + tile_swz(r, 2 * j)) =
                    make_uint4(v[0], v[1], v[2], v[3]);
                *reinterpret_cast<uint4*>(wt + tile_swz(r, 2 * j + 1)) =
                    make_uint4(v[4], v[5], v[6], v[7]);
            }
        }
    };
};

}  // namespace

namespace {

int q8_launch(const void* x, const void* wq, const void* wd, void* y, int M, int N, int K,
              const ExpertStrides& es, int E, cudaStream_t st) {
    const bf16* xb = static_cast<const bf16*>(x);
    const int8_t* q = static_cast<const int8_t*>(wq);
    const __half* d = static_cast<const __half*>(wd);
    float* out = static_cast<float*>(y);
    if (M <= M_GEMV) {
        const int steps = (K / 32 + 3) / 4;
        const int threads = 32 * (steps < GEMV_WARPS ? (steps > 0 ? steps : 1) : GEMV_WARPS);
        const dim3 grid((N + GEMV_ROWS - 1) / GEMV_ROWS, 1, E);
        if (M <= 8)
            q8_gemv_kernel<1><<<grid, threads, 0, st>>>(xb, q, d, out, M, N, K, es);
        else
            q8_gemv_kernel<2><<<grid, threads, 0, st>>>(xb, q, d, out, M, N, K, es);
        return static_cast<int>(cudaGetLastError());
    }
    return tile_launch(xb, Q8Tile{q, d, es.q, es.d}, out, M, N, K, st, Batch{E, es.x, es.y});
}

}  // namespace

// x: (M,K) bf16, wq: (N,K) int8, wd: (N,K/32) fp16, y: (M,N) f32.
// K % 32 == 0; x, wq and wd 16-byte aligned (the wrapper makes them so).
extern "C" int q8_matmul_bf16(const void* x, const void* wq, const void* wd, void* y,
                              int M, int N, int K, void* stream) {
    return q8_launch(x, wq, wd, y, M, N, K, ExpertStrides{0, 0, 0, 0}, 1,
                     static_cast<cudaStream_t>(stream));
}

// E experts in one launch (the reference's vmap of the kernel over an MoE
// layer's experts): expert e multiplies x + e sx (M,K) by the weight at
// wq + e sq, wd + e sd (N,K) into y + e sy (M,N); strides in elements.
// Each expert's arrays are aligned as the two-dimensional entry's (the
// wrapper makes them so).
extern "C" int q8_matmul_bf16_experts(const void* x, const void* wq, const void* wd, void* y,
                                      int E, int M, int N, int K, long long sx, long long sq,
                                      long long sd, long long sy, void* stream) {
    return q8_launch(x, wq, wd, y, M, N, K,
                     ExpertStrides{(size_t)sx, (size_t)sq, (size_t)sd, (size_t)sy}, E,
                     static_cast<cudaStream_t>(stream));
}
