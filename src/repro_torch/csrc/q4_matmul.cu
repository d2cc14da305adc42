// Fused-unpack Q4_0 matmul for Hopper (sm_90a): a streaming decode path
// for M <= M_GEMV and a tensor-core tile path above it.
//
// Replaces: src/repro/kernels/q4_matmul.py :: q4_matmul (_q4_kernel).
//   y(M,N) f32 = x(M,K) bf16 @ W(N,K)^T,
//   W[n,k] = bf16((nibble(qs[n,k/2], k%2) - 8) * d[n,k/32]),
//   byte j of a row holding elements 2j (low nibble) and 2j+1 (high
//   nibble), d the fp16 block scales of the Q4_0 tensor widened to f32.
//   Each weight is rounded to bf16 before the product, as the Pallas
//   kernel does; products accumulate in f32.
//
// What bounds it on the H100: at decode (M = 1..16) the weight bytes
// (4.5 bits/weight) and nothing else: Granite-8B's (4,14336,4096) reads
// 33 MB, 9.9 us at 3.35 TB/s.  At the UNet's M = B*h*w the tensor cores.
//
// Decode path (M <= M_GEMV, q4_gemv_kernel).  A CTA owns GEMV_ROWS = 16
// weight rows and its warps split K; each warp streams whole Q4_0 blocks
// and multiplies them on the tensor cores with mma.sync m16n8k16, the 16
// weight rows as the A operand and the tokens as B (n = 8 columns, two
// column groups when M > 8).  K is summed in any order the operands
// agree on, so each lane takes whole blocks: lane (gid, tig) loads the
// 16 code bytes of block 4*step + tig of rows gid and gid+8 (16-byte
// loads, 64 contiguous bytes per row and warp), and x[gid][that block]
// (four 16-byte loads).  Each 32-bit word of codes (elements 8i..8i+7)
// feeds two mma steps: masking nibbles j and j+4 with 0x000F000F puts
// elements (j, j+4) in one register, so the steps take the pairs (0,4),
// (1,5) and (2,6), (3,7), and a byte permute pairs x the same way.
// Unpacking is in bf16x2 registers: 0x4300 | q is the bf16 128 + q, minus
// 136 gives q - 8 exactly, and with the scale split as d = dh + dl (dh =
// bf16(d), dl exact in bf16) one fma.rn(q - 8, dh, (q - 8) * dl) is
// bf16((q - 8) * d) rounded once, as the reference rounds it.  That is 5
// instructions per two weights, where the f32 route (nibble | 0x4B000000,
// subtract, multiply, cvt.rn.bf16x2) takes about 4.5 per weight.  At the
// byte rate (3.35 TB/s of 4.5-bit weights, ~23 weights per SM-clock) an
// SM can issue ~5.6 thread instructions per weight, so the f32 route
// would nearly fill the issue slots, and an f32 FMA per weight and token
// on the CUDA cores in place of the mma would add M more.  x reuse: each
// x value a lane loads serves the 16 rows of its warp's tile, so the x
// read from L1/L2 is ceil(N/16) * M * K * 2 bytes, M / 4.5 times the
// weight bytes (0.9x at M = 4), where 4 rows per x load would make it
// 3.6x.
// Software pipeline: a warp fetches the codes of its next GEMV_UNROLL = 2
// K steps (2 KB) before it unpacks the current ones, so a warp always
// has codes in flight; x, which L1/L2 hold, is read at its step.
// CTA rule: 16 rows per CTA, grid ceil(N / 16), warps = min(8, ceil(K /
// 128)) interleaved over the 128-element K steps.  Granite-8B's decode
// shapes give 896 CTAs (N = 14336) and 256 (N = 4096); the latter is 1.9
// per SM, and since the kernel is bound by device memory, not by its SMs,
// the 8 SMs with one CTA do not hold it back (both shapes measured the
// same time, PERF.md).
// M_GEMV = 16, two token groups, as far as the decode path's registers
// go: it was faster than the tile path at M = 1, 4, 8 and 16 on the H100
// (PERF.md).
// Determinism: each warp accumulates its K steps in order in the mma's
// f32 registers; the warps' partial tiles are added in warp order through
// shared memory.  No atomics, no split across CTAs.
// Edges: rows >= N, blocks past K/32 and tokens >= M are never read; their
// codes and scales are zero, so their A and B values are 0.
//
// Tile path (M > M_GEMV, the Pallas kernel's large-M calls: the UNet's
// linears under q4_0, make_prefill's): common.cuh's tile_kernel, the
// warp-specialised wgmma kernel of q8_matmul.cu and q3k_matmul.cu, with
// the Q4Tile format below.  Q4_0 keeps its scales as Q8_0 does (fp16, one
// per 32 weights), so the ring slot's scale words and the CTA rule are
// Q8_0's; a row's K step is 32 code bytes where Q8_0 has 64, so four ring
// slots fit at 256 x 128 (three under Q8_0).
#include "common.cuh"

using namespace repro;

namespace {

constexpr int M_GEMV = 16;       // decode path for M <= M_GEMV
constexpr int GEMV_ROWS = 16;    // weight rows per CTA: the m16 of the mma
constexpr int GEMV_WARPS = 8;    // most warps per CTA
constexpr int GEMV_UNROLL = 2;   // K steps of loads issued before their math

// Word w of a block's codes holds its elements 8i..8i+7, element e in
// bits 4e..4e+3.  r[j] gets elements j and j + 4 as a bf16 pair, each
// bf16((q - 8) * d) in one rounding: 0x4300 | q is the bf16 128 + q, minus
// 136 gives q - 8 exactly; d = dh + dl with dh = bf16(d) and dl = d - dh
// (at most 3 significant bits, exact in bf16), (q - 8) * dl is exact, and
// fma.rn((q - 8), dh, (q - 8) * dl) rounds the exact (q - 8) * d once.
__device__ __forceinline__ void unpack_word(uint32_t w, __nv_bfloat162 dh,
                                            __nv_bfloat162 dl, uint32_t (&r)[4]) {
    const __nv_bfloat162 bias = __float2bfloat162_rn(136.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const uint32_t bits = ((w >> (4 * j)) & 0x000F000Fu) | 0x43004300u;
        const __nv_bfloat162 q = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits), bias);
        const __nv_bfloat162 v = __hfma2(q, dh, __hmul2(q, dl));
        r[j] = *reinterpret_cast<const uint32_t*>(&v);
    }
}

// A block scale split into bf16 pairs dh = bf16(d) and dl = d - dh.
__device__ __forceinline__ void split_scale(__half d16, __nv_bfloat162& dh,
                                            __nv_bfloat162& dl) {
    const float d = __half2float(d16);
    const __nv_bfloat16 hi = __float2bfloat16_rn(d);
    dh = __bfloat162bfloat162(hi);
    dl = __bfloat162bfloat162(__float2bfloat16_rn(d - __bfloat162float(hi)));
}

// One K step's codes and scales for a lane: block 4*step + tig of rows
// gid and gid + 8.
struct Codes {
    uint4 q[2];
    __half d[2];
};

// NT column groups of 8 tokens (M <= 8 * NT).
template <int NT>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
q4_gemv_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ qs,
               const __half* __restrict__ wd, float* __restrict__ y,
               int M, int N, int K) {
    __shared__ float red[GEMV_WARPS][GEMV_ROWS * 8 * NT];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarp = blockDim.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int n0 = blockIdx.x * GEMV_ROWS;
    const int nblk = K / 32, nstep = (nblk + 3) / 4;
    const size_t row_bytes = (size_t)K / 2;
    const int rows[2] = {n0 + gid, n0 + gid + 8};

    // The codes of steps st0 + u * nwarp (zero past K or N: nothing read).
    auto fetch = [&](Codes (&c)[GEMV_UNROLL], int st0) {
#pragma unroll
        for (int u = 0; u < GEMV_UNROLL; ++u) {
            const int st = st0 + u * nwarp, blk = 4 * st + tig;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                c[u].q[r] = make_uint4(0u, 0u, 0u, 0u);
                c[u].d[r] = __ushort_as_half(0);
                if (st < nstep && blk < nblk && rows[r] < N) {
                    c[u].q[r] = *reinterpret_cast<const uint4*>(
                        qs + (size_t)rows[r] * row_bytes + (size_t)blk * 16);
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
            __nv_bfloat162 dh[2], dl[2];
            split_scale(cur[u].d[0], dh[0], dl[0]);
            split_scale(cur[u].d[1], dh[1], dl[1]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {       // elements 8i..8i+7: two mma steps
                uint32_t r0[4], r1[4];
                unpack_word(word(cur[u].q[0], i), dh[0], dl[0], r0);
                unpack_word(word(cur[u].q[1], i), dh[1], dl[1], r1);
#pragma unroll
                for (int h = 0; h < 2; ++h) {   // pairs (2h, 2h+4) and (2h+1, 2h+5)
                    const uint32_t a[4] = {r0[2 * h], r1[2 * h], r0[2 * h + 1], r1[2 * h + 1]};
#pragma unroll
                    for (int t = 0; t < NT; ++t) {
                        const uint32_t lo = word(xv[t][i], h), hi = word(xv[t][i], h + 2);
                        mma16816(acc[t], a, __byte_perm(lo, hi, 0x5410),
                                 __byte_perm(lo, hi, 0x7632));
                    }
                }
            }
        }
#pragma unroll
        for (int u = 0; u < GEMV_UNROLL; ++u) cur[u] = nxt[u];
    }
    gemv_store(acc, red, y, M, N, n0);
}

// Tile path (M > M_GEMV): common.cuh's tile_kernel on this format.  A
// ring slot holds the K step's 32 code bytes of each of the BN rows (two
// 16-byte copies) and the step's scale words (common.cuh's TileScales).
// A unit is 16 weights of one row (8 code bytes, block j / 2 of the
// step), written as two swizzled 16-byte chunks in natural K order, as
// wgmma pairs them with x.  Byte p of a code word holds elements 2p (low
// nibble) and 2p + 1 (high nibble): one byte permute of the word and the
// word shifted by 4 puts them at bits 0 and 16, and the decode path's
// bf16x2 route makes the pair: 0x4300 | q is the bf16 128 + q, minus 136
// gives q - 8 exactly, and fma.rn(q - 8, dh, (q - 8) * dl) with d = dh +
// dl rounds the exact (q - 8) * d once.  Here dh is d cut to bf16 toward
// zero and dl = d - dh carries d's sign (at most 3 significant bits,
// exact in bf16, so (q - 8) * dl is exact): for q = 8 both terms are
// zeros of d's sign, so even a zero weight has the reference's bits
// (bf16((q - 8) * d) = -0 for d < 0).  About 2.6 instructions per weight.
// Blocks past K / 32 and rows past N load as zero bytes: scale 0, weight
// -8 * 0 = 0.
struct Q4Tile {
    const uint8_t* qs;
    const __half* wd;
    // q4_matmul has no batched entry (the expert matmul does not take Q4_0,
    // as in the reference): every call is expert 0.
    __device__ Q4Tile expert(size_t) const { return *this; }
    __host__ __device__ static constexpr int raw_bytes(int BN) { return BN * (TILE_BK / 2 + 8); }
    __host__ __device__ static constexpr int extra_bytes(int) { return 0; }

    template <int BN, int NP>
    struct Producer {
        static constexpr int RB = TILE_BK / 2;              // code bytes of a row per step
        static constexpr int CODES = (BN * 2 + NP - 1) / NP;  // 16-byte code copies
        static constexpr int UNITS = BN * 4 / NP;
        const uint8_t* qs;      // source of zero-filled copies
        const uint8_t* code;    // half t % 2 of row t / 2, K step 0
        TileScales<BN, NP> sc;
        int n0, N, K, t;

        __device__ __forceinline__ Producer(const Q4Tile& fmt, int n0_, int N_, int K_, int t_,
                                            unsigned char*)
            : qs(fmt.qs), sc(fmt.wd, n0_, N_, K_, t_), n0(n0_), N(N_), K(K_), t(t_) {
            code = qs + (size_t)(n0 + (t >> 1)) * (K / 2) + 16 * (t & 1);
        }

        __device__ __forceinline__ void load(unsigned char* raw, int k) const {
            const int b0 = k * RB;
            const bool kin = b0 + 16 * (t & 1) < K / 2;
#pragma unroll
            for (int it = 0; it < CODES; ++it) {
                const int i = t + NP * it;                   // row i / 2, half i % 2
                if (i < BN * 2) {
                    const bool in = kin && n0 + (i >> 1) < N;
                    cp_async16(raw + RB * (i >> 1) + 16 * (t & 1),
                               in ? code + (size_t)(NP / 2) * (K / 2) * it + b0 : qs, in);
                }
            }
            sc.load(raw + BN * RB, k);
        }

        __device__ __forceinline__ void unpack(const unsigned char* raw, bf16* wt, int) const {
            const __nv_bfloat162 bias = __float2bfloat162_rn(136.0f);
#pragma unroll
            for (int u = 0; u < UNITS; ++u) {
                const int i = t + NP * u, r = i >> 2, j = i & 3;
                const uint2 q = *reinterpret_cast<const uint2*>(raw + RB * r + 8 * j);
                const float d = sc.get(raw + BN * RB, u);
                const float dhf = __uint_as_float(__float_as_uint(d) & 0xFFFF0000u);
                const float dlf = copysignf(__fsub_rn(d, dhf), d);
                const __nv_bfloat162 dh = __bfloat162bfloat162(__float2bfloat16_rn(dhf));
                const __nv_bfloat162 dl = __bfloat162bfloat162(__float2bfloat16_rn(dlf));
                uint32_t v[8];
#pragma unroll
                for (int w = 0; w < 2; ++w) {               // elements 8w .. 8w + 7
                    const uint32_t lo = w ? q.y : q.x, hi = lo >> 4;
#pragma unroll
                    for (int p = 0; p < 4; ++p) {           // elements 8w + 2p, + 1
                        const uint32_t bits =
                            (__byte_perm(lo, hi, p | (4 + p) << 8) & 0x000F000Fu) | 0x43004300u;
                        const __nv_bfloat162 qm =
                            __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits), bias);
                        const __nv_bfloat162 e = __hfma2(qm, dh, __hmul2(qm, dl));
                        v[4 * w + p] = *reinterpret_cast<const uint32_t*>(&e);
                    }
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

// x: (M,K) bf16, qs: (N,K/2) uint8, wd: (N,K/32) fp16, y: (M,N) f32.
// K % 32 == 0; x, qs and wd 16-byte aligned (the wrapper makes them so).
extern "C" int q4_matmul_bf16(const void* x, const void* qs, const void* wd, void* y,
                              int M, int N, int K, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bf16* xb = static_cast<const bf16*>(x);
    const uint8_t* q = static_cast<const uint8_t*>(qs);
    const __half* d = static_cast<const __half*>(wd);
    float* out = static_cast<float*>(y);
    if (M <= M_GEMV) {
        const int steps = (K / 32 + 3) / 4;
        const int threads = 32 * (steps < GEMV_WARPS ? (steps > 0 ? steps : 1) : GEMV_WARPS);
        const dim3 grid((N + GEMV_ROWS - 1) / GEMV_ROWS);
        if (M <= 8)
            q4_gemv_kernel<1><<<grid, threads, 0, st>>>(xb, q, d, out, M, N, K);
        else
            q4_gemv_kernel<2><<<grid, threads, 0, st>>>(xb, q, d, out, M, N, K);
        return static_cast<int>(cudaGetLastError());
    }
    return tile_launch(xb, Q4Tile{q, d}, out, M, N, K, st);
}
