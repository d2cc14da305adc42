// Fused-unpack Q3_K matmul for Hopper (sm_90a): a streaming decode path
// for M <= M_GEMV and a tensor-core tile path above it.
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
// What bounds it on the H100: at decode (M = 1..16) the 3.4375
// bits/weight of packed storage in principle: Granite-8B's (4,14336,4096)
// reads 25 MB, 7.6 us at 3.35 TB/s, about 33.7 weights per SM-clock, which
// leaves ~3.8 thread instructions per weight.  The decode path below needs
// more than that (see "What holds it back").  The UNet's large-M products
// are bound by the tensor cores.
//
// Decode path (M <= M_GEMV, q3k_gemv_kernel), on the plan of q4_matmul.cu's
// q4_gemv_kernel.  A CTA owns GEMV_ROWS = 16 weight rows, the A operand of
// mma.sync m16n8k16; the tokens are B (n = 8 columns, two column groups
// when M > 8).  One K step is one 256-weight super-block; the warps are
// interleaved over the steps.  Lane (gid, tig) takes quarter tig of the
// super-block (its sub-blocks 4tig..4tig+3, 64 weights) of rows gid and
// gid + 8: 16 bytes of ql, 8 of qh, the two aligned words that hold the
// 3 scale bytes of group tig (its four 6-bit codes) and d.
// Pairing: a bf16x2 A register holds element j of sub-blocks s and s + 1
// (s = 4tig + 2p), so the scales pack the same way: eff = d * (sc - 32)
// per sub-block (exact in f32: at most 17 significant bits), eh =
// bf16(eff) and el = bf16(eff - eh), one cvt.rn.bf16x2 each for the two
// sub-blocks.  Per byte group b (elements 4b..4b+3) one byte permute puts
// byte b of the ql words of s and s + 1 16 bits apart, and one the h-bit
// nibble of both (qh word p holds s's h bits at bits 0..15 and s + 1's at
// 16..31).  Element 4b + i's field c = low | h << 2 goes to mantissa bits
// P..P+2, P = 2i for i < 3 (the codes need no shift) and 4 for i = 3:
// 0x4300 | c << P is the bf16 128 + c * 2^P, minus 128 + 4 * 2^P gives
// q * 2^P exactly, and with eh and el scaled by 2^-P (exact),
// fma.rn(q 2^P, eh 2^-P, q 2^P * el 2^-P) is bf16(q * eff) rounded once,
// as the reference rounds it (exhaustive over d, sc and q:
// tests/test_torch_gemv_tiling.py).  x of sub-blocks s and s + 1 is the B
// operand, paired by two byte permutes per mma.
// What holds it back: its instructions and the x operand, not its 3.4
// bits per weight.  A pair of weights takes 7 instructions in the unpack
// (ptxas gives the masks and the exponent bits three lop3, then a shift,
// hsub2, hmul2, hfma2), plus the byte permutes of codes and x and the
// scales: about 4.3 per weight against the ~3.8 the byte rate leaves, and
// the shifts, lop3 and permutes issue at half the rate of the bf16x2
// operations.  Each CTA also reads all of x, M * K * 2 bytes, about the
// weight bytes at M = 4 (PERF.md gives the variants measured).
// Software pipeline: a warp fetches the codes of its next GEMV_UNROLL = 1
// K step before it unpacks the current one; x, which L1/L2 hold, is read
// at its step (held in registers a step ahead it was no faster).
// CTA rule: 16 rows per CTA, grid ceil(N / 16), warps = min(8, K / 256)
// interleaved over the super-blocks.  Granite-8B's decode shapes give 896
// CTAs (N = 14336), 256 (N = 4096) and 64 (N = 1024).
// M_GEMV = 16, two token groups, as far as the decode path's registers
// go: it was faster than the earlier WMMA tile path at M = 1, 4, 8 and 16
// on the H100 (PERF.md); not yet measured against the wgmma tile path.
// Determinism: each warp accumulates its K steps in order in the mma's
// f32 registers; the warps' partial tiles are added in warp order through
// shared memory.  No atomics, no split across CTAs.
// Edges: K % 256 == 0, so every step is whole; a warp skips steps past
// K.  Rows past N read row N - 1 and tokens past M token M - 1, in bounds;
// those sums are never stored.
//
// Tile path (M > M_GEMV, the Pallas kernel's large-M calls): common.cuh's
// tile_kernel with the Q3KTile format below.  At Granite-8B's 256-token
// prefill chunk and the UNet's M = 154..8192 the product is bound by the
// tensor cores.  Warp-specialised CTAs of 256 x 128 (or 128 x 128, 128 x
// 64, 64 x 64 by the CTA rule) on wgmma, fed by producer warps through a
// cp.async ring of x tiles and packed bytes; each 64-weight K step (a
// quarter super-block) is unpacked once per CTA in bf16x2 (the decode
// path's route, paired along K) into a swizzled bf16 tile.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int M_GEMV = 16;       // decode path for M <= M_GEMV
constexpr int GEMV_ROWS = 16;    // weight rows per CTA: the m16 of the mma
constexpr int GEMV_WARPS = 8;    // most warps per CTA
constexpr int GEMV_UNROLL = 1;   // K steps of loads issued before their math

// eh and el of sub-blocks 2p and 2p + 1 of a lane's quarter, in the low
// and high half; sc holds the group's four 6-bit codes at bits 6i.
// 0x4B000000 | code is the f32 2^23 + code, minus 2^23 + 32 gives sc - 32
// exactly, and times d it is eff, exact in f32.
__device__ __forceinline__ void scale_pair(uint32_t sc, int p, float d,
                                           __nv_bfloat162& eh, __nv_bfloat162& el) {
    float eff[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const uint32_t code = (sc >> (12 * p + 6 * h)) & 63u;
        eff[h] = __fmul_rn(__fsub_rn(__uint_as_float(0x4B000000u | code), 8388640.0f), d);
    }
    eh = __floats2bfloat162_rn(eff[0], eff[1]);
    el = __floats2bfloat162_rn(__fsub_rn(eff[0], __low2float(eh)),
                               __fsub_rn(eff[1], __high2float(eh)));
}

// Element 4b + i (i = 0..3) of sub-blocks s and s + 1 as a bf16 pair, each
// bf16(q * eff) rounded once.  cb holds byte b of the ql words of s (bits
// 0..7) and s + 1 (16..23), element 4b + i's code at bits 2i; hb holds the
// nibble of s's h bits with element 4b + i at bit 4 * (b % 2) + i, and s +
// 1's 16 bits above.  The 3-bit field c = low | h << 2 goes to mantissa
// bits P..P+2 of each half, P = 2i for i < 3 (no shift of the codes) and 4
// for i = 3: 0x4300 | c << P is the bf16 128 + c * 2^P, minus 128 + 4 *
// 2^P gives q * 2^P exactly, and with eh and el scaled by 2^-P (exact),
// fma.rn(q 2^P, eh 2^-P, q 2^P * el 2^-P) rounds the exact q * eff once.
template <int I>
__device__ __forceinline__ uint32_t unpack_pair(uint32_t cb, uint32_t hb, int odd,
                                                const __nv_bfloat162 (&eh)[3],
                                                const __nv_bfloat162 (&el)[3]) {
    constexpr int P = I < 3 ? 2 * I : 4;
    const uint32_t cs = I < 3 ? cb : cb >> 2;
    const int hsrc = 4 * odd + I, hdst = P + 2;
    const uint32_t hs = hdst >= hsrc ? hb << (hdst - hsrc) : hb >> (hsrc - hdst);
    const uint32_t bits = (cs & (0x00030003u << P)) | (hs & (0x00040004u << P)) | 0x43004300u;
    const __nv_bfloat162 q = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits),
                                     __float2bfloat162_rn(128.0f + 4.0f * (1 << P)));
    const __nv_bfloat162 v = __hfma2(q, eh[P / 2], __hmul2(q, el[P / 2]));
    return *reinterpret_cast<const uint32_t*>(&v);
}

// One K step's codes and scales for a lane: quarter tig of the super-block
// of rows gid and gid + 8.
struct Codes {
    uint4 ql[2];          // word i: sub-block 4tig + i
    uint2 qh[2];          // word p: sub-blocks 4tig + 2p (bits 0..15) and + 1
    uint32_t sc[2][2];    // the aligned scale words holding group tig's 3 bytes
    __half d[2];
};

// Elements from one expert's x, ql, qh, scale bytes, d and y to the
// next's in a batched call (csrc/common.cuh's Batch; all 0 for a
// two-dimensional one).
struct ExpertStrides {
    size_t x, ql, qh, sc, d, y;
};

// NT column groups of 8 tokens (M <= 8 * NT).  Two CTAs per SM at least:
// left to itself ptxas may take ~160 registers and halve the warps per SM.
template <int NT>
__global__ void __launch_bounds__(GEMV_WARPS * 32, 2)
q3k_gemv_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ ql,
                const uint8_t* __restrict__ qh, const uint8_t* __restrict__ scales,
                const __half* __restrict__ d, float* __restrict__ y,
                int M, int N, int K, ExpertStrides es) {
    __shared__ float red[GEMV_WARPS][GEMV_ROWS * 8 * NT];
    // Expert blockIdx.z of a batched call (0 otherwise).
    x += blockIdx.z * es.x;
    ql += blockIdx.z * es.ql;
    qh += blockIdx.z * es.qh;
    scales += blockIdx.z * es.sc;
    d += blockIdx.z * es.d;
    y += blockIdx.z * es.y;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarp = blockDim.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int n0 = blockIdx.x * GEMV_ROWS;
    const int nstep = K / 256;
    // Row and token bases, worked out once.  Rows past N read row N - 1 and
    // tokens past M token M - 1: their sums are never stored.
    const uint4* qlp[2];
    const uint2* qhp[2];
    const uint32_t* scp[2];
    const __half* dp[2];
    // Scale bytes 3tig..3tig+2 of a group: words sw and sw + dsw, funnel
    // shift ssh.
    const int sw = (3 * tig) >> 2, dsw = sw < 2 ? 1 : 0, ssh = 8 * ((3 * tig) & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const size_t sb = (size_t)min(n0 + gid + 8 * r, N - 1) * nstep;
        qlp[r] = reinterpret_cast<const uint4*>(ql + sb * 64) + tig;
        qhp[r] = reinterpret_cast<const uint2*>(qh + sb * 32) + tig;
        scp[r] = reinterpret_cast<const uint32_t*>(scales + sb * 12) + sw;
        dp[r] = d + sb;
    }
    const uint4* xp[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t)
        xp[t] = reinterpret_cast<const uint4*>(x + (size_t)min(gid + 8 * t, M - 1) * K) + 8 * tig;

    // The codes of steps st0 + u * nwarp (steps past K are not read; the
    // loop below skips them).
    auto fetch = [&](Codes (&c)[GEMV_UNROLL], int st0) {
#pragma unroll
        for (int u = 0; u < GEMV_UNROLL; ++u) {
            const int st = st0 + u * nwarp;
            if (st < nstep) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    c[u].ql[r] = qlp[r][4 * st];
                    c[u].qh[r] = qhp[r][4 * st];
                    c[u].sc[r][0] = scp[r][3 * st];
                    c[u].sc[r][1] = scp[r][3 * st + dsw];
                    c[u].d[r] = dp[r][st];
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
            const int st = st0 + u * nwarp;
            if (st >= nstep) break;             // the same for the whole warp
            const float dr[2] = {__half2float(cur[u].d[0]), __half2float(cur[u].d[1])};
            const uint32_t sc[2] = {__funnelshift_r(cur[u].sc[0][0], cur[u].sc[0][1], ssh),
                                    __funnelshift_r(cur[u].sc[1][0], cur[u].sc[1][1], ssh)};
#pragma unroll
            for (int p = 0; p < 2; ++p) {       // sub-blocks s = 4tig + 2p and s + 1
                // eh and el of both rows, scaled by 2^-P for P = 0, 2, 4.
                __nv_bfloat162 eh[2][3], el[2][3];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    scale_pair(sc[r], p, dr[r], eh[r][0], el[r][0]);
#pragma unroll
                    for (int k = 1; k < 3; ++k) {
                        const __nv_bfloat162 f = __float2bfloat162_rn(k == 1 ? 0.25f : 0.0625f);
                        eh[r][k] = __hmul2(eh[r][0], f);
                        el[r][k] = __hmul2(el[r][0], f);
                    }
                }
                uint4 xv[NT][4];                // x of s (0, 1) and s + 1 (2, 3)
#pragma unroll
                for (int t = 0; t < NT; ++t)
#pragma unroll
                    for (int j = 0; j < 4; ++j) xv[t][j] = xp[t][32 * st + 4 * p + j];
                uint32_t w0[2], w1[2], h[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    w0[r] = word(cur[u].ql[r], 2 * p);
                    w1[r] = word(cur[u].ql[r], 2 * p + 1);
                    h[r] = p ? cur[u].qh[r].y : cur[u].qh[r].x;
                }
#pragma unroll
                for (int b = 0; b < 4; ++b) {   // elements 4b..4b+3 of s and s + 1
                    const uint32_t csel = b | (4 + b) << 8;
                    const uint32_t hsel = (b >> 1) | 4 << 4 | (2 + (b >> 1)) << 8 | 4 << 12;
                    const uint32_t cb[2] = {__byte_perm(w0[0], w1[0], csel),
                                            __byte_perm(w0[1], w1[1], csel)};
                    const uint32_t hb[2] = {__byte_perm(h[0], 0u, hsel),
                                            __byte_perm(h[1], 0u, hsel)};
#pragma unroll
                    for (int g = 0; g < 2; ++g) {   // elements 4b + 2g, + 1: one mma step
                        uint32_t a[4];
                        if (g == 0) {
                            a[0] = unpack_pair<0>(cb[0], hb[0], b & 1, eh[0], el[0]);
                            a[1] = unpack_pair<0>(cb[1], hb[1], b & 1, eh[1], el[1]);
                            a[2] = unpack_pair<1>(cb[0], hb[0], b & 1, eh[0], el[0]);
                            a[3] = unpack_pair<1>(cb[1], hb[1], b & 1, eh[1], el[1]);
                        } else {
                            a[0] = unpack_pair<2>(cb[0], hb[0], b & 1, eh[0], el[0]);
                            a[1] = unpack_pair<2>(cb[1], hb[1], b & 1, eh[1], el[1]);
                            a[2] = unpack_pair<3>(cb[0], hb[0], b & 1, eh[0], el[0]);
                            a[3] = unpack_pair<3>(cb[1], hb[1], b & 1, eh[1], el[1]);
                        }
#pragma unroll
                        for (int t = 0; t < NT; ++t) {
                            const uint32_t lo = word(xv[t][b >> 1], 2 * (b & 1) + g);
                            const uint32_t hi = word(xv[t][2 + (b >> 1)], 2 * (b & 1) + g);
                            mma16816(acc[t], a, __byte_perm(lo, hi, 0x5410),
                                     __byte_perm(lo, hi, 0x7632));
                        }
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
// K step is a quarter q = step % 4 of super-block sb = step / 4 (its
// sub-blocks 4q..4q+3).  A ring slot holds per row the step's 16 ql bytes
// (one 16-byte copy) and 8 qh bytes (one 8-byte copy).  The super-block's
// 12 scale bytes (three 4-byte copies) and the aligned word holding its
// fp16 d (the wrapper aligns d to 16 bytes) are copied once per
// super-block, at its first step, into one of two buffers past the ring
// (super-block parity): small copies every step cost more than the rest
// of the ring.  A buffer is refilled two super-blocks on, after the PROD
// barriers of the steps that read it.  A unit is sub-block j of a row, 16
// weights, two 16-byte stores.  Rows past N load as zero bytes.
// Unpack: the decode path's bf16x2 route with eff = eh + el and the 3-bit
// field at mantissa bits P, paired for a row-major tile: a register holds
// elements (4b + i, 4b + i + 1) of ql byte b, i = 0 or 2.  X = byte b in
// both halves (one byte permute) gives element i at bits 2i of the low
// half and i + 1 at 2i + 2 of the high half, so pair (0, 1) takes P = (0,
// 2) from X and pair (2, 3) P = (2, 4) from X >> 2.  The h bits come from
// Y = hb | hb << 17 (hb the chunk's qh byte), shifted by 2 - 4b, which puts
// element e's h at bit P + 2 of its half for both pairs.  0x4300 | c << P
// is the bf16 128 + c * 2^P; minus (128 + 4 * 2^P) per half gives q * 2^P
// exactly, and fma.rn(q 2^P, eh 2^-P, q 2^P * el 2^-P) with per-half
// scales rounds q * eff once, as the reference does
// (tests/test_torch_matmul_tiling.py checks every scale, code and q).
struct Q3KTile {
    const uint8_t* ql;
    const uint8_t* qh;
    const uint8_t* sc;
    const __half* d;
    size_t sql = 0, sqh = 0, ssc = 0, sd = 0;   // per-expert strides of a batched call
    __device__ Q3KTile expert(size_t e) const {
        return {ql + e * sql, qh + e * sqh, sc + e * ssc, d + e * sd, sql, sqh, ssc, sd};
    }
    __host__ __device__ static constexpr int raw_bytes(int BN) { return BN * 24; }
    __host__ __device__ static constexpr int extra_bytes(int BN) { return 2 * BN * 16; }

    // One bf16x2 pair: bits = 0x4300 | c << P per half.
    static __device__ __forceinline__ uint32_t pair(uint32_t bits, __nv_bfloat162 c,
                                                    __nv_bfloat162 eh, __nv_bfloat162 el) {
        const __nv_bfloat162 q = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits), c);
        const __nv_bfloat162 v = __hfma2(q, eh, __hmul2(q, el));
        return *reinterpret_cast<const uint32_t*>(&v);
    }

    // Copy i = t + NP * it (i < 2 BN) of each K step is the ql and qh bytes
    // of row i (i < BN) or, at a super-block's first step, the scale bytes
    // and d word of row i - BN (16 bytes a row in the buffer).
    template <int BN, int NP>
    struct Producer {
        static constexpr int UNITS = BN * 4 / NP;
        static constexpr int COPIES = (2 * BN + NP - 1) / NP;
        const uint8_t* ql;      // the format's arrays (sources of zero-filled copies)
        const uint8_t* qh;
        const uint8_t* sc;
        const __half* d;
        const uint8_t* src[COPIES];    // i < BN: row i's ql; else row i - BN's scales
        const uint8_t* src2[COPIES];   // i < BN: row i's qh; else row i - BN's d (as bytes)
        unsigned char* scb;             // the two scale buffers
        int t;
        uint32_t in;            // bit it: copy it exists (its row < N)
        uint32_t par;           // bit u: parity of unit u's row * nsb

        __device__ __forceinline__ Producer(const Q3KTile& fmt, int n0, int N, int K, int t_,
                                            unsigned char* extra)
            : ql(fmt.ql), qh(fmt.qh), sc(fmt.sc), d(fmt.d), scb(extra), t(t_) {
            const int nsb = K / 256;
            in = 0;
#pragma unroll
            for (int it = 0; it < COPIES; ++it) {
                const int i = t + NP * it, r = i < BN ? i : i - BN;
                const bool ok = i < 2 * BN && n0 + r < N;
                in |= (uint32_t)ok << it;
                const size_t row = ok ? n0 + r : 0;
                src[it] = i < BN ? ql + row * (K / 4) : sc + row * nsb * 12;
                src2[it] = i < BN ? qh + row * (K / 8)
                                  : reinterpret_cast<const uint8_t*>(d + row * nsb);
            }
            par = 0;
#pragma unroll
            for (int u = 0; u < UNITS; ++u)
                par |= (uint32_t)((((size_t)(n0 + ((t + NP * u) >> 2)) * nsb) & 1) << u);
        }

        __device__ __forceinline__ void load(unsigned char* raw, int k) const {
#pragma unroll
            for (int it = 0; it < COPIES; ++it) {
                const int i = t + NP * it;
                const bool ok = (in >> it) & 1;
                if (i < BN) {
                    cp_async16(raw + 16 * i, ok ? src[it] + 16 * k : ql, ok);
                    cp_async8(raw + BN * 16 + 8 * i, ok ? src2[it] + 8 * k : qh, ok);
                } else if (i < 2 * BN && (k & 3) == 0) {
                    const int r = i - BN, sb = k >> 2;
                    unsigned char* dst = scb + (sb & 1) * BN * 16 + 16 * r;
#pragma unroll
                    for (int w = 0; w < 3; ++w)
                        cp_async4(dst + 4 * w, ok ? src[it] + 12 * sb + 4 * w : sc, ok);
                    // The aligned word holding d of super-block sb.
                    const uintptr_t dsb = reinterpret_cast<uintptr_t>(src2[it]) + 2 * sb;
                    cp_async4(dst + 12, ok ? reinterpret_cast<const void*>(dsb & ~(uintptr_t)3) : d,
                              ok);
                }
            }
        }

        __device__ __forceinline__ void unpack(const unsigned char* raw, bf16* wt, int k) const {
            const int q4 = k & 3;
            const int sw = (3 * q4) >> 2, ssh = 8 * ((3 * q4) & 3);
#pragma unroll
            for (int u = 0; u < UNITS; ++u) {
                const int i = t + NP * u, r = i >> 2, j = i & 3;
                const uint32_t w = *reinterpret_cast<const uint32_t*>(raw + 16 * r + 4 * j);
                const uint32_t h =
                    *reinterpret_cast<const uint16_t*>(raw + BN * 16 + 8 * r + 2 * j);
                // Scale group q4: bytes 3q4..3q4+2 of the row's 12; code j at bits 6j.
                const unsigned char* sr = scb + ((k >> 2) & 1) * BN * 16 + 16 * r;
                const uint32_t* scw = reinterpret_cast<const uint32_t*>(sr);
                const uint32_t grp = __funnelshift_r(scw[sw], scw[sw < 2 ? sw + 1 : sw], ssh);
                const uint32_t code = (grp >> (6 * j)) & 63u;
                const uint32_t dw = scw[3];
                const bool hi_half = ((par >> u) ^ (k >> 2)) & 1;
                const float d32 = __half2float(__ushort_as_half(
                    static_cast<unsigned short>(hi_half ? dw >> 16 : dw & 0xFFFFu)));
                // eff = d * (sc - 32), exact in f32; eh = bf16(eff), el = bf16(eff - eh).
                const float eff =
                    __fmul_rn(__fsub_rn(__uint_as_float(0x4B000000u | code), 8388640.0f), d32);
                const float eh = __bfloat162float(__float2bfloat16_rn(eff));
                const float el = __bfloat162float(__float2bfloat16_rn(__fsub_rn(eff, eh)));
                const __nv_bfloat162 eh02 = __floats2bfloat162_rn(eh, eh * 0.25f);
                const __nv_bfloat162 el02 = __floats2bfloat162_rn(el, el * 0.25f);
                const __nv_bfloat162 eh24 = __floats2bfloat162_rn(eh * 0.25f, eh * 0.0625f);
                const __nv_bfloat162 el24 = __floats2bfloat162_rn(el * 0.25f, el * 0.0625f);
                const __nv_bfloat162 c02 = __floats2bfloat162_rn(132.0f, 144.0f);
                const __nv_bfloat162 c24 = __floats2bfloat162_rn(144.0f, 192.0f);
#pragma unroll
                for (int h2 = 0; h2 < 2; ++h2) {             // elements 8 h2 .. 8 h2 + 7
                    const uint32_t y = ((h >> (8 * h2)) & 0xFFu) * 0x20001u;   // hb | hb << 17
                    uint32_t v[4];
#pragma unroll
                    for (int b = 0; b < 2; ++b) {            // ql byte 2 h2 + b
                        const uint32_t sel = (2 * h2 + b) | 4u << 4 | (2 * h2 + b) << 8 | 4u << 12;
                        const uint32_t x = __byte_perm(w, 0u, sel);
                        const uint32_t ys = b == 0 ? y << 2 : y >> 2;
                        v[2 * b] = pair((x & 0x000C0003u) | (ys & 0x00100004u) | 0x43004300u,
                                        c02, eh02, el02);
                        v[2 * b + 1] =
                            pair(((x >> 2) & 0x0030000Cu) | (ys & 0x00400010u) | 0x43004300u,
                                 c24, eh24, el24);
                    }
                    *reinterpret_cast<uint4*>(wt + tile_swz(r, 2 * j + h2)) =
                        make_uint4(v[0], v[1], v[2], v[3]);
                }
            }
        }
    };
};

}  // namespace

namespace {

int q3k_launch(const void* x, const void* ql, const void* qh, const void* scales,
               const void* d, void* y, int M, int N, int K, const ExpertStrides& es, int E,
               cudaStream_t st) {
    const bf16* xb = static_cast<const bf16*>(x);
    const uint8_t* lo = static_cast<const uint8_t*>(ql);
    const uint8_t* hi = static_cast<const uint8_t*>(qh);
    const uint8_t* sc = static_cast<const uint8_t*>(scales);
    const __half* dd = static_cast<const __half*>(d);
    float* out = static_cast<float*>(y);
    if (M <= M_GEMV) {
        const int steps = K / 256;
        const int threads = 32 * (steps < GEMV_WARPS ? (steps > 0 ? steps : 1) : GEMV_WARPS);
        const dim3 grid((N + GEMV_ROWS - 1) / GEMV_ROWS, 1, E);
        if (M <= 8)
            q3k_gemv_kernel<1><<<grid, threads, 0, st>>>(xb, lo, hi, sc, dd, out, M, N, K, es);
        else
            q3k_gemv_kernel<2><<<grid, threads, 0, st>>>(xb, lo, hi, sc, dd, out, M, N, K, es);
        return static_cast<int>(cudaGetLastError());
    }
    return tile_launch(xb, Q3KTile{lo, hi, sc, dd, es.ql, es.qh, es.sc, es.d}, out, M, N, K, st,
                       Batch{E, es.x, es.y});
}

}  // namespace

// x: (M,K) bf16; ql: (N,K/4) u8; qh: (N,K/8) u8; scales: (N,K/256,12) u8
// packed codes; d: (N,K/256) fp16; y: (M,N) f32.  K % 256 == 0; x, ql, qh,
// scales and d 16-byte aligned (the wrapper makes them so).
extern "C" int q3k_matmul_bf16(const void* x, const void* ql, const void* qh,
                               const void* scales, const void* d, void* y,
                               int M, int N, int K, void* stream) {
    return q3k_launch(x, ql, qh, scales, d, y, M, N, K, ExpertStrides{0, 0, 0, 0, 0, 0}, 1,
                      static_cast<cudaStream_t>(stream));
}

// E experts in one launch (the reference's vmap of the kernel over an MoE
// layer's experts): expert e's x, ql, qh, scale bytes, d and y start s*
// elements on from expert e - 1's.  Each expert's arrays are aligned as
// the two-dimensional entry's (the wrapper makes them so).
extern "C" int q3k_matmul_bf16_experts(const void* x, const void* ql, const void* qh,
                                       const void* scales, const void* d, void* y, int E, int M,
                                       int N, int K, long long sx, long long sql, long long sqh,
                                       long long ssc, long long sd, long long sy, void* stream) {
    return q3k_launch(x, ql, qh, scales, d, y, M, N, K,
                      ExpertStrides{(size_t)sx, (size_t)sql, (size_t)sqh, (size_t)ssc,
                                    (size_t)sd, (size_t)sy},
                      E, static_cast<cudaStream_t>(stream));
}
