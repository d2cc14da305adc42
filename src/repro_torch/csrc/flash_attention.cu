// Online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention
// (_flash_kernel).  q: (BH,Sq,D), k/v: (BH,Sk,D), bf16 in, bf16 out.
//   logits = (q . k) * scale  in f32; causal mask bottom-right aligned
//   (kpos <= qpos + Sk - Sq); optional window (kpos > qpos + Sk - Sq - W);
//   keys past Sk masked for any Sk; p = exp(logits - m) in f32, the
//   unnormalised p rounded to bf16 for the P.V product (the Pallas
//   kernel's rounding point), f32 accumulate; out = acc / l in bf16, and
//   rows with no unmasked key give 0.
//
// What bounds it on the H100.  Per logit the kernel does 2*DP flops of
// each product on the tensor cores and one exp on the special-function
// units (16 ex2 per clock per SM).  At the UNet's D = 40 (DP = 48) the
// exps set the floor, by reckoning from those rates: 2*8*4096^2 logits
// over 132 SMs * 16/clk at about 1.98 GHz is about 0.064 ms, above the
// 0.043 ms tensor-core bound; from D = 80 up the products dominate.  The
// bytes (q, k, v and out once each) are small at every main-path shape.
// Measured, the kernel sits well above both: within a CTA the warps meet
// at one barrier per tile, so their Q.K^T, exp and P.V phases run in step
// and the tensor cores and the exp units take turns, while several
// hundred instructions issue per warp per 64-key tile.  Pipelining Q.K^T
// of the next tile under the current softmax needs 32 more registers per
// thread and lost more occupancy than it gained; the wgmma/TMA form is
// the next step.
//
// Design (FlashAttention-2 on mma.sync):
// - Templated on the padded head dim DP = 16, 32, ..., 192 (all twelve
//   built; the host dispatches on (d + 15) / 16 * 16), so every loop over
//   DP unrolls and S, P and O live in registers.  D pads with zero
//   columns, which leaves q.k unchanged; only the first D columns are
//   stored.
// - One CTA per (b*h, query tile of BQ rows); each warp owns 16 rows.  BQ
//   rule: 128 rows (8 warps) when BH * ceil(Sq/128) CTAs cover every SM,
//   else 64 (4 warps), so the UNet's levels 1, 2 and mid, CLIP and
//   make_prefill still spread over the card.  Tiles run in reverse order
//   so the heaviest causal tiles start first.
// - Q is loaded once (cp.async) and moved by ldmatrix.x4 into the A
//   fragments of mma.m16n8k16 (bf16 in, f32 accumulate), where it stays
//   for the whole key loop.
// - K and V stream through a ring of STAGES (3 up to DP = 96, else 2)
//   64-key tiles in shared memory, filled by 16-byte cp.async (zero past
//   Sk); each thread copies one column chunk of every rpp-th row, with
//   addresses worked out once, and columns past D are zeroed once.  One
//   barrier per tile.  Rows are padded by 16 bytes, so ldmatrix on K (B
//   operand of Q.K^T) and ldmatrix.trans on V (B operand of P.V) hit 8
//   distinct bank groups.
// - A warp's step over a tile (S, masks, online softmax, P.V) is
//   common.cuh's FlashWarp, which flash_prefill.cu shares.
// - S = Q K^T is 8 n8-tiles x 4 f32 per thread; nothing goes to shared
//   memory.  The row max and sum reduce over the quad of lanes sharing a
//   row (two shuffles); p = ex2(s * scale*log2(e) - m * scale*log2(e)),
//   one FMA and one ex2 per logit; l sums the f32 p.  Masks are evaluated
//   only on tiles that cross Sk, the causal diagonal or the window's edge
//   of the warp's rows; tiles wholly outside the mask are skipped (CTA
//   range kstart..kend, then per warp).
// - P is the S registers rounded to bf16 pairs, which is exactly the A
//   fragment of the next mma: the rounding point is the Pallas kernel's,
//   and P.V needs no shared memory.
// - O is DP/8 n8-tiles x 4 f32 per thread, rescaled by alpha in
//   registers and divided by l once at the end (l = 0 gives 0).  It is
//   staged as bf16 through the warp's own rows of the Q buffer, then
//   written with 16-byte coalesced stores.
// A head dim that is not a multiple of 8 takes element-wise loads and
// stores (correct, slow); no main-path shape has one.
#include <math.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int BKV = FLASH_BKV;   // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Cfg {
    static constexpr int LD = DP + 8;               // smem row stride (bf16)
    static constexpr int STAGES = DP <= 96 ? 3 : 2;
    static constexpr int CPR = DP / 8;              // 16-byte chunks per row
    static size_t smem(int bq) { return (size_t)(bq + 2 * STAGES * BKV) * LD * 2; }
};

// Rows [row0, row0+rows) of a (n, d) bf16 matrix into dst (row stride
// LD, DP columns), zero past n and past d.  With vec (d % 8 == 0) the
// copy is asynchronous (cp.async); otherwise element by element.
template <int DP, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src,
                                          int row0, int rows, int n, int d, bool vec) {
    constexpr int LD = Cfg<DP>::LD, CPR = Cfg<DP>::CPR;
    if (vec) {
        for (int i = threadIdx.x; i < rows * CPR; i += NT) {
            const int r = i / CPR, c8 = i - r * CPR;
            const int gr = row0 + r;
            const bool in = gr < n && c8 * 8 < d;
            cp_async16(dst + r * LD + c8 * 8, in ? src + (size_t)gr * d + c8 * 8 : src, in);
        }
    } else {
        const bf16 zero = __float2bfloat16(0.0f);
        for (int i = threadIdx.x; i < rows * DP; i += NT) {
            const int r = i / DP, c = i - r * DP;
            const int gr = row0 + r;
            dst[r * LD + c] = (gr < n && c < d) ? src[(size_t)gr * d + c] : zero;
        }
    }
}

// 16-byte asynchronous copy to a shared-memory address; with !valid
// nothing is read and 16 zero bytes are written.
__device__ __forceinline__ void cp_async16_s(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0));
}

// This thread's share of the 16-byte copies of one K and one V tile when
// d % 8 == 0: one column chunk of rows row0, row0 + rpp, ... of the tile
// (rpp = NT / (d/8) rows per pass; threads with row0 >= rpp idle), with
// addresses worked out once.  Columns past d are never copied: the
// ring's pad columns are zeroed once before the key loop.
template <int DP, int NT>
struct TileCopy {
    static constexpr int LD = Cfg<DP>::LD;
    static constexpr int PER = (BKV + NT / Cfg<DP>::CPR - 1) / (NT / Cfg<DP>::CPR);
    static constexpr uint32_t STAGE_BYTES = BKV * LD * 2;
    static constexpr uint32_t V_BYTES = Cfg<DP>::STAGES * STAGE_BYTES;  // K ring -> V ring
    const bf16* gk;     // K of key row0, this thread's chunk
    uint32_t sk0;       // shared address of the chunk in stage 0 of the K ring
    int row0, rpp;

    __device__ __forceinline__ TileCopy(const bf16* kb, const bf16* kring, int d) {
        const int cpr = max(d / 8, 1);
        rpp = NT / cpr;
        row0 = threadIdx.x / cpr;
        const int c8 = threadIdx.x - row0 * cpr;
        gk = kb + (size_t)row0 * d + c8 * 8;
        sk0 = static_cast<uint32_t>(__cvta_generic_to_shared(kring)) +
              2u * (row0 * LD + c8 * 8);
    }

    // Keys [k0, k0 + BKV) into ring stage st; zero past sk.  V lies
    // v_minus_k elements after K in device memory.
    __device__ __forceinline__ void issue(int st, int k0, int sk, int d,
                                          ptrdiff_t v_minus_k) const {
        const size_t g = (size_t)k0 * d;
        const uint32_t s = sk0 + st * STAGE_BYTES;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            const int r = row0 + j * rpp;
            if (row0 < rpp && r < BKV) {
                const bool in = k0 + r < sk;
                const bf16* src = gk + g + (size_t)j * rpp * d;
                const uint32_t sj = s + 2u * j * rpp * LD;
                cp_async16_s(sj, src, in);
                cp_async16_s(sj + V_BYTES, src + v_minus_k, in);
            }
        }
    }
};

template <int DP, int NT>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int sq, int sk, int d, float scale, int causal, int window) {
    constexpr int LD = Cfg<DP>::LD, STAGES = Cfg<DP>::STAGES, CPR = Cfg<DP>::CPR;
    constexpr int KS = DP / 16;       // n16 pairs of O
    constexpr int BQ = NT / 2;        // 16 rows per warp
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* qs = reinterpret_cast<bf16*>(smem);
    bf16* kring = qs + BQ * LD;
    bf16* vring = kring + STAGES * BKV * LD;

    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const bf16* qb = q + (size_t)blockIdx.y * sq * d;
    const bf16* kb = k + (size_t)blockIdx.y * sk * d;
    const bf16* vb = v + (size_t)blockIdx.y * sk * d;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int off = sk - sq;             // bottom-right causal alignment
    const bool vec = (d & 7) == 0;

    // Keys any row of this CTA can see.
    int kend = sk;
    if (causal) kend = min(sk, min(q0 + BQ, sq) + off);
    const int kstart = window > 0 ? max(0, q0 + off - window + 1) : 0;
    const int ntiles = kend > kstart ? (kend - kstart + BKV - 1) / BKV : 0;

    const TileCopy<DP, NT> copy(kb, kring, d);
    auto load_tile = [&](int tile) {
        const int st = tile % STAGES, k0 = kstart + tile * BKV;
        if (vec) {
            copy.issue(st, k0, sk, d, v - k);
        } else {
            load_rows<DP, NT>(kring + st * BKV * LD, kb, k0, BKV, sk, d, false);
            load_rows<DP, NT>(vring + st * BKV * LD, vb, k0, BKV, sk, d, false);
        }
    };
    if (ntiles > 0) {
        load_rows<DP, NT>(qs, qb, q0, BQ, sq, d, vec);
        if (vec && d < DP)               // the ring's pad columns, once
            for (int r = tid; r < 2 * STAGES * BKV; r += NT)
                *reinterpret_cast<uint4*>(kring + r * LD + d) = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < ntiles) load_tile(s);
        cp_async_commit();
    }

    // The warp's rows on the key axis: qlo/qhi are the diagonal positions
    // (qpos + off) of its first and last live row, qd[r] those of this
    // thread's rows g and g + 8.
    const int qw0 = q0 + warp * 16;
    const bool live = qw0 < sq;
    const int qlo = qw0 + off, qhi = min(qw0 + 15, sq - 1) + off;
    const int qd[2] = {qlo + g, qlo + g + 8};
    // p = 2^(s*c - m*c); a negative scale flips the sign of q (exact in
    // bf16) so that the row max is taken on s*|scale|.
    const float c = fmaxf(fabsf(scale) * LOG2E, 1e-30f);
    const uint32_t qsign = scale < 0.0f ? 0x80008000u : 0u;

    FlashWarp<DP> fw;

    for (int it = 0; it < ntiles; ++it) {
        cp_async_wait_n<STAGES - 2>();     // tile it (and Q) landed
        __syncthreads();                   // ... for all; stage it-1 free
        if (it + STAGES - 1 < ntiles) load_tile(it + STAGES - 1);
        cp_async_commit();
        if (it == 0) fw.load_q(qs + warp * 16 * LD, qsign);
        const int k0 = kstart + it * BKV;
        if (!live || (causal && k0 > qhi) || (window > 0 && k0 + BKV - 1 <= qlo - window))
            continue;                      // no key of this tile for the warp
        const bool edge = k0 + BKV > sk || (causal && k0 + BKV - 1 > qlo) ||
                          (window > 0 && k0 <= qhi - window);
        fw.template tile<false>(kring + (it % STAGES) * BKV * LD,
                                vring + (it % STAGES) * BKV * LD, c, edge, k0, sk, causal,
                                window, qd);
    }

    // out = acc / l in bf16 (0 where l = 0), staged in the warp's own Q
    // rows (read only by this warp, at tile 0), then 16-byte stores.
    fw.finish();
    bf16* stage = qs + warp * 16 * LD;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float lr = fw.l[r];
            const float lo = lr > 0.0f ? fw.acc[n][2 * r] / lr : 0.0f;
            const float hi = lr > 0.0f ? fw.acc[n][2 * r + 1] / lr : 0.0f;
            *reinterpret_cast<uint32_t*>(stage + (g + 8 * r) * LD + 8 * n + 2 * t) =
                pack_bf16(lo, hi);
        }
    __syncwarp();
    bf16* ob = o + (size_t)blockIdx.y * sq * d;
    if (vec) {
        for (int i = lane; i < 16 * CPR; i += 32) {
            const int r = i / CPR, c8 = i - r * CPR;
            if (qw0 + r < sq && c8 * 8 < d)
                *reinterpret_cast<uint4*>(ob + (size_t)(qw0 + r) * d + c8 * 8) =
                    *reinterpret_cast<const uint4*>(stage + r * LD + c8 * 8);
        }
    } else {
        for (int i = lane; i < 16 * DP; i += 32) {
            const int r = i / DP, cc = i - r * DP;
            if (qw0 + r < sq && cc < d) ob[(size_t)(qw0 + r) * d + cc] = stage[r * LD + cc];
        }
    }
}

// BQ rule: 128 query rows (256 threads) per CTA when BH * ceil(Sq/128)
// CTAs cover every SM, else 64 (128 threads).  The SM count and the
// shared-memory limits are set up once per device.
template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int sq,
           int sk, int d, float scale, int causal, int window, cudaStream_t stream) {
    static PerDevice<1> sms_of;
    int* sms = nullptr;
    if (const int err = sms_of.get(sms, [](int dev, int* v) {
            cudaError_t e = cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, dev);
            if (e == cudaSuccess)
                e = cudaFuncSetAttribute(flash_attention_kernel<DP, 256>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Cfg<DP>::smem(128)));
            if (e == cudaSuccess)
                e = cudaFuncSetAttribute(flash_attention_kernel<DP, 128>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Cfg<DP>::smem(64)));
            return e;
        }))
        return err;
    if ((long long)bh * ((sq + 127) / 128) >= sms[0])
        flash_attention_kernel<DP, 256><<<dim3((sq + 127) / 128, bh), 256, Cfg<DP>::smem(128),
                                          stream>>>(q, k, v, o, sq, sk, d, scale, causal, window);
    else
        flash_attention_kernel<DP, 128><<<dim3((sq + 63) / 64, bh), 128, Cfg<DP>::smem(64),
                                          stream>>>(q, k, v, o, sq, sk, d, scale, causal, window);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (BH,Sq,D), k/v: (BH,Sk,D), o: (BH,Sq,D), bf16, contiguous, 16-byte
// aligned.  window <= 0 means no window.  1 <= D <= 192.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int bh, int sq, int sk, int d, float scale,
                                    int causal, int window, void* stream) {
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(o);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_ARGS qp, kp, vp, op, bh, sq, sk, d, scale, causal, window, st
    switch ((d + 15) / 16 * 16) {
        case 16: return launch<16>(REPRO_FA_ARGS);
        case 32: return launch<32>(REPRO_FA_ARGS);
        case 48: return launch<48>(REPRO_FA_ARGS);
        case 64: return launch<64>(REPRO_FA_ARGS);
        case 80: return launch<80>(REPRO_FA_ARGS);
        case 96: return launch<96>(REPRO_FA_ARGS);
        case 112: return launch<112>(REPRO_FA_ARGS);
        case 128: return launch<128>(REPRO_FA_ARGS);
        case 144: return launch<144>(REPRO_FA_ARGS);
        case 160: return launch<160>(REPRO_FA_ARGS);
        case 176: return launch<176>(REPRO_FA_ARGS);
        case 192: return launch<192>(REPRO_FA_ARGS);
    }
#undef REPRO_FA_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
}
