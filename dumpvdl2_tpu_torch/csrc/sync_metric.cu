// D8PSK preamble sync error metric (kernel K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel dumpvdl2_tpu/dsp/sync_pallas.py
// (sync_error_metric_pallas, body _metric_kernel).  At every decimated
// sample n of every channel it fits the 16-symbol preamble phase ramp:
// take the phases at n-150+10k (k = 0..15), subtract the preamble
// phase PR_PHASE[k], unwrap along k, remove the mean, fit the slope
// freq = sum x_k e_k / 340 with x_k = k-7.5, and return the residual
// sum of squares as err.  For n < 150 the kernel itself writes
// err = +inf and freq = 0.  The plain PyTorch twin is
// dumpvdl2_tpu_torch/dsp/sync_kernel.py:sync_error_metric_plain.
//
// Bound: instruction issue, not bytes.  Each output reads 4 bytes and
// writes 8, but needs at least 169 float instructions, most of them
// lone adds and the unwrap's compares and conditional adds, which no
// multiply-add absorbs.  At the wideband shape (256, 108 844) that is
// 0.141 ms at 128 lanes x 132 SMs x 1.98 GHz against 0.100 ms for the
// 0.33 GB at 3.35 TB/s (chip_smoke.py::k1_bound computes both).
//
// Design.  The first version (one block per 256-output tile, one output
// per thread, 16 phases read from shared memory one by one) issued 707
// SASS instructions per output, 318 of them float or LDS (158 FADD,
// 65 FMUL, 33 FSETP, 30 FSEL, 16 FFMA, 16 LDS).  This one issues 186 in
// its output loop: 88.5 FADD, 48 FFMA, 15 FSETP, 15 LOP3, 3 FMUL,
// 1 FSEL, 8.5 LDS, 2 STS, 5 other (cuobjdump -sass, counted by
// tools/k1_probe.py, which also times the variants named below in
// turns on one card).
//
// 1. Constants as immediates.  PR_PHASE and LR_X are constexpr
//    hex-float literals, bit-equal to float32(units) * float32(pi/4)
//    and k - 7.5 (tests/test_torch_k1_design.py parses and checks
//    them), so err_k = phi - PR_PHASE[k] is the value the plain version
//    computes and no multiply is left per term.
// 2. One decision per unwrap step: where |d| > pi, cum -= copysign(2pi,
//    d).  That is one FSETP (|d| is an operand modifier), one LOP3 and
//    one predicated FADD; |d| == pi and NaN add nothing, and cum is the
//    plain version's running sum bit for bit.  Two saturated FMAs and
//    an FMA into cum ran 4 % slower, two compares and selects and an add
//    19 % slower (tools/k1_probe.py variants unwrap_satfma,
//    unwrap_select).  The file builds with --fmad=false: nothing fuses
//    that is not written as a fused multiply-add.
// 3. The slope and the residual use explicit __fmaf_rn, the mean a
//    multiply by 1/16 (exact) and the slope a multiply by float32(1/340)
//    (within 1 ulp of the divide; freq stays far inside its 1e-5 limit).
// 4. Symbol chains.  Outputs n and n+10 share 15 of their 16 phases, so
//    a thread computes the kChain = 17 outputs n, n+10, ..., n+160, in
//    passes of kUnroll = 2 that load their 17 phases into registers
//    once (8.5 loads per output, not 16).  Only the de-ramp and what
//    follows is redone per output: each phase meets another preamble
//    symbol in each window.  On the H100, one output a pass ran 7 %
//    slower; passes of 4 and 8 ran within 1 % of passes of 2, with 96
//    registers in place of 64; the whole chain in one pass (3 787
//    instructions) ran 23 % slower, likely from code size (the
//    instruction cache cannot be observed on the card's machine).
//    Threads 10g..10g+9 take the ten residues of group g (170
//    consecutive outputs); with 170 = 10 (mod 32) lane j reads bank j,
//    so neither the loads nor the staged stores conflict.
// 5. A persistent grid: a few blocks per SM walk (channel, tile) work
//    items of kTile = 2720 outputs (16 groups), so the 150-sample halo
//    adds 5.5 % to the staged phases, not 59 %.  The next item's phases
//    stream into a second shared buffer with cp.async (16-byte copies
//    where source and destination are 16-byte aligned, 4-byte copies at
//    the ragged ends) while the current one is computed.  Results are
//    staged in shared memory and written back as 16-byte stores, as a
//    chain's outputs are 10 apart (rows of any length and alignment:
//    the staging is shifted to the row's alignment).  Any C: no grid
//    dimension holds channels.
// 6. No tensor cores: the work is adds, compares and short dot products
//    of 16 terms per output, which no matrix unit shape fits, and TF32
//    would break the 1e-3 err limit.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kSyms = 16;
constexpr int kSps = 10;
constexpr int kLookback = (kSyms - 1) * kSps;    // 150
constexpr int kChain = 17;                       // outputs per thread
constexpr int kGroups = 16;                      // chain groups per tile
constexpr int kThreads = kSps * kGroups;         // 160 = 5 warps
constexpr int kGroupLen = kSps * kChain;         // 170 outputs
constexpr int kTile = kGroupLen * kGroups;       // 2720 outputs
constexpr int kWinBuf = (kTile + kLookback + 3 + 3) / 4 * 4;  // 2876
constexpr int kOutBuf = (kTile + 3 + 3) / 4 * 4;               // 2724
constexpr int kUnroll = 2;                       // outputs per pass
static_assert(kGroupLen % 32 == kSps, "lane j must read bank j");
static_assert(kThreads % 32 == 0, "whole warps");
static_assert((kChain - 1) % kUnroll == 0, "passes, then the last output");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Float index of p modulo 4: where a 16-byte boundary falls.
__device__ __forceinline__ int quad_shift(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

struct Item {
  const float* row;   // the channel's phases
  long long off;      // row offset of the channel in err / freq
  int n0;             // first output of the tile
};

__device__ __forceinline__ Item item_at(const float* ph, long long item,
                                        int tiles, int M) {
  const long long c = item / tiles;
  const int t = static_cast<int>(item - c * tiles);
  return {ph + c * M, c * M, t * kTile};
}

// Shared position of the tile's first lookback sample (n0 - 150): the
// buffer is shifted so that 16-byte boundaries of the row fall on
// 16-byte boundaries of the buffer.
__device__ __forceinline__ int win_shift(const Item& it) {
  const uintptr_t q = (reinterpret_cast<uintptr_t>(it.row) >> 2) +
                      static_cast<uintptr_t>(it.n0 - kLookback);
  return static_cast<int>(q & 3);
}

// Start copying the row's samples [n0 - 150, n0 + kTile) (clipped to
// [0, M)) into buf; sample x lands at buf[s + x - (n0 - 150)].
__device__ __forceinline__ void stage(float* buf, const Item& it, int M) {
  const int s = win_shift(it);
  const int base = it.n0 - kLookback;              // sample at position s
  const int p_lo = s + max(base, 0) - base;
  const int p_hi = s + min(it.n0 + kTile, M) - base;
  const int a_lo = (p_lo + 3) & ~3;
  const int a_hi = p_hi & ~3;
  const float* src = it.row + base - s;            // src[p] for buf[p]
  const int tid = threadIdx.x;
  const int head_end = min(a_lo, p_hi);
  if (p_lo + tid < head_end) cp_async4(buf + p_lo + tid, src + p_lo + tid);
  const int tail_lo = max(a_lo, a_hi);
  if (tail_lo + tid < p_hi)
    cp_async4(buf + tail_lo + tid, src + tail_lo + tid);
  for (int p = a_lo + 4 * tid; p < a_hi; p += 4 * kThreads)
    cp_async16(buf + p, src + p);
}

// Write L staged outputs to g with 16-byte stores; sh[a + i] holds
// g[i], where a = quad_shift(g).
__device__ __forceinline__ void store_row(float* __restrict__ g,
                                          const float* sh, int L) {
  const int a = quad_shift(g);
  const int head = min(L, (4 - a) & 3);
  const int tid = threadIdx.x;
  if (tid < head) g[tid] = sh[a + tid];
  const int nvec = (L - head) >> 2;
  float4* gv = reinterpret_cast<float4*>(g + head);
  const float4* sv = reinterpret_cast<const float4*>(sh + a + head);
  for (int v = tid; v < nvec; v += kThreads) gv[v] = sv[v];
  const int tail = head + 4 * nvec;
  if (tail + tid < L) g[tail + tid] = sh[a + tail + tid];
}

// Fit one output from its 16 phases w[off..off+15] (w[off+k] is the
// phase at n - 150 + 10k).
__device__ __forceinline__ void fit(const float* w, int off, float& e_out,
                                    float& f_out) {
  // float32(units) * float32(pi / 4), units = 0 3 -3 1 1 2 0 4 -3 4 -2 3
  // 1 -2 -3 0 (constants.PREAMBLE_PHASE_UNITS)
  constexpr float PR_PHASE[kSyms] = {
      0x0.0p+0f, 0x1.2d97c8p+1f, -0x1.2d97c8p+1f, 0x1.921fb6p-1f,
      0x1.921fb6p-1f, 0x1.921fb6p+0f, 0x0.0p+0f, 0x1.921fb6p+1f,
      -0x1.2d97c8p+1f, 0x1.921fb6p+1f, -0x1.921fb6p+0f, 0x1.2d97c8p+1f,
      0x1.921fb6p-1f, -0x1.921fb6p+0f, -0x1.2d97c8p+1f, 0x0.0p+0f};
  // x_k = k - 7.5
  constexpr float LR_X[kSyms] = {
      -0x1.ep+2f, -0x1.ap+2f, -0x1.6p+2f, -0x1.2p+2f,
      -0x1.cp+1f, -0x1.4p+1f, -0x1.8p+0f, -0x1.0p-1f,
      0x1.0p-1f, 0x1.8p+0f, 0x1.4p+1f, 0x1.cp+1f,
      0x1.2p+2f, 0x1.6p+2f, 0x1.ap+2f, 0x1.ep+2f};
  constexpr float kPi = 0x1.921fb6p+1f;            // float32(pi)
  constexpr float kTwoPi = 0x1.921fb6p+2f;         // float32(2 pi)
  constexpr float kInv340 = 0x1.818182p-9f;        // float32(1 / 340)

  float ev[kSyms];
  float prev = w[off] - PR_PHASE[0];
  float cum = 0.0f;
  ev[0] = prev;
#pragma unroll
  for (int k = 1; k < kSyms; ++k) {
    const float cur = w[off + k] - PR_PHASE[k];
    const float d = cur - prev;
    if (fabsf(d) > kPi) cum = cum - copysignf(kTwoPi, d);
    ev[k] = cur + cum;
    prev = cur;
  }
  float sum = ev[0];
#pragma unroll
  for (int k = 1; k < kSyms; ++k) sum = sum + ev[k];
  const float mean = sum * 0.0625f;
  float f = 0.0f;
#pragma unroll
  for (int k = 0; k < kSyms; ++k) {
    ev[k] = ev[k] - mean;
    f = __fmaf_rn(LR_X[k], ev[k], f);
  }
  f = f * kInv340;
  float e = 0.0f;
#pragma unroll
  for (int k = 0; k < kSyms; ++k) {
    const float res = __fmaf_rn(-f, LR_X[k], ev[k]);
    e = __fmaf_rn(res, res, e);
  }
  e_out = e;
  f_out = f;
}

// The kChain outputs of one chain; src[10 q] is the phase of its first
// output's window at q, and output r goes to de[10 r], df[10 r].  Each
// pass loads the kUnroll + 15 phases of kUnroll outputs into registers.
__device__ __forceinline__ void fit_chain(const float* src, float* de,
                                          float* df) {
#pragma unroll 1
  for (int r0 = 0; r0 < kChain - 1; r0 += kUnroll) {
    float w[kUnroll + kSyms - 1];
#pragma unroll
    for (int q = 0; q < kUnroll + kSyms - 1; ++q)
      w[q] = src[(r0 + q) * kSps];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float e, f;
      fit(w, u, e, f);
      de[(r0 + u) * kSps] = e;
      df[(r0 + u) * kSps] = f;
    }
  }
  float w[kSyms];
#pragma unroll
  for (int k = 0; k < kSyms; ++k) w[k] = src[(kChain - 1 + k) * kSps];
  float e, f;
  fit(w, 0, e, f);
  de[(kChain - 1) * kSps] = e;
  df[(kChain - 1) * kSps] = f;
}

__global__ void __launch_bounds__(kThreads, 4)
sync_metric_kernel(const float* __restrict__ ph, float* __restrict__ err,
                   float* __restrict__ freq, int M, int tiles,
                   long long items) {
  __shared__ __align__(16) float win[2][kWinBuf];
  __shared__ __align__(16) float out_e[kOutBuf];
  __shared__ __align__(16) float out_f[kOutBuf];

  const int tid = threadIdx.x;
  const int g = tid / kSps;
  const int o = g * kGroupLen + (tid - g * kSps);  // chain's first output

  long long item = blockIdx.x;
  if (item < items) stage(win[0], item_at(ph, item, tiles, M), M);
  cp_async_commit();
  int buf = 0;
  for (; item < items; item += gridDim.x) {
    const long long next = item + gridDim.x;
    if (next < items) stage(win[buf ^ 1], item_at(ph, next, tiles, M), M);
    cp_async_commit();
    cp_async_wait_prior();         // this item's copies have landed
    __syncthreads();

    const Item it = item_at(ph, item, tiles, M);
    const int L = min(kTile, M - it.n0);
    float* ge = err + it.off + it.n0;
    float* gf = freq + it.off + it.n0;
    const int ae = quad_shift(ge);
    const int af = quad_shift(gf);
    if (o < L) {
      const float* src = win[buf] + win_shift(it) + o;
      fit_chain(src, out_e + ae + o, out_f + af + o);
    }
    __syncthreads();
    if (it.n0 < kLookback) {       // first tile of a row: n < 150
      for (int i = tid; i < min(kLookback - it.n0, L); i += kThreads) {
        out_e[ae + i] = CUDART_INF_F;
        out_f[af + i] = 0.0f;
      }
      __syncthreads();
    }
    store_row(ge, out_e, L);
    store_row(gf, out_f, L);
    buf ^= 1;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `phases`, `err`, `freq`
// are (C, M) contiguous float32 device buffers; launches on `stream`,
// allocates nothing, and returns cudaGetLastError().
extern "C" int sync_metric_launch(const float* phases, float* err,
                                  float* freq, int C, int M, void* stream) {
  if (C <= 0 || M <= 0) return 0;
  const int tiles = (M + kTile - 1) / kTile;
  const long long items = static_cast<long long>(C) * tiles;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sync_metric_kernel, kThreads, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long grid =
      std::min(items, static_cast<long long>(sms) * std::max(per_sm, 1));
  sync_metric_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      phases, err, freq, M, tiles, items);
  return static_cast<int>(cudaGetLastError());
}
