// Candidate-search kernel KC (find_candidates) for Hopper (sm_90a).
//
// KC replaces an XLA stage of the JAX package's detector, not a TPU
// kernel: dumpvdl2_tpu/dsp/demod.py:159-243, find_candidates_impl after
// the sync metric (_metric, kernel K1).  The plain version is
// dumpvdl2_tpu_torch/dsp/candidates_kernel.py::candidates_plain; on a
// CUDA tensor the wrapper there launches this.
//
// It reads K1's (err, freq), each (C, M) float32, and gives each
// channel row its detections:
//   * a crossing at sample i: (e1 < threshold) & (err[i] > e1), e1 =
//     err[i - 1] (column 0 wraps to M - 1, as the plain roll does),
//     off below max(LOOKBACK + 2, detect_lo) and from detect_hi on;
//   * a leader: a crossing with no crossing in [max(0, i - 20), i - 1]
//     (kNmsWin = 2 SPS);
//   * count = every leader of the row, uncapped; the first K leaders in
//     ascending order, -1 padded, with their gathers y1, y2, y3 =
//     err[det - 2], err[det - 1], err[det], dphi = freq[det - 1] and
//     pherr = y2 (indices clamped at 0, so an empty slot reads column
//     0), the parabola vertex's symbol clock, sync_idx = det - sclk and
//     the demodulable symbol count.
// The plain version runs ~90 launches on the row: a roll and compares,
// an int32 cumsum and two rolls for the leader rule, and a segmented
// first-K extraction (8 masked minimum passes over an int64 (C, G, 128)
// table, then a top-k).  Its leader-rule guarantee (leaders are > 20
// samples apart, so a 128-sample segment holds at most 7 <= _SEG_P) makes
// that extraction equal to the plain ascending order of all leaders,
// which is what KC computes directly.
//
// Bound: bytes.  It must read the (C, M) err plane once (111 MB at
// (256, 108 844), 33 us at 3.35 TB/s) and a few gathered values a slot;
// a sample costs a handful of compares.  Design: one CTA of kThreads a
// channel row streams the row in tiles of kTile = 8 192 samples through
// shared memory (coalesced loads, 32 in flight a thread; a spare word
// every 32 keeps each thread's run in its own bank).  Thread t turns
// samples [32 t, 32 t + 32) of the tile into one 32-bit crossing word;
// the leader rule is then bit arithmetic on that word and the one before
// it (the previous thread's, or the previous tile's last, carried in
// shared memory): the crossings in the 20 samples before each bit are an
// OR of shifted copies of the 64-bit pair.  A block scan of the words'
// population counts ranks the leaders; a leader of rank < K writes its
// slot.  After the row the CTA's threads take the K slots: the gathers,
// the vertex and the symbol count.
//
// Exactness: every integer equals the plain version's, and the floats
// are gathers or the plain version's arithmetic in its order:
// a = ((y1 - 2 y2) + y3) / 2, b = ((3 y3 - 4 y2) + y1) / 2, each op
// rounded (the file builds with --fmad=false), |a| > 1e-12 (the float32
// constant the plain comparison uses), the vertex -b / (2 a) an IEEE
// division, round half to even (rintf), sync_idx and the symbol count in
// int64 like the plain version's (the count floors for negative
// numerators), then cut to int32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSps = 10;                       // SPS
constexpr int kNmsWin = 2 * kSps;              // _NMS_WIN
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 32;                       // samples a thread: a word
constexpr int kTile = kThreads * kRun;         // 8 192 samples
constexpr unsigned kFull = 0xffffffffu;

static_assert(kNmsWin < kRun, "the leader window spans one earlier word");

// Shared index of tile sample j: one spare word every 32, so that the
// threads' runs [32 t, 32 t + 32) start in distinct banks.  Slot 0 holds
// the sample before the tile.
__device__ __forceinline__ int spad(int j) { return 1 + j + (j >> 5); }

// Exclusive block scan of v over kThreads; *total gets the sum.
__device__ __forceinline__ int block_excl_scan(int v, int* warp_buf,
                                               int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_buf[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) warp_buf[lane] = w;       // inclusive warp totals
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_buf[warp - 1];
  *total = warp_buf[kWarps - 1];
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads) candidates_kernel(
    const float* __restrict__ err, const float* __restrict__ freq, int M,
    float threshold, int K, int S, int lo, int hi, int* __restrict__ count,
    int* __restrict__ det_idx, int* __restrict__ sync_idx,
    float* __restrict__ dphi, float* __restrict__ pherr,
    int* __restrict__ sym_valid) {
  __shared__ float e_s[1 + kTile + kTile / 32];
  __shared__ unsigned w_s[1 + kThreads];       // w_s[0]: the word before
  __shared__ int warp_buf[kWarps];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const float* row = err + static_cast<long long>(c) * M;
  int* det_row = det_idx + static_cast<long long>(c) * K;
  if (t == 0) {
    e_s[0] = row[M - 1];                       // roll: e1 of column 0
    w_s[0] = 0u;
  }
  int found = 0;                               // leaders before the tile

  for (int tile0 = 0; tile0 < M; tile0 += kTile) {
    // ---- stage the tile, coalesced ---------------------------------
#pragma unroll 8
    for (int i = 0; i < kRun; ++i) {
      const int j = i * kThreads + t;
      const int g = tile0 + j;
      e_s[spad(j)] = g < M ? row[g] : 0.0f;
    }
    __syncthreads();

    // ---- crossings of this thread's run as one word ------------------
    const int j0 = kRun * t;
    float e1 = e_s[j0 == 0 ? 0 : spad(j0 - 1)];
    unsigned w = 0u;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const float e = e_s[spad(j0 + k)];
      const int g = tile0 + j0 + k;
      const bool hit = g >= lo && g < hi && e1 < threshold && e > e1;
      w |= static_cast<unsigned>(hit) << k;
      e1 = e;
    }
    w_s[1 + t] = w;
    __syncthreads();

    // ---- leaders: no crossing in the kNmsWin samples before ----------
    const unsigned long long x =
        (static_cast<unsigned long long>(w) << 32) | w_s[t];
    const unsigned long long y1 = x << 1;                  // p-1
    const unsigned long long y2 = y1 | (y1 << 1);          // p-1..p-2
    const unsigned long long y4 = y2 | (y2 << 2);          // p-1..p-4
    const unsigned long long y8 = y4 | (y4 << 4);          // p-1..p-8
    const unsigned long long y16 = y8 | (y8 << 8);         // p-1..p-16
    const unsigned long long y20 = y16 | (y4 << 16);       // p-1..p-20
    unsigned lead = w & ~static_cast<unsigned>(y20 >> 32);

    int tile_total;
    int rank = found + block_excl_scan(__popc(lead), warp_buf, &tile_total);
    while (lead != 0u && rank < K) {
      const int k = __ffs(lead) - 1;
      det_row[rank++] = tile0 + j0 + k;
      lead &= lead - 1u;
    }
    found += tile_total;
    // the carry into the next tile, read before the next staging
    // overwrites it; slot 0 of each is read only by thread 0
    const float e_last = e_s[spad(kTile - 1)];
    const unsigned w_last = w_s[kThreads];
    __syncthreads();                           // w_s, e_s, warp_buf reads done
    if (t == 0) {
      w_s[0] = w_last;
      e_s[0] = e_last;
    }
  }
  __syncthreads();                             // det_row writes visible

  if (t == 0) count[c] = found;
  const float* frow = freq + static_cast<long long>(c) * M;
  const int n_valid = min(found, K);
  for (int k = t; k < K; k += kThreads) {
    const bool valid = k < n_valid;
    const int det = valid ? det_row[k] : -1;
    const float y3 = row[max(det, 0)];
    const float y2 = row[max(det - 1, 0)];
    const float y1 = row[max(det - 2, 0)];
    const float a = ((y1 - 2.0f * y2) + y3) / 2.0f;
    const float b = ((3.0f * y3 - 4.0f * y2) + y1) / 2.0f;
    const bool safe = fabsf(a) > 1e-12f;
    const float vertex = safe ? __fdiv_rn(-b, 2.0f * a) : -1.0f;
    const long long sclk =
        valid ? static_cast<long long>(rintf(-vertex)) : 0ll;
    const long long sp = valid ? det - sclk : -1ll;
    const long long num = static_cast<long long>(M) - 1 - sp;
    long long q = num / kSps;
    if (num % kSps != 0 && num < 0) --q;       // floor division
    const long long nvalid = min(max(q, 0ll), static_cast<long long>(S));
    const long long o = static_cast<long long>(c) * K + k;
    det_row[k] = det;
    sync_idx[o] = static_cast<int>(sp);
    dphi[o] = frow[max(det - 1, 0)];
    pherr[o] = y2;
    sym_valid[o] = valid ? static_cast<int>(nvalid) : 0;
  }
}

}  // namespace

// C entry point, loaded with ctypes by
// dumpvdl2_tpu_torch/dsp/candidates_kernel.py: launches on `stream`,
// allocates nothing, and returns a CUDA error code (0 = launched).
// [lo, hi) is the window detections may fire in, already clipped to
// [max(LOOKBACK + 2, detect_lo), min(detect_hi, M)) by the wrapper.
extern "C" int candidates_launch(const float* err, const float* freq, int C,
                                 int M, float threshold, int K, int S,
                                 int lo, int hi, int* count, int* det_idx,
                                 int* sync_idx, float* dphi, float* pherr,
                                 int* sym_valid, void* stream) {
  if (C <= 0 || M <= 0) return 0;
  candidates_kernel<<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      err, freq, M, threshold, K, S, lo, hi, count, det_idx, sync_idx, dphi,
      pherr, sym_valid);
  return static_cast<int>(cudaGetLastError());
}
