// Gate kernels G1 (gate) and G2 (nf_track) for Hopper (sm_90a).
//
// These replace XLA stages of the JAX package's device gate,
// dumpvdl2_tpu/core/nf_gate.py, not TPU kernels.  The plain versions
// are in dumpvdl2_tpu_torch/core/gate_kernel.py (gate_plain,
// nf_track_plain); on a CUDA tensor the wrappers there launch these.
//
// G1 gate replaces nf_gate._gate (nf_gate.py:133: _slot_inputs :123,
//   the row gathers of hdr_ok and bits_consumed and the float32 ppm, +
//   gate_scan, gate_scan.py:89-163, over the K candidate slots of each
//   channel) and nf_gate._decisions (:144, the hold bookkeeping), and
//   hands the tracker its column bounds (low, f_track: :224-228).
//   Bound: it moves ~0.3 MB at (C, K) = (256, 64), under 0.1 us at
//   3.35 TB/s; what it takes is a launch and a chain of K dependent
//   decisions a channel.  The first version gave one thread to a
//   channel (256 threads on 2 SMs), and each of its 64 steps waited on
//   global loads, among them the dependent gather l2_row -> hdr_rows,
//   bits_rows.  Here one warp takes a channel (4 channels a CTA, 64 CTAs
//   at C = 256): the lanes load 32 slots at a time, coalesced, do the
//   gathers and the float32 ppm and class each slot in parallel; the
//   decision chain then walks the slots from registers (__shfl_sync),
//   with no global load inside it; the hold decisions are its epilogue.
//   Every output is an integer and equals the plain version exactly:
//   the ppm uses the plain version's float32 constant, one IEEE multiply
//   and one IEEE divide (__fmul_rn, __fdiv_rn; the file builds with
//   --fmad=false), int32 sums wrap as JAX's do, ceil_syms floors.
//
// G2 nf_track replaces nf_gate._nf_track up to its ring update
//   (nf_gate.py:186-286): the claimed-window mask over the block's
//   magnitude columns, the hold-release replay of the ring as a prefix
//   of the stream, the masked EMA y = 0.9 y + 0.1 m over the tracked
//   columns, the noise-floor update at every 1000th tracked column and
//   each candidate's floor reading.  The plain version builds (C, R + W)
//   planes for it and runs a 16-step doubling scan over them: several
//   GB of traffic a wideband block.
//   Bound: bytes.  It must read the (C, W) magnitudes once (17.9 MB at
//   (256, 17 476), 5.4 us at 3.35 TB/s), the replayed ring slots and a
//   few bytes a slot; its operations are a handful a column.  What
//   bounds it in practice is latency: the stream is one dependent chain
//   a channel, so the work of a channel cannot leave its CTA, and each
//   tile costs a fold, a CTA-wide scan and a replay in series.
//   Design: one CTA of kTrackThreads a channel (256 CTAs, two an SM)
//   streams the channel's columns once through shared memory (cp.async),
//   in tiles of kTile = 17 920 columns, so that a whole wideband row is
//   one tile: one fold, one scan and one replay, and every load of the
//   row in flight at once.  On the H100, smaller tiles, double-buffered
//   or pipelined deeper, ran slower: each tile adds its scans and syncs
//   to the chain.  Tiles beyond the first (a longer block, a replayed
//   ring) load kStages ahead.  The first tiles' copies fly
//   while the CTA turns the channel's slots into sorted window starts
//   and ends and reading bounds, and [low, f_track) into a column
//   range: 2 K + 2 searches of col_pos, one a thread, each two round
//   trips where col_pos is evenly spaced (search_cols).  In a tile each
//   thread folds a run of kRun consecutive columns into one affine map
//   y -> S y + O and a tracked count; an inclusive warp-shuffle scan and
//   a scan of the warp totals in shared memory give each thread the map
//   in front of its run, applied to the (y, count) carried from the
//   previous tile.  The thread then replays its run from that y and
//   records (y, stream column) wherever the channel's running count
//   nfcnt0 + n reaches a multiple of 1000.  The ring is read only for
//   released channels, only slots < ring_n: every other ring slot is
//   the identity map.  After the stream one thread runs the floor
//   recurrence over the crossings (at most cap = (R + W) / 1000 + 1),
//   then each candidate finds its reading by a binary search of the
//   ascending crossing columns.
//   Exactness: the tracked mask, the count, which crossings happen and
//   their columns are integers and equal the plain version's.  The
//   in-window test is #{window starts <= j} - #{window ends <= j} > 0,
//   the plain version's cumsum of its difference array, inverted
//   windows included.  The EMA is summed in another association than
//   the plain doubling scan (and JAX's associative_scan), so y, and the
//   floor through y, agree to rtol 1e-5: with a coefficient of 0.9 a
//   product of scales falls below float32 resolution within a few
//   hundred columns, so rounding does not build up over a 50 000-column
//   stream.  The floor update keeps the plain order, (a nf + b min(y,
//   nf)) + eps, each op rounded, NaN-propagating min.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kSps = 10;           // decimated samples per symbol
constexpr int kMinHdrSyms = 10;    // (HEADER_LEN + 2) // 3 + 1
constexpr int kFloor = -(1 << 30); // "long in the past" (nf_gate._FLOOR)
// float32(SYMBOL_RATE * 1e6 / (2 pi)): ppm = kPpmScale * dphi / freq
constexpr float kPpmScale = 0x1.8e6d7ep+30f;
constexpr float kNfA = 0x1.b33334p-1f;     // float32(NF_LP), 0.85
constexpr float kNfB = 0x1.333334p-3f;     // float32(1 - NF_LP)
constexpr float kNfEps = 0x1.a36e2ep-14f;  // float32(1e-4)
constexpr float kMagA = 0x1.ccccccp-1f;    // float32(MAG_LP), 0.9
constexpr float kMagB = 0x1.99999ap-4f;    // float32(1 - MAG_LP)
constexpr int kNfEvery = 1000;             // tracked columns a floor update

constexpr int kGateWarps = 4;                    // G1: channels a CTA
constexpr int kTrackThreads = 512;               // G2: threads a channel
constexpr int kTrackWarps = kTrackThreads / 32;
constexpr int kRun = 35;                         // columns a thread a tile
constexpr int kTile = kTrackThreads * kRun;      // 17 920 columns
constexpr int kStages = 1;                       // tiles in flight
static_assert(kRun % 2 == 1, "odd runs: lane t reads bank kRun t mod 32");
static_assert(kRun <= 64, "a run's tracked flags fit one word");

// verdict codes (core/gate_scan.py)
constexpr int kEmpty = 0, kSkip = 1, kL2Overflow = 2, kDefer = 3,
              kEofShort = 4, kHdrReject = 5, kEofTrunc = 6,
              kPpmReject = 7, kAccept = 8, kUnprocessed = 9,
              kDeferData = 10;

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) *
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wneg(int a) {
  return static_cast<int>(0u - static_cast<unsigned>(a));
}

// -(-bits // 3) with floor division, as the plain version computes it.
__device__ __forceinline__ int ceil_syms(int bits) {
  const int n = wneg(bits);
  int q = n / 3;
  if (n % 3 != 0 && n < 0) q -= 1;
  return wneg(q);
}

// ------------------------------------------------------------------ G1
__global__ void __launch_bounds__(32 * kGateWarps) gate_kernel(
    const int* __restrict__ count, const int* __restrict__ det,
    const int* __restrict__ sync, const int* __restrict__ sym_valid,
    const float* __restrict__ dphi, const int* __restrict__ l2_row,
    const uint8_t* __restrict__ hdr_rows,
    const int* __restrict__ bits_rows, int B,
    const int* __restrict__ busy0, const int* __restrict__ next0,
    const int* __restrict__ hold0, const uint8_t* __restrict__ hold_act0,
    const float* __restrict__ freqs, float max_ppm, int eof, int end_rel,
    int C, int K, int8_t* __restrict__ verdicts, int* __restrict__ bits_out,
    int* __restrict__ busy1, int* __restrict__ next1,
    int* __restrict__ deferred_at, int* __restrict__ drop_end,
    int* __restrict__ ring_filter, int* __restrict__ hold1,
    int* __restrict__ low, int* __restrict__ f_track,
    uint8_t* __restrict__ released, uint8_t* __restrict__ persist,
    uint8_t* __restrict__ hold_act1) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kGateWarps + (threadIdx.x >> 5);
  if (c >= C) return;                // a whole warp
  const int busy_in = busy0[c];
  int busy = busy_in;
  int nxt = next0[c];
  int deferred = -1;
  bool stopped = false;
  bool any_dec = false;              // the first decided slot:
  int fv = kEmpty, fsync = 0, fbusy = 0;  // verdict, sync, busy after
  const int cnt = count[c];
  const float freq = freqs[c];
  const bool gate_on = max_ppm > 0.0f;
  const long long row0 = static_cast<long long>(c) * K;
  for (int k0 = 0; k0 < K; k0 += 32) {
    // each lane classes one slot: the verdict it gets if it is reached
    // (neither past count, nor after a deferral, nor skipped) and the
    // busy frontier it then claims
    const int k = k0 + lane;
    int det_g = 0, sp_g = 0, cls = kEmpty, claim = 0;
    if (k < K) {
      const long long i = row0 + k;
      const int row = l2_row[i];
      const bool has_row = row >= 0;
      const int safe = min(max(row, 0), B - 1);
      const bool hdr_ok = has_row && hdr_rows[safe] != 0;
      const int bits = has_row ? bits_rows[safe] : 0;
      bits_out[i] = bits;
      det_g = det[i];
      sp_g = sync[i];
      const int nsyms = sym_valid[i];
      if (!has_row) {
        cls = kL2Overflow;
      } else if (nsyms < kMinHdrSyms) {
        cls = eof ? kEofShort : kDefer;
      } else if (!hdr_ok) {
        cls = kHdrReject;
        claim = wadd(sp_g, 9 * kSps);
      } else {
        const int total = ceil_syms(bits);
        const float ppm = __fdiv_rn(__fmul_rn(kPpmScale, dphi[i]), freq);
        if (nsyms < total) {
          cls = eof ? kEofTrunc : kDeferData;
        } else if (gate_on && fabsf(ppm) > max_ppm) {
          cls = kPpmReject;
        } else {
          cls = kAccept;
          claim = wadd(sp_g, wmul(total, kSps));
        }
      }
    }
    // the decision chain over these slots: every lane walks it with the
    // same values, and lane j keeps slot j's verdict
    int mine = kEmpty;
    const int n = min(32, K - k0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int dj = __shfl_sync(kFull, det_g, j);
      const int sj = __shfl_sync(kFull, sp_g, j);
      const int cj = __shfl_sync(kFull, cls, j);
      const int bj = __shfl_sync(kFull, claim, j);
      int v;
      if (k0 + j >= cnt) {
        v = kEmpty;
      } else if (stopped) {
        v = kUnprocessed;
      } else if (dj < nxt || dj < busy) {
        v = kSkip;
      } else {
        v = cj;
        if (cj == kDefer || cj == kDeferData) {
          nxt = dj;
          if (deferred < 0) deferred = dj;
          stopped = true;
        } else {
          if (cj == kHdrReject || cj == kAccept) busy = bj;
          nxt = wadd(dj, 1);
          if (!any_dec) {
            any_dec = true;
            fv = cj;
            fsync = sj;
            fbusy = bj;
          }
        }
      }
      if (lane == j) mine = v;
    }
    if (k < K) verdicts[row0 + k] = static_cast<int8_t>(mine);
  }
  if (lane != 0) return;
  // nf_gate._decisions, and the tracker's bounds
  const int h0 = hold0[c];
  const bool hact = hold_act0[c] != 0;
  const bool rel = hact && (any_dec || (deferred < 0 && h0 >= 0));
  const bool pers = hact && !rel;
  const bool f_adv = any_dec && (fv == kHdrReject || fv == kAccept);
  const int dend = (hact && f_adv) ? fsync : kFloor;
  busy1[c] = busy;
  next1[c] = nxt;
  deferred_at[c] = deferred;
  drop_end[c] = dend;
  ring_filter[c] = f_adv ? fbusy : busy_in;
  hold1[c] = deferred >= 0 ? (pers ? min(h0, deferred) : deferred) : h0;
  low[c] = max(busy_in, dend);
  f_track[c] = pers ? kFloor : (deferred >= 0 ? deferred : end_rel);
  released[c] = rel;
  persist[c] = pers;
  hold_act1[c] = pers || deferred >= 0;
}

// ------------------------------------------------------------------ G2
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kStages - 1 copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
}

// First index i in [0, n) with x[i] >= v (n if none), as
// torch.searchsorted(x, v) on ascending x.
__device__ __forceinline__ int lower_bound(const int* x, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// lower_bound on the block's column positions, in two round trips
// where they are evenly spaced (as col_pos is on the single-device
// path) rather than log2(W) ~ 15 dependent loads: x[0] and x[n - 1]
// bracket v, linear interpolation guesses the index, one probe of
// x[g - 1], x[g] confirms it, and a binary search of the bracket the
// probe leaves finds it otherwise.  Exact for any increasing x.
__device__ __forceinline__ int search_cols(const int* x, int n, int v) {
  if (n == 0) return 0;
  const int x0 = x[0], x1 = x[n - 1];
  if (v <= x0) return 0;
  if (v > x1) return n;
  // x0 < v <= x1: the answer is in [1, n - 1]
  const double guess = ceil(static_cast<double>(v - static_cast<long long>(x0))
                            * (n - 1) / (static_cast<double>(x1) - x0));
  const int g = static_cast<int>(fmin(fmax(guess, 1.0), n - 1.0));
  const int below = x[g - 1], at = x[g];
  if (below < v && v <= at) return g;
  int lo = at < v ? g + 1 : 1;
  int hi = at < v ? n - 1 : g - 1;    // x[hi] >= v
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First index i in [0, n) with x[i] > v (n if none).
__device__ __forceinline__ int upper_bound(const int* x, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct Tile {
  const float* src;   // first value of the tile
  int len;            // values in the tile
  int first;          // ring slot or block column of src[0]
  bool ring;
};

// The stream is the replayed ring slots [0, n_ring) then the block's
// columns [0, W), in tiles of kTile.
__device__ __forceinline__ Tile tile_at(int t, int ring_tiles, int n_ring,
                                        const float* ring_row,
                                        const float* mag_row, int W) {
  if (t < ring_tiles) {
    const int first = t * kTile;
    return {ring_row + first, min(kTile, n_ring - first), first, true};
  }
  const int first = (t - ring_tiles) * kTile;
  return {mag_row + first, min(kTile, W - first), first, false};
}

__device__ __forceinline__ void stage(float* buf, const Tile& tl) {
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int e = i * kTrackThreads + threadIdx.x;
    if (e < tl.len) cp_async4(buf + e, tl.src + e);
  }
}

// Shared memory: kStages tile buffers, then the window starts and ends
// (K + 1 each, sorted, INT_MAX-padded), their unsorted form (K each),
// the reading bounds (K), the crossing columns and values (cap each).
__global__ void __launch_bounds__(kTrackThreads, 2) nf_track_kernel(
    const float* __restrict__ mags, const int* __restrict__ col_pos, int W,
    const int8_t* __restrict__ verdicts, const int* __restrict__ sync,
    const int* __restrict__ bits, int K, const int* __restrict__ low,
    const int* __restrict__ f_track, const uint8_t* __restrict__ released,
    const int* __restrict__ ring_filter, const int* __restrict__ ring_pos,
    const float* __restrict__ ring_val, const int* __restrict__ ring_n,
    int R, const float* __restrict__ mag_lp0,
    const float* __restrict__ mag_nf0, const int* __restrict__ nfcnt0,
    int cap, float* __restrict__ mag_lp1, float* __restrict__ mag_nf1,
    int* __restrict__ nfcnt1, float* __restrict__ nf_read,
    int* __restrict__ jc_out) {
  extern __shared__ __align__(16) float smem[];
  int* s_a = reinterpret_cast<int*>(smem + kStages * kTile);
  int* s_b = s_a + (K + 1);
  int* raw_a = s_b + (K + 1);
  int* raw_b = raw_a + K;
  int* s_bound = raw_b + K;
  int* s_jc = s_bound + K;
  float* s_y = reinterpret_cast<float*>(s_jc + cap);
  __shared__ float w_s[kTrackWarps], w_o[kTrackWarps];
  __shared__ int w_n[kTrackWarps];
  __shared__ float carry_y;
  __shared__ int carry_n, blk_lo, blk_hi;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long crow = static_cast<long long>(c) * K;
  const int n_ring = released[c] ? ring_n[c] : 0;
  const int ring_tiles = (n_ring + kTile - 1) / kTile;
  const int tiles = ring_tiles + (W + kTile - 1) / kTile;
  const float* ring_row = ring_val + static_cast<long long>(c) * R;
  const int* rpos_row = ring_pos + static_cast<long long>(c) * R;
  const float* mag_row = mags + static_cast<long long>(c) * W;

  // the first tiles' copies fly while the windows are set up
  for (int t = 0; t < kStages; ++t) {
    if (t < tiles)
      stage(smem + t * kTile,
            tile_at(t, ring_tiles, n_ring, ring_row, mag_row, W));
    cp_async_commit();
  }

  // 2 K + 2 binary searches, one a thread: each slot's window start
  // (= its reading bound) and end, and the tracked range
  for (int i = tid; i < 2 * K + 2; i += kTrackThreads) {
    if (i < 2 * K) {
      const int k = i < K ? i : i - K;
      const int v = verdicts[crow + k];
      const int sp = sync[crow + k];
      const bool rej = v == kHdrReject;
      const bool win = rej || v == kAccept;
      if (i < K) {
        const int a = search_cols(col_pos, W, sp);
        s_bound[k] = R + a;
        raw_a[k] = win ? a : INT_MAX;   // no window: never <= a column
      } else {
        raw_b[k] = win ? search_cols(col_pos, W,
                                     wadd(sp, rej ? 9 * kSps
                                                  : wmul(ceil_syms(
                                                        bits[crow + k]),
                                                         kSps)))
                       : INT_MAX;
      }
    } else if (i == 2 * K) {
      blk_lo = search_cols(col_pos, W, low[c]);
    } else {
      blk_hi = search_cols(col_pos, W, f_track[c]);
    }
  }
  if (tid == 0) {
    carry_y = mag_lp0[c];
    carry_n = 0;
    s_a[K] = INT_MAX;
    s_b[K] = INT_MAX;
  }
  __syncthreads();
  // sort the starts and the ends (rank sort, ties by slot)
  for (int k = tid; k < K; k += kTrackThreads) {
    const int a = raw_a[k], b = raw_b[k];
    int ra = 0, rb = 0;
    for (int q = 0; q < K; ++q) {
      const int aq = raw_a[q], bq = raw_b[q];
      ra += (aq < a || (aq == a && q < k)) ? 1 : 0;
      rb += (bq < b || (bq == b && q < k)) ? 1 : 0;
    }
    s_a[ra] = a;
    s_b[rb] = b;
  }
  const int nf_base = nfcnt0[c];      // in [0, 1000): the carried state
  const int rfilt = ring_filter[c];
  __syncthreads();
  const int lo = blk_lo, hi = blk_hi;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait_stages();          // this tile's copies have landed
    __syncthreads();
    float* cur = smem + (t % kStages) * kTile;

    const Tile tl = tile_at(t, ring_tiles, n_ring, ring_row, mag_row, W);
    const int e0 = tid * kRun;
    // fold the run: y -> S y + O, n tracked columns
    float S = 1.0f, O = 0.0f;
    int n = 0;
    unsigned long long tracked = 0;
    if (tl.ring) {
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int e = e0 + i;
        if (e < tl.len && rpos_row[tl.first + e] >= rfilt)
          tracked |= 1ull << i;
      }
    } else {
      const int j0 = tl.first + e0;
      int ca = upper_bound(s_a, K, j0);   // starts <= j
      int cb = upper_bound(s_b, K, j0);   // ends <= j
      int next_a = s_a[ca], next_b = s_b[cb];
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int j = j0 + i;
        while (next_a <= j) next_a = s_a[++ca];
        while (next_b <= j) next_b = s_b[++cb];
        if (e0 + i < tl.len && j >= lo && j < hi && ca - cb <= 0)
          tracked |= 1ull << i;
      }
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (tracked >> i & 1ull) {
        S = __fmul_rn(S, kMagA);
        O = __fadd_rn(__fmul_rn(O, kMagA), __fmul_rn(cur[e0 + i], kMagB));
        ++n;
      }
    }
    // inclusive scan of the runs' maps across the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float s_up = __shfl_up_sync(kFull, S, d);
      const float o_up = __shfl_up_sync(kFull, O, d);
      const int n_up = __shfl_up_sync(kFull, n, d);
      if (lane >= d) {
        O = __fadd_rn(__fmul_rn(o_up, S), O);
        S = __fmul_rn(s_up, S);
        n += n_up;
      }
    }
    if (lane == 31) {
      w_s[warp] = S;
      w_o[warp] = O;
      w_n[warp] = n;
    }
    // exclusive: the lanes before this one
    float es = __shfl_up_sync(kFull, S, 1);
    float eo = __shfl_up_sync(kFull, O, 1);
    int en = __shfl_up_sync(kFull, n, 1);
    if (lane == 0) {
      es = 1.0f;
      eo = 0.0f;
      en = 0;
    }
    __syncthreads();
    // the warps before this one, then the carry from earlier tiles
    float ps = 1.0f, po = 0.0f;
    int pn = 0;
    for (int q = 0; q < warp; ++q) {
      po = __fadd_rn(__fmul_rn(po, w_s[q]), w_o[q]);
      ps = __fmul_rn(ps, w_s[q]);
      pn += w_n[q];
    }
    const float in_s = __fmul_rn(ps, es);
    const float in_o = __fadd_rn(__fmul_rn(po, es), eo);
    float y = __fadd_rn(__fmul_rn(in_s, carry_y), in_o);
    int seen = carry_n + pn + en;     // tracked columns before the run
    // replay the run; a floor update at every 1000th tracked column
    int to_next = kNfEvery - (nf_base + seen) % kNfEvery;
    const int col0 = (tl.ring ? 0 : R) + tl.first + e0;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (tracked >> i & 1ull) {
        y = __fadd_rn(__fmul_rn(y, kMagA), __fmul_rn(cur[e0 + i], kMagB));
        ++seen;
        if (--to_next == 0) {
          to_next = kNfEvery;
          const int m = (nf_base + seen) / kNfEvery - 1;
          if (m < cap) {
            s_y[m] = y;
            s_jc[m] = col0 + i;
          }
        }
      }
    }
    __syncthreads();     // every thread has read the carry and the tile
    if (tid == kTrackThreads - 1) {
      carry_y = y;
      carry_n = seen;
    }
    if (t + kStages < tiles)
      stage(cur, tile_at(t + kStages, ring_tiles, n_ring, ring_row, mag_row,
                         W));
    cp_async_commit();
    __syncthreads();
  }

  // the floor recurrence over the crossings, then the readings
  const int total = nf_base + carry_n;
  const int ncross = min(total / kNfEvery, cap);
  const float nf0 = mag_nf0[c];
  if (tid == 0) {
    float nf = nf0;
    for (int m = 0; m < ncross; ++m) {
      const float yv = s_y[m];
      // torch.minimum: NaN if either is NaN
      const float mn = (yv < nf || yv != yv) ? yv : nf;
      nf = __fadd_rn(__fadd_rn(__fmul_rn(kNfA, nf), __fmul_rn(kNfB, mn)),
                     kNfEps);
      s_y[m] = nf;
    }
    mag_lp1[c] = carry_y;
    mag_nf1[c] = nf;
    nfcnt1[c] = total % kNfEvery;
  }
  const long long jrow = static_cast<long long>(c) * cap;
  for (int m = tid; m < cap; m += kTrackThreads)
    jc_out[jrow + m] = m < ncross ? s_jc[m] : -1;
  __syncthreads();
  for (int k = tid; k < K; k += kTrackThreads) {
    const int r = lower_bound(s_jc, ncross, s_bound[k]);
    nf_read[crow + k] = r > 0 ? s_y[r - 1] : nf0;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a
// contiguous device buffer of the shape named in core/gate_kernel.py;
// each launches on `stream`, allocates nothing, and returns a CUDA
// error code (0 on success).
extern "C" int gate_launch(
    const int* count, const int* det, const int* sync, const int* sym_valid,
    const float* dphi, const int* l2_row, const uint8_t* hdr_rows,
    const int* bits_rows, int B, const int* busy0, const int* next0,
    const int* hold0, const uint8_t* hold_act0, const float* freqs,
    float max_ppm, int eof, int end_rel, int C, int K, int8_t* verdicts,
    int* bits, int* busy1, int* next1, int* deferred_at, int* drop_end,
    int* ring_filter, int* hold1, int* low, int* f_track, uint8_t* released,
    uint8_t* persist, uint8_t* hold_act1, void* stream) {
  if (C <= 0) return 0;
  const int blocks = (C + kGateWarps - 1) / kGateWarps;
  gate_kernel<<<blocks, 32 * kGateWarps, 0,
                static_cast<cudaStream_t>(stream)>>>(
      count, det, sync, sym_valid, dphi, l2_row, hdr_rows, bits_rows, B,
      busy0, next0, hold0, hold_act0, freqs, max_ppm, eof, end_rel, C, K,
      verdicts, bits, busy1, next1, deferred_at, drop_end, ring_filter,
      hold1, low, f_track, released, persist, hold_act1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_track_launch(
    const float* mags, const int* col_pos, int W, const int8_t* verdicts,
    const int* sync, const int* bits, int K, const int* low,
    const int* f_track, const uint8_t* released, const int* ring_filter,
    const int* ring_pos, const float* ring_val, const int* ring_n, int R,
    const float* mag_lp0, const float* mag_nf0, const int* nfcnt0, int C,
    int cap, float* mag_lp1, float* mag_nf1, int* nfcnt1, float* nf_read,
    int* jc, void* stream) {
  if (C <= 0) return 0;
  // dynamic shared memory: see nf_track_kernel
  const long long smem =
      4LL * (kStages * kTile + 2LL * (K + 1) + 3LL * K + 2LL * cap);
  int dev = 0, optin = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (smem > optin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(nf_track_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  nf_track_kernel<<<C, kTrackThreads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      mags, col_pos, W, verdicts, sync, bits, K, low, f_track, released,
      ring_filter, ring_pos, ring_val, ring_n, R, mag_lp0, mag_nf0, nfcnt0,
      cap, mag_lp1, mag_nf1, nfcnt1, nf_read, jc);
  return static_cast<int>(cudaGetLastError());
}
