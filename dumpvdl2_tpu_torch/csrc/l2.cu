// L2 kernels L2H (l2_header, and l2_front: the sliced L2 step's front),
// L2P (l2_payload), L2D (l2_deinterleave) and RS (rs_verify) for Hopper
// (sm_90a).
//
// These replace the XLA stages of the JAX package's L2 step, which it
// compiles into one executable (dumpvdl2_tpu/core/pipeline.py:121-204,
// fec/l2_tpu.py:63, fec/rs_tpu.py:120 and :252), not TPU kernels.  The
// plain versions are in dumpvdl2_tpu_torch/fec/l2_kernel.py
// (l2_front_plain, l2_header_plain, l2_payload_plain,
// l2_payload_capped_plain, l2_deinterleave_plain, rs_verify_plain); on a
// CUDA tensor the wrappers there launch these.
// Every output but the frame power is an integer or a byte and equals
// the plain version's exactly, on any input: int32 sums wrap as
// PyTorch's do (wadd, wmul), and every GF(256) product is the exact field
// product, however the plain version forms it (log tables or carry-less
// shifts).  The constant tables (exp/log, the header syndrome table, its
// weights and parity rows, the PRBS and its octets, the Gray code) come
// from the port's Python tables, through the wrappers.
//
// L2H l2_header replaces fec/l2_tpu.py:63's header part: the 25 header
//   bits from the first 9 symbols, descrambled, the (25,20) header FEC,
//   the bit-reversed transmission length, the reserved/too-long/no-FEC
//   checks and the RS geometry (write_header).  A thread a burst.  Bound:
//   it reads 9 symbols a burst and writes 36 bytes: under 0.1 us for
//   1 024 bursts; what it takes is a launch.  It runs on pre-sliced
//   symbols (the mesh's launch_compacted_l2, l2_decode_batch).
//
// L2H l2_front replaces the front of the sliced L2 step,
//   dumpvdl2_tpu/core/pipeline.py:121-188 (_l2_sliced_impl up to the
//   decode) with demod.py:245-258 (demod_window), the header part of
//   fec/l2_tpu.py:63 and its frame power.  The plain version runs ~40
//   launches: an argsort and index put for the slot compaction, two
//   (cap, S + 1) gathers, the D8PSK passes, L2H, and the frame-power
//   mask and sum.  Here a CTA takes a row r of the cap = min(C K,
//   max(256, 4 C)) rows:
//   1. its slot: when the slots do not all fit, valid slots (k <
//      count[c]) first, then the others, each in index order.  A block
//      scan of min(count, K) over the channels gives nv and each
//      channel's valid slots before it pv (and empty ones, c K - pv), so
//      row r is valid slot r - pv of its channel or empty slot vc + (r -
//      nv - pi); the CTA also writes inv (slot -> row, -1 past the cap)
//      for the channels c == r (mod cap);
//   2. the window: phases at start + SPS j, j <= S, start = clamp(sp, 0,
//      M), zero past M, into shared memory;
//   3. the decisions: (ph[s+1] - ph[s]) - dphi, the two 2 pi wraps with
//      the float32 constant, an IEEE division by the float32 pi / 4,
//      round half to even, mod 8, the Gray code; the (cap, S) symbols L2P
//      reads;
//   4. the header (write_header) from the first 9 symbols;
//   5. the frame power of an accepted row: the mean of pwr at start +
//      SPS (s + 1), s < max(ceil(bits_consumed / 3), 1), summed in double
//      (the plain float32 sum runs in another order: rtol 1e-6), else 0.
//   Bound: bytes, the distinct samples its windows read (empty slots of
//   a channel share one) and the symbols out: ~9 MB a wideband block;
//   the window gathers are strided (SPS floats apart) and each row waits
//   on them before its decisions.
//
// L2P l2_payload replaces the payload part of the same function and
//   fec/rs_tpu.py:252 rs_verify_batch (with :120 rs_decode_batch) on the
//   main path: octet packing, the deinterleave into each burst's 9 x 255
//   RS table, each row's parity count, and the RS(255,249) errors-and-
//   erasures decode of every row, the absent parity positions
//   KK + fec_octets + j (clamped to NN - 1) as erasures.  The plain
//   version builds (B, 3 S) int32 bit planes and a (B, 2 100) octet
//   plane, gathers the table, and runs the decoder's ~2 000 batch-wide
//   steps.  Here a CTA takes a burst, a warp each of its 9 rows, and the
//   table never leaves shared memory:
//   1. a rejected burst (no RS row) writes its zero table, counts and
//      parity counts and stops;
//   2. an accepted one stages its symbols up to its last parity octet
//      into shared memory (16-byte cp.async for the aligned middle, bytes
//      at the ragged ends) and, in the same wait, the constant bytes:
//      the exp/log tables and the PRBS packed a payload octet;
//   3. octet o is 3 or 4 shared symbol reads, a bit reversal and one XOR
//      with its PRBS octet;
//   4. the 9 x 255 table is the deinterleave gather of those octets;
//   5. warp r decodes row r in place (rs_decode_row): a row without
//      parity or with a zero syndrome stops at once;
//   6. the table goes out in coalesced byte stores, then the counts.
//   CTA bp decodes row bp, or where the batch is capped (the sliced
//   path, the mesh) the hdr-ok compaction's row bp: it finds that row by
//   a block scan of hdr_ok over the B rows (accepted rows first, each
//   part in index order; compact_row) and writes blocks_row for the
//   rows i == bp (mod Bp).
//   Geometry that no header gives (the wrapper takes any) packs all
//   2 100 octets, so the gather's clamp reads what the plain one reads.
//   Bound: bytes, the accepted bursts' staged symbols and the table out
//   (2 295 B and 72 B of counts a burst); a burst is one chain of
//   dependent steps, so what it takes is latency.
//
// L2D l2_deinterleave is L2P without step 5 (the table and the parity
//   counts); RS rs_verify stages each row (a warp a row, 8 a CTA) from
//   global memory into shared memory and runs the same rs_decode_row.
//   Neither runs on the main path: L2D is the stage's own entry point
//   and RS that of fec/rs_batch.py::rs_verify_batch.
//
// rs_decode_row: lane l holds positions l + 32 m.  The 6 syndromes are
//   lane partials XOR-reduced by shuffles; every lane runs the erasure
//   locator and Berlekamp-Massey on the same 7 coefficients in
//   registers; Chien and Forney evaluate each lane's 8 positions; the
//   root count is a warp sum, a zero Forney denominator at a root a
//   warp vote.  Failure rules, as the plain version's: deg_lambda is the
//   highest index with lambda != 0; omega is cut at deg_lambda - 1; the
//   Forney denominator takes the odd lambda terms up to
//   min(deg_lambda, 5) & ~1; a root count other than deg_lambda, a zero
//   denominator at a root or more than 6 erasures fails the row (count
//   -1, bytes unchanged).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeaderLen = 25;                 // HEADER_LEN
constexpr int kTrLen = 17;                     // TRLEN
constexpr int kHdrFecLen = 5;                  // HDRFECLEN
constexpr int kMaxFrameLength = 0x3FFF;        // MAX_FRAME_LENGTH
constexpr int kMaxFrameLengthCorrected = 0x1FFF;
constexpr int kRsN = 255;                      // RS_N, NN
constexpr int kRsK = 249;                      // RS_K, KK
constexpr int kRoots = 6;                      // NROOTS
constexpr int kFcr = 120;                      // FCR
constexpr int kGf = 255;                       // GF_SIZE
constexpr int kA0 = 255;                       // log of 0
constexpr int kMaxBlocks = 9;                  // MAX_BLOCKS
constexpr int kMaxTotalOct = 2100;             // MAX_TOTAL_OCT
constexpr int kCells = kMaxBlocks * kRsN;      // a burst's table

// The constant bytes (fec/l2_kernel.py::CONST_LAYOUT): exp over two
// periods (510, padded), log (256), the PRBS packed a payload octet
// (2 100, padded); 16-byte chunks for cp.async.
constexpr int kExpOff = 0;
constexpr int kLogOff = 512;
constexpr int kPrbsOff = 768;
constexpr int kConstBytes = 2880;
// A burst's staged symbols: the 5 609 of 2 100 octets after up to 15
// bytes of row misalignment, rounded up to a 16-byte chunk.
constexpr int kSymStage = 5632;

constexpr int kHeaderThreads = 128;            // L2H: bursts a CTA
constexpr int kFrontThreads = 256;             // the front: a row a CTA
constexpr int kFrontWin = 8192;                // the front: S + 1 at most
constexpr int kHeaderSyms = (kHeaderLen + 2) / 3;  // 9 symbols
constexpr int kSps = 10;                       // SPS
constexpr int kArity = 8;                      // ARITY
constexpr float kTwoPi = 6.28318548202514648f;       // float32(2 pi)
constexpr float kQuarterPi = 0.785398185253143311f;  // float32(pi / 4)
constexpr int kPayloadThreads = 32 * kMaxBlocks;  // L2P, L2D: a warp a row
constexpr int kRsWarps = 8;                    // RS: rows a CTA
constexpr int kPerLane = 8;                    // positions a lane

static_assert(kConstBytes % 16 == 0 && kPrbsOff % 16 == 0, "chunks");
static_assert(kPrbsOff + kMaxTotalOct <= kConstBytes, "PRBS octets fit");
static_assert((kHeaderLen + 8 * kMaxTotalOct + 2) / 3 + 15 <= kSymStage,
              "a misaligned row's symbols fit");

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) *
                          static_cast<unsigned>(b));
}

// Descrambled bit p of a burst: bit 2 - p % 3 of symbol p / 3 (MSB
// first), XOR the PRBS.
__device__ __forceinline__ int clear_bit(const uint8_t* __restrict__ row,
                                         const uint8_t* __restrict__ prbs,
                                         int p) {
  return ((row[p / 3] >> (2 - p % 3)) & 1) ^ prbs[p];
}

// get_fec_octetcount (decode.c:124-133)
__device__ __forceinline__ int fec_octetcount(int last_len) {
  return last_len < 3 ? 0 : last_len < 31 ? 2 : last_len < 68 ? 4 : 6;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The first n constant bytes into shared memory (n a multiple of 16).
__device__ __forceinline__ void stage_consts(uint8_t* dst,
                                             const uint8_t* src, int n) {
  for (int i = threadIdx.x; i < n / 16; i += blockDim.x)
    cp_async16(dst + 16 * i, src + 16 * i);
}

// ----------------------------------------------------------------- L2H
// The header and geometry of burst b of B from its first 9 symbols
// (`row`, global or shared), written at b of L2H's outputs.  Returns
// hdr_ok; *bits gets bits_consumed.
__device__ __forceinline__ bool write_header(
    const uint8_t* row, int b, int B, const int* __restrict__ synd_table,
    const int* __restrict__ synd_weight, const int* __restrict__ h_rows,
    const uint8_t* __restrict__ prbs, int* __restrict__ out,
    uint8_t* __restrict__ flags, int* bits) {
  int word = 0;
  for (int i = 0; i < kHeaderLen; ++i)
    word |= clear_bit(row, prbs, i) << (kHeaderLen - 1 - i);
  word &= (1 << (kTrLen + kHdrFecLen)) - 1;     // zero the reserved bits
  int synd = 0;
  for (int i = 0; i < kHdrFecLen; ++i)
    synd |= (__popc(word & h_rows[i]) & 1) << (kHdrFecLen - 1 - i);
  const int corrected = word ^ synd_table[synd];
  const bool reserved_bad = (corrected >> (kTrLen + kHdrFecLen)) != 0;
  const int trfield = (corrected >> kHdrFecLen) & ((1 << kTrLen) - 1);
  const int datalen = static_cast<int>(
      __brev(static_cast<unsigned>(trfield)) >> (32 - kTrLen));
  const bool too_long =
      (synd != 0 && datalen > kMaxFrameLengthCorrected) ||
      datalen > kMaxFrameLength;
  const int doct = (datalen + 7) / 8;
  const int q = doct / kRsK;
  const int r = doct - q * kRsK;
  const int fec_last = r == 0 ? 0 : fec_octetcount(r);
  const int fec_total = q * (kRsN - kRsK) + fec_last;
  const bool no_fec = fec_total == 0;
  const bool ok = !reserved_bad && !too_long && !no_fec;
  *bits = kHeaderLen + 8 * (doct + fec_total);
  // int32 results in HDR_INT order, then the flags in HDR_BOOL order
  out[b] = synd;
  out[B + b] = synd_weight[synd];
  out[2 * B + b] = datalen;
  out[3 * B + b] = doct;
  out[4 * B + b] = q + (r != 0);                          // num_blocks
  out[5 * B + b] = r == 0 ? kRsK : r;                     // last_len
  out[6 * B + b] = *bits;                                 // bits_consumed
  out[7 * B + b] = r == 0 ? kRsN - kRsK : fec_last;       // lf
  flags[b] = reserved_bad;
  flags[B + b] = too_long;
  flags[2 * B + b] = no_fec;
  flags[3 * B + b] = ok;
  return ok;
}

__global__ void __launch_bounds__(kHeaderThreads) l2_header_kernel(
    const uint8_t* __restrict__ symbols, int B, int S,
    const int* __restrict__ synd_table, const int* __restrict__ synd_weight,
    const int* __restrict__ h_rows, const uint8_t* __restrict__ prbs,
    int* __restrict__ out, uint8_t* __restrict__ flags) {
  const int b = blockIdx.x * kHeaderThreads + threadIdx.x;
  if (b >= B) return;
  int bits;
  write_header(symbols + static_cast<long long>(b) * S, b, B, synd_table,
               synd_weight, h_rows, prbs, out, flags, &bits);
}

// --------------------------------------------------------- L2P and L2D
// Bytes [0, n) of a row at any alignment into dst + (src & 15), dst
// 16-byte aligned: the aligned middle by 16-byte cp.async, the ragged
// ends by byte.  Returns the offset of byte 0 in dst.
__device__ __forceinline__ int stage_row(uint8_t* dst, const uint8_t* src,
                                         int n) {
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min((16 - lead) & 15, n);
  const int chunks = (n - head) / 16;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    cp_async16(dst + lead + head + 16 * i, src + head + 16 * i);
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    dst[lead + i] = src[i];
  for (int i = head + 16 * chunks + threadIdx.x; i < n; i += blockDim.x)
    dst[lead + i] = src[i];
  return lead;
}

// The payload octets a burst's table can read: up to its last parity
// octet where the geometry is a header's (1-9 rows, the last of 1-249
// data and 0-6 parity octets, doct their sum), else all of them.
__device__ __forceinline__ int payload_octets(int nb, int ll, int lfv,
                                              int dl) {
  const bool header_geometry = nb >= 1 && nb <= kMaxBlocks && ll >= 1 &&
      ll <= kRsK && lfv >= 0 && lfv <= kRsN - kRsK &&
      dl == kRsK * (nb - 1) + ll;
  return header_geometry
      ? min(dl + (kRsN - kRsK) * (nb - 1) + lfv, kMaxTotalOct)
      : kMaxTotalOct;
}

// Octet o of the payload, before the PRBS: descrambled bits
// kHeaderLen + 8 o + t, t = 0..7 LSB first, from 3 or 4 symbols (bits
// MSB first).  Bit p0 + t sits at bit 11 - r - t of the 12-bit window.
__device__ __forceinline__ int pack_octet(const uint8_t* sym, int o) {
  const int p0 = kHeaderLen + 8 * o;
  const int s0 = p0 / 3;
  const int r = p0 - 3 * s0;
  int w = ((sym[s0] & 7) << 9) | ((sym[s0 + 1] & 7) << 6) |
          ((sym[s0 + 2] & 7) << 3);
  if (r == 2) w |= sym[s0 + 3] & 7;
  return static_cast<int>(__brev(static_cast<unsigned>(w >> (4 - r))) >> 24);
}

// The exact GF(256) product from the log tables (exp2 spans two periods).
__device__ __forceinline__ int gmul(int a, int b,
                                    const uint8_t* __restrict__ exp2,
                                    const uint8_t* __restrict__ lg) {
  return (a == 0 || b == 0) ? 0 : exp2[lg[a] + lg[b]];
}

// RS(255,249) errors-and-erasures decode of one row in shared memory by
// one warp, fo parity octets present (fo == 0: no FEC).  Returns the
// count on every lane: 0 for no FEC or a zero syndrome, -1 for a
// failure (the row unchanged), else the roots found (the row corrected
// in place).
__device__ int rs_decode_row(uint8_t* row, int fo,
                             const uint8_t* __restrict__ exp2,
                             const uint8_t* __restrict__ lg, int lane) {
  if (fo == 0) return 0;                         // no parity: skip FEC
  int cw[kPerLane];
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int k = lane + 32 * m;
    cw[m] = k < kRsN ? row[k] : 0;
  }

  // ---- syndromes S_i = sum_k cw[k] alpha^((FCR + i)(NN - 1 - k)) ----
  int s[kRoots];
#pragma unroll
  for (int i = 0; i < kRoots; ++i) s[i] = 0;
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int k = lane + 32 * m;
    if (k < kRsN && cw[m] != 0) {
      const int lc = lg[cw[m]];
#pragma unroll
      for (int i = 0; i < kRoots; ++i)
        s[i] ^= exp2[lc + ((kFcr + i) * (kRsN - 1 - k)) % kGf];
    }
  }
  bool syn_zero = true;
#pragma unroll
  for (int i = 0; i < kRoots; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s[i] ^= __shfl_xor_sync(kFull, s[i], off);
    syn_zero = syn_zero && s[i] == 0;
  }
  if (syn_zero) return 0;

  // ---- erasure locator: prod (1 + alpha^(NN-1-pos) x), degree <= 6 --
  const int n_erase = wsub(kRoots, fo);
  int lam[kRoots + 1] = {1, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < kRoots; ++j) {
    if (j < n_erase) {
      const int pos = min(max(wadd(wadd(kRsK, fo), j), 0), kRsN - 1);
      const int au = exp2[kRsN - 1 - pos];
#pragma unroll
      for (int i = kRoots; i > 0; --i) lam[i] ^= gmul(lam[i - 1], au, exp2, lg);
    }
  }
  int b[kRoots + 1];
#pragma unroll
  for (int i = 0; i <= kRoots; ++i) b[i] = lg[lam[i]];
  int el = n_erase;

  // ---- Berlekamp-Massey, steps r > n_erase ---------------------------
#pragma unroll
  for (int r = 1; r <= kRoots; ++r) {
    int discr = 0;
#pragma unroll
    for (int i = 0; i < r; ++i) discr ^= gmul(lam[i], s[r - 1 - i], exp2, lg);
    const int dlog = lg[discr];
    const bool update = wmul(2, el) <= wadd(wadd(r, n_erase), -1);
    if (r > n_erase && discr != 0) {
      int t[kRoots + 1];
      t[0] = lam[0];
#pragma unroll
      for (int i = 1; i <= kRoots; ++i)
        t[i] = lam[i] ^ (b[i - 1] != kA0 ? exp2[dlog + b[i - 1]] : 0);
      if (update) {
        el = wsub(wadd(r, n_erase), el);
#pragma unroll
        for (int i = 0; i <= kRoots; ++i)
          b[i] = lam[i] == 0 ? kA0 : (lg[lam[i]] - dlog + kGf) % kGf;
      } else {
#pragma unroll
        for (int i = kRoots; i > 0; --i) b[i] = b[i - 1];
        b[0] = kA0;
      }
#pragma unroll
      for (int i = 0; i <= kRoots; ++i) lam[i] = t[i];
    } else if (r > n_erase) {
#pragma unroll
      for (int i = kRoots; i > 0; --i) b[i] = b[i - 1];
      b[0] = kA0;
    }
  }
  int deg = 0;
  int loglam[kRoots + 1];
#pragma unroll
  for (int i = 0; i <= kRoots; ++i) {
    loglam[i] = lg[lam[i]];
    if (lam[i] != 0) deg = i;
  }

  // ---- omega = S(x) lambda(x) mod x^6, cut at deg_lambda - 1 ---------
  int logom[kRoots];
#pragma unroll
  for (int oi = 0; oi < kRoots; ++oi) {
    int acc = 0;
#pragma unroll
    for (int j = 0; j <= oi; ++j) acc ^= gmul(s[oi - j], lam[j], exp2, lg);
    logom[oi] = lg[oi <= deg - 1 ? acc : 0];
  }
  const int lim = min(deg, kRoots - 1) & ~1;

  // ---- Chien search and Forney at this lane's positions --------------
  int mag[kPerLane];
  int roots = 0;
  bool den_zero = false;
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int k = lane + 32 * m;
    const int i = k + 1;                         // location k <-> alpha^i
    mag[m] = 0;
    if (k >= kRsN) continue;
    int q = 0;
#pragma unroll
    for (int j = 0; j <= kRoots; ++j)
      if (loglam[j] != kA0) q ^= exp2[loglam[j] + (j * i) % kGf];
    if (q != 0) continue;
    ++roots;
    int num1 = 0;
#pragma unroll
    for (int j = 0; j < kRoots; ++j)
      if (logom[j] != kA0) num1 ^= exp2[logom[j] + (j * i) % kGf];
    int den = 0;
#pragma unroll
    for (int e = 0; e < kRoots; e += 2)
      if (e <= lim && loglam[e + 1] != kA0)
        den ^= exp2[loglam[e + 1] + (e * i) % kGf];
    if (den == 0) {
      den_zero = true;
    } else if (num1 != 0) {
      // num1 * num2 / den, num2 = alpha^(i (FCR - 1))
      const int num2_log = (i * (kFcr - 1)) % kGf;
      mag[m] = exp2[(lg[num1] + num2_log + kGf - lg[den]) % kGf];
    }
  }
  const int root_count = __reduce_add_sync(kFull, roots);
  const bool fail = root_count != deg || __any_sync(kFull, den_zero) ||
                    n_erase > kRoots;
  if (fail) return -1;
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int k = lane + 32 * m;
    if (k < kRsN && mag[m] != 0) row[k] = static_cast<uint8_t>(cw[m] ^ mag[m]);
  }
  return root_count;
}

// One burst's table (and with kDecode its RS decode), a CTA of
// kPayloadThreads; see L2P above.
template <bool kDecode>
__device__ __forceinline__ void payload_body(
    const uint8_t* __restrict__ symbols, int S, long long src_row,
    const uint8_t* __restrict__ hdr_ok,
    const int* __restrict__ num_blocks, const int* __restrict__ last_len,
    const int* __restrict__ lf, const int* __restrict__ doct,
    const uint8_t* __restrict__ consts, uint8_t* __restrict__ tab,
    int* __restrict__ count, int* __restrict__ fec_row) {
  __shared__ __align__(16) uint8_t sym_s[kSymStage];
  __shared__ __align__(16) uint8_t const_s[kConstBytes];
  __shared__ uint8_t oct_s[kMaxTotalOct];
  __shared__ uint8_t tab_s[kCells];
  const int bp = blockIdx.x;
  // the five loads at once; rejected bursts carry geometry 0
  const bool ok = hdr_ok[src_row] != 0;
  const int nb_in = num_blocks[src_row];
  const int ll_in = last_len[src_row];
  const int lf_in = lf[src_row];
  const int dl_in = doct[src_row];
  const int nb = ok ? nb_in : 0;
  const int ll = ok ? ll_in : 0;
  const int lfv = ok ? lf_in : 0;
  const int dl = ok ? dl_in : 0;
  const int nbm1 = wadd(nb, -1);
  uint8_t* out = tab + static_cast<long long>(bp) * kCells;
  const int warp = threadIdx.x >> 5;             // this warp's RS row
  const int lane = threadIdx.x & 31;
  const int fo = warp < nbm1 ? kRsN - kRsK : warp == nbm1 ? lfv : 0;
  if (lane == 0) fec_row[bp * kMaxBlocks + warp] = fo;
  if (nb <= 0) {                      // no table row: every cell a pad
    for (int c = threadIdx.x; c < kCells; c += kPayloadThreads) out[c] = 0;
    if (kDecode && lane == 0) count[bp * kMaxBlocks + warp] = 0;
    return;
  }

  // ---- stage the symbols and the constant bytes, one wait ----------
  const int n_oct = payload_octets(nb, ll, lfv, dl);
  const int lead = stage_row(sym_s, symbols + src_row * S,
                             (kHeaderLen + 8 * n_oct + 2) / 3);
  stage_consts(const_s, consts, kConstBytes);
  cp_async_wait_all();
  __syncthreads();

  // ---- pack the octets ---------------------------------------------
  for (int o = threadIdx.x; o < n_oct; o += kPayloadThreads)
    oct_s[o] = static_cast<uint8_t>(pack_octet(sym_s + lead, o) ^
                                    const_s[kPrbsOff + o]);
  __syncthreads();

  // ---- deinterleave ------------------------------------------------
  // cell (r, c) takes transmission index c (nb - 1) + min(c, ll) + r
  // (data columns) or doct + cf (nb - 1) + min(cf, lf) + r (parity)
  for (int cell = threadIdx.x; cell < kCells; cell += kPayloadThreads) {
    const int r = cell / kRsN;
    const int c = cell - r * kRsN;
    const bool is_data = c < kRsK;
    const int cf = c - kRsK;
    const int src = is_data
        ? wadd(wadd(wmul(c, nbm1), min(c, ll)), r)
        : wadd(wadd(wadd(dl, wmul(cf, nbm1)), min(cf, lfv)), r);
    const int cpr = is_data ? (r < nbm1 ? kRsK : ll)
                            : (r < nbm1 ? kRsN - kRsK : lfv);
    const bool valid = r < nb && (is_data ? c : cf) < cpr;
    tab_s[cell] = valid ? oct_s[min(max(src, 0), kMaxTotalOct - 1)] : 0;
  }
  __syncthreads();

  // ---- decode row `warp` in place -----------------------------------
  if (kDecode) {
    const int cnt = rs_decode_row(tab_s + warp * kRsN, fo,
                                  const_s + kExpOff, const_s + kLogOff,
                                  lane);
    if (lane == 0) count[bp * kMaxBlocks + warp] = cnt;
    __syncthreads();
  }
  for (int c = threadIdx.x; c < kCells; c += kPayloadThreads)
    out[c] = tab_s[c];
}

// Exclusive scan of v over a CTA of kW warps; *total gets the sum.
// Every thread of the CTA must call it.
template <int kW>
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
    int w = lane < kW ? warp_buf[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kW) warp_buf[lane] = w;           // inclusive warp totals
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_buf[warp - 1];
  *total = warp_buf[kW - 1];
  __syncthreads();                               // warp_buf free again
  return before + x - v;
}

// L2P's compaction prologue: the row of the hdr-ok compaction (the
// stable order of fec/l2.py, accepted rows first, each part in index
// order) at position bp of Bp, found by a block scan of hdr_ok over the
// B rows.  The CTA also writes blocks_row (row -> position, -1 past Bp)
// for the rows i == bp (mod Bp), so the CTAs together write all of it.
__device__ long long compact_row(const uint8_t* __restrict__ hdr_ok, int B,
                                 int Bp, int bp,
                                 int* __restrict__ blocks_row) {
  constexpr int kW = kPayloadThreads / 32;
  __shared__ int warp_buf[kW];
  __shared__ int row_s;
  int n = 0;
  for (int i = threadIdx.x; i < B; i += kPayloadThreads) n += hdr_ok[i] != 0;
  int n_ok;
  block_excl_scan<kW>(n, warp_buf, &n_ok);
  int ok_before = 0;                             // accepted rows before chunk
  for (int i0 = 0; i0 < B; i0 += kPayloadThreads) {
    const int i = i0 + threadIdx.x;
    const bool ok = i < B && hdr_ok[i] != 0;
    int chunk_ok;
    const int okb = ok_before +
        block_excl_scan<kW>(ok ? 1 : 0, warp_buf, &chunk_ok);
    if (i < B) {
      const int pos = ok ? okb : n_ok + (i - okb);
      if (pos == bp) row_s = i;
      if (i % Bp == bp) blocks_row[i] = pos < Bp ? pos : -1;
    }
    ok_before += chunk_ok;
  }
  __syncthreads();
  return row_s;
}

// L2P: with blocks_row set the CTA finds its row (compact_row), else it
// takes row bp.
__global__ void __launch_bounds__(kPayloadThreads) l2_payload_kernel(
    const uint8_t* __restrict__ symbols, int S, int B,
    const uint8_t* __restrict__ hdr_ok,
    const int* __restrict__ num_blocks, const int* __restrict__ last_len,
    const int* __restrict__ lf, const int* __restrict__ doct,
    const uint8_t* __restrict__ consts, uint8_t* __restrict__ tab,
    int* __restrict__ count, int* __restrict__ fec_row,
    int* __restrict__ blocks_row) {
  const int bp = blockIdx.x;
  const long long src_row =
      blocks_row != nullptr ? compact_row(hdr_ok, B, gridDim.x, bp,
                                          blocks_row)
                            : bp;
  payload_body<true>(symbols, S, src_row, hdr_ok, num_blocks, last_len, lf,
                     doct, consts, tab, count, fec_row);
}

__global__ void __launch_bounds__(kPayloadThreads) l2_deinterleave_kernel(
    const uint8_t* __restrict__ symbols, int S,
    const long long* __restrict__ sel, const uint8_t* __restrict__ hdr_ok,
    const int* __restrict__ num_blocks, const int* __restrict__ last_len,
    const int* __restrict__ lf, const int* __restrict__ doct,
    const uint8_t* __restrict__ consts, uint8_t* __restrict__ tab,
    int* __restrict__ fec_row) {
  const int bp = blockIdx.x;
  payload_body<false>(symbols, S, sel != nullptr ? sel[bp] : bp, hdr_ok,
                      num_blocks, last_len, lf, doct, consts, tab, nullptr,
                      fec_row);
}

// ------------------------------------------------------------ L2 front
// One CTA a compacted row r < cap; see l2_front above.
__global__ void __launch_bounds__(kFrontThreads) l2_front_kernel(
    const float* __restrict__ phases, const float* __restrict__ pwr, int C,
    int M, const int* __restrict__ count, const int* __restrict__ sync_idx,
    const float* __restrict__ dphi, int K, int S, int compact,
    const uint8_t* __restrict__ gray, const int* __restrict__ synd_table,
    const int* __restrict__ synd_weight, const int* __restrict__ h_rows,
    const uint8_t* __restrict__ prbs, long long* __restrict__ take,
    int* __restrict__ inv, uint8_t* __restrict__ symbols,
    int* __restrict__ hdr_out, uint8_t* __restrict__ flags,
    float* __restrict__ frame_pwr) {
  constexpr int kW = kFrontThreads / 32;
  __shared__ float ph_s[kFrontWin];
  __shared__ uint8_t sym9_s[kHeaderSyms];
  __shared__ int warp_buf[kW];
  __shared__ double sum_s[kW];
  __shared__ int slot_s, bits_s, ok_s;
  const int r = blockIdx.x;
  const int cap = gridDim.x;
  const int t = threadIdx.x;

  // ---- 1. the slot at position r of the compaction ------------------
  if (!compact) {
    if (t == 0) slot_s = r;
  } else {
    int n = 0;
    for (int c = t; c < C; c += kFrontThreads)
      n += min(max(count[c], 0), K);
    int nv;                                      // valid slots in all
    block_excl_scan<kW>(n, warp_buf, &nv);
    int v_before = 0;                            // valid slots before chunk
    for (int c0 = 0; c0 < C; c0 += kFrontThreads) {
      const int c = c0 + t;
      const int vc = c < C ? min(max(count[c], 0), K) : 0;
      int chunk;
      const int pv = v_before + block_excl_scan<kW>(vc, warp_buf, &chunk);
      if (c < C) {
        const int pi = c * K - pv;               // invalid slots before c
        if (r < nv ? (r >= pv && r < pv + vc)
                   : (r - nv >= pi && r - nv < pi + K - vc))
          slot_s = c * K + (r < nv ? r - pv : vc + (r - nv - pi));
        if (c % cap == r) {                      // this CTA's inv entries
          for (int k = 0; k < K; ++k) {
            const int p = k < vc ? pv + k : nv + pi + (k - vc);
            inv[c * K + k] = p < cap ? p : -1;
          }
        }
      }
      v_before += chunk;
    }
  }
  __syncthreads();
  const int slot = slot_s;
  if (t == 0) take[r] = slot;

  // ---- 2. the window at the symbol clock, zero past M ---------------
  const int c = slot / K;
  const long long start =
      min(max(static_cast<long long>(sync_idx[slot]), 0ll),
          static_cast<long long>(M));
  const float dp0 = dphi[slot];
  const float* ph_row = phases + static_cast<long long>(c) * M;
  for (int j = t; j <= S; j += kFrontThreads) {
    const long long idx = start + static_cast<long long>(kSps) * j;
    ph_s[j] = idx < M ? ph_row[idx] : 0.0f;
  }
  __syncthreads();

  // ---- 3. D8PSK decisions --------------------------------------------
  uint8_t* sym_row = symbols + static_cast<long long>(r) * S;
  for (int s = t; s < S; s += kFrontThreads) {
    float d = (ph_s[s + 1] - ph_s[s]) - dp0;
    if (d < 0.0f) d = d + kTwoPi;
    if (d > kTwoPi) d = d - kTwoPi;
    const long long q =
        static_cast<long long>(rintf(__fdiv_rn(d, kQuarterPi)));
    const int m = static_cast<int>(((q % kArity) + kArity) % kArity);
    const uint8_t g = gray[m];
    sym_row[s] = g;
    if (s < kHeaderSyms) sym9_s[s] = g;
  }
  __syncthreads();

  // ---- 4. the header -----------------------------------------------
  if (t == 0) {
    int bits;
    ok_s = write_header(sym9_s, r, cap, synd_table, synd_weight, h_rows,
                        prbs, hdr_out, flags, &bits);
    bits_s = bits;
  }
  __syncthreads();

  // ---- 5. frame power: mean over the burst's symbols ------------------
  if (!ok_s) {
    if (t == 0) frame_pwr[r] = 0.0f;
    return;
  }
  const int total = max((bits_s + 2) / 3, 1);
  const int n_sum = min(total, S);
  const float* pw_row = pwr + static_cast<long long>(c) * M;
  double acc = 0.0;
  for (int s = t; s < n_sum; s += kFrontThreads) {
    const long long idx = start + static_cast<long long>(kSps) * (s + 1);
    acc += idx < M ? pw_row[idx] : 0.0f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if ((t & 31) == 0) sum_s[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    double sum = 0.0;
    for (int w = 0; w < kW; ++w) sum += sum_s[w];
    frame_pwr[r] = __fdiv_rn(static_cast<float>(sum),
                             static_cast<float>(total));
  }
}

// ------------------------------------------------------------------ RS
__global__ void __launch_bounds__(32 * kRsWarps) rs_verify_kernel(
    const uint8_t* __restrict__ blocks, const int* __restrict__ fec_octets,
    int N, const uint8_t* __restrict__ consts, uint8_t* __restrict__ out,
    int* __restrict__ count) {
  __shared__ __align__(16) uint8_t gf_s[kPrbsOff];   // exp, then log
  __shared__ uint8_t rows_s[kRsWarps][kRsN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rowi = blockIdx.x * kRsWarps + warp;
  uint8_t* row = rows_s[warp];
  stage_consts(gf_s, consts, kPrbsOff);
  if (rowi < N) {
    const uint8_t* in = blocks + static_cast<long long>(rowi) * kRsN;
    for (int k = lane; k < kRsN; k += 32) row[k] = in[k];
  }
  cp_async_wait_all();
  __syncthreads();
  if (rowi >= N) return;                         // a whole warp
  const int cnt = rs_decode_row(row, fec_octets[rowi], gf_s + kExpOff,
                                gf_s + kLogOff, lane);
  __syncwarp();
  uint8_t* o = out + static_cast<long long>(rowi) * kRsN;
  for (int k = lane; k < kRsN; k += 32) o[k] = row[k];
  if (lane == 0) count[rowi] = cnt;
}

}  // namespace

// C entry points, loaded with ctypes by dumpvdl2_tpu_torch/fec/l2_kernel.py:
// each launches on `stream`, allocates nothing, and returns a CUDA error
// code (0 = launched).
extern "C" int l2_header_launch(const uint8_t* symbols, int B, int S,
                                const int* synd_table,
                                const int* synd_weight, const int* h_rows,
                                const uint8_t* prbs, int* out,
                                uint8_t* flags, void* stream) {
  if (B <= 0) return 0;
  l2_header_kernel<<<(B + kHeaderThreads - 1) / kHeaderThreads,
                     kHeaderThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      symbols, B, S, synd_table, synd_weight, h_rows, prbs, out, flags);
  return static_cast<int>(cudaGetLastError());
}

// blocks_row (the compaction of B rows to Bp) may be null: then Bp == B.
extern "C" int l2_payload_launch(
    const uint8_t* symbols, int S, int B, int Bp,
    const uint8_t* hdr_ok, const int* num_blocks, const int* last_len,
    const int* lf, const int* doct, const uint8_t* consts, uint8_t* tab,
    int* count, int* fec_row, int* blocks_row, void* stream) {
  if (Bp <= 0) return 0;
  l2_payload_kernel<<<Bp, kPayloadThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      symbols, S, B, hdr_ok, num_blocks, last_len, lf, doct, consts, tab,
      count, fec_row, blocks_row);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int l2_deinterleave_launch(
    const uint8_t* symbols, int S, const long long* sel, int Bp,
    const uint8_t* hdr_ok, const int* num_blocks, const int* last_len,
    const int* lf, const int* doct, const uint8_t* consts, uint8_t* tab,
    int* fec_row, void* stream) {
  if (Bp <= 0) return 0;
  l2_deinterleave_kernel<<<Bp, kPayloadThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      symbols, S, sel, hdr_ok, num_blocks, last_len, lf, doct, consts, tab,
      fec_row);
  return static_cast<int>(cudaGetLastError());
}

// compact = 0: row r takes slot r (cap = C K, inv not written).
extern "C" int l2_front_launch(
    const float* phases, const float* pwr, int C, int M, const int* count,
    const int* sync_idx, const float* dphi, int K, int S, int cap,
    int compact, const uint8_t* gray, const int* synd_table,
    const int* synd_weight, const int* h_rows, const uint8_t* prbs,
    long long* take, int* inv, uint8_t* symbols, int* hdr_out,
    uint8_t* flags, float* frame_pwr, void* stream) {
  if (cap <= 0) return 0;
  l2_front_kernel<<<cap, kFrontThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      phases, pwr, C, M, count, sync_idx, dphi, K, S, compact, gray,
      synd_table, synd_weight, h_rows, prbs, take, inv, symbols, hdr_out,
      flags, frame_pwr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rs_verify_launch(const uint8_t* blocks, const int* fec_octets,
                                int N, const uint8_t* consts, uint8_t* out,
                                int* count, void* stream) {
  if (N <= 0) return 0;
  rs_verify_kernel<<<(N + kRsWarps - 1) / kRsWarps, 32 * kRsWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      blocks, fec_octets, N, consts, out, count);
  return static_cast<int>(cudaGetLastError());
}
