// Gate kernels G1 (gate) and G2 (nf_floor) for Hopper (sm_90a).
//
// These replace two XLA stages of the JAX package's device gate,
// dumpvdl2_tpu/core/nf_gate.py, not TPU kernels: each is a lax.scan
// whose steps are sequential per channel and independent across
// channels.  PyTorch has no one-launch form of a scan, and the plain
// versions (dumpvdl2_tpu_torch/core/gate_kernel.py: gate_plain,
// nf_floor_plain) issue about 50 small launches per slot, thousands a
// block, on the host thread that already paces the pipeline.  So each
// kernel gives one thread to one channel and walks the chain there.
//
// G1 gate: nf_gate._gate (nf_gate.py:133) = _slot_inputs (row gathers
//   of hdr_ok and bits_consumed, the float32 ppm) + gate_scan
//   (gate_scan.py:89-163) over the K candidate slots of each channel.
//   Every output is an integer and equals the plain version exactly.
//   The ppm uses the plain version's float32 constant, one IEEE
//   multiply and one IEEE divide (__fmul_rn, __fdiv_rn; the file builds
//   with --fmad=false), so |ppm| > max_ppm sees the same value.  Index
//   arithmetic wraps in 32 bits as JAX's int32 does.
// G2 nf_floor: the per-1000-column noise-floor recurrence and the
//   per-candidate readings of nf_gate._nf_track (nf_gate.py:264-286).
//   The update is (a * nf + b * min(y, nf)) + eps with the plain
//   version's float32 constants, in its order, each op rounded, so the
//   floor matches bit for bit.  A candidate reads the floor after the
//   valid crossings whose column is below its bound, counted over all
//   crossings as the plain version counts them.
//
// Bound: both kernels move well under a megabyte at the wideband shape
// (C = 256 channels, K = 64 slots, 51 crossings) and do a few dozen
// operations per slot, so the card's bound is under a microsecond.
// What they take is the serial chain: K (G1) or cap + K * cap (G2)
// dependent steps in one thread, with C threads on a couple of SMs.
// A right, simple kernel comes first; chip_smoke.py times both.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSps = 10;           // decimated samples per symbol
constexpr int kMinHdrSyms = 10;    // (HEADER_LEN + 2) // 3 + 1
// float32(SYMBOL_RATE * 1e6 / (2 pi)): ppm = kPpmScale * dphi / freq
constexpr float kPpmScale = 0x1.8e6d7ep+30f;
constexpr float kNfA = 0x1.b33334p-1f;     // float32(NF_LP), 0.85
constexpr float kNfB = 0x1.333334p-3f;     // float32(1 - NF_LP)
constexpr float kNfEps = 0x1.a36e2ep-14f;  // float32(1e-4)

// verdict codes (core/gate_scan.py)
constexpr int8_t kEmpty = 0, kSkip = 1, kL2Overflow = 2, kDefer = 3,
                 kEofShort = 4, kHdrReject = 5, kEofTrunc = 6,
                 kPpmReject = 7, kAccept = 8, kUnprocessed = 9,
                 kDeferData = 10;

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

__global__ void __launch_bounds__(kThreads) gate_kernel(
    const int* __restrict__ count, const int* __restrict__ det,
    const int* __restrict__ sync, const int* __restrict__ sym_valid,
    const int* __restrict__ l2_row, const float* __restrict__ dphi,
    const uint8_t* __restrict__ hdr_rows,
    const int* __restrict__ bits_rows, int B,
    const int* __restrict__ busy0, const int* __restrict__ next0,
    const float* __restrict__ freqs, float max_ppm, int eof, int C, int K,
    int8_t* __restrict__ verdicts, int* __restrict__ busy1,
    int* __restrict__ next1, int* __restrict__ deferred_at,
    int* __restrict__ bits_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  int busy = busy0[c];
  int nxt = next0[c];
  int deferred = -1;
  bool stopped = false;
  const int cnt = count[c];
  const float freq = freqs[c];
  const bool gate_on = max_ppm > 0.0f;
  const long long row0 = static_cast<long long>(c) * K;
  for (int k = 0; k < K; ++k) {
    const long long i = row0 + k;
    const int row = l2_row[i];
    const bool has_row = row >= 0;
    const int safe = min(max(row, 0), B - 1);
    const bool hdr_ok = has_row && hdr_rows[safe] != 0;
    const int bits = has_row ? bits_rows[safe] : 0;
    bits_out[i] = bits;
    const int det_g = det[i];
    const int sp_g = sync[i];
    const int nsyms = sym_valid[i];
    int8_t v;
    bool deferring = false;
    if (k >= cnt) {
      v = kEmpty;
    } else if (stopped) {
      v = kUnprocessed;
    } else if (det_g < nxt || det_g < busy) {
      v = kSkip;
    } else if (!has_row) {
      v = kL2Overflow;
      nxt = wadd(det_g, 1);
    } else if (nsyms < kMinHdrSyms) {
      if (eof) {
        v = kEofShort;
        nxt = wadd(det_g, 1);
      } else {
        v = kDefer;
        deferring = true;
      }
    } else if (!hdr_ok) {
      v = kHdrReject;
      busy = wadd(sp_g, 9 * kSps);
      nxt = wadd(det_g, 1);
    } else {
      const int total = ceil_syms(bits);
      const float ppm = __fdiv_rn(__fmul_rn(kPpmScale, dphi[i]), freq);
      if (nsyms < total) {
        if (eof) {
          v = kEofTrunc;
          nxt = wadd(det_g, 1);
        } else {
          v = kDeferData;
          deferring = true;
        }
      } else if (gate_on && fabsf(ppm) > max_ppm) {
        v = kPpmReject;
        nxt = wadd(det_g, 1);
      } else {
        v = kAccept;
        busy = wadd(sp_g, wmul(total, kSps));
        nxt = wadd(det_g, 1);
      }
    }
    if (deferring) {
      nxt = det_g;
      if (deferred < 0) deferred = det_g;
      stopped = true;
    }
    verdicts[i] = v;
  }
  busy1[c] = busy;
  next1[c] = nxt;
  deferred_at[c] = deferred;
}

__global__ void __launch_bounds__(kThreads) nf_floor_kernel(
    const float* __restrict__ y_cross, const uint8_t* __restrict__ valid,
    const int* __restrict__ jc, int cap, const int* __restrict__ bound,
    int K, const float* __restrict__ mag_nf0, int C,
    float* __restrict__ mag_nf1, float* __restrict__ nf_seq,
    float* __restrict__ nf_read) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const long long j0 = static_cast<long long>(c) * cap;
  const float nf0 = mag_nf0[c];
  float nf = nf0;
  for (int j = 0; j < cap; ++j) {
    if (valid[j0 + j]) {
      const float y = y_cross[j0 + j];
      // torch.minimum: NaN if either is NaN
      const float m = (y < nf || y != y) ? y : nf;
      nf = __fadd_rn(__fadd_rn(__fmul_rn(kNfA, nf), __fmul_rn(kNfB, m)),
                     kNfEps);
    }
    nf_seq[j0 + j] = nf;
  }
  mag_nf1[c] = nf;
  const long long k0 = static_cast<long long>(c) * K;
  for (int k = 0; k < K; ++k) {
    const int bnd = bound[k0 + k];
    int r = 0;
    for (int j = 0; j < cap; ++j)
      r += (valid[j0 + j] != 0 && jc[j0 + j] < bnd) ? 1 : 0;
    nf_read[k0 + k] = r > 0 ? nf_seq[j0 + r - 1] : nf0;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a
// contiguous device buffer of the shape named in core/gate_kernel.py;
// each launches on `stream`, allocates nothing, and returns
// cudaGetLastError().
extern "C" int gate_launch(const int* count, const int* det,
                           const int* sync, const int* sym_valid,
                           const int* l2_row, const float* dphi,
                           const uint8_t* hdr_rows, const int* bits_rows,
                           int B, const int* busy0, const int* next0,
                           const float* freqs, float max_ppm, int eof,
                           int C, int K, int8_t* verdicts, int* busy1,
                           int* next1, int* deferred_at, int* bits,
                           void* stream) {
  if (C <= 0) return 0;
  const int blocks = (C + kThreads - 1) / kThreads;
  gate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      count, det, sync, sym_valid, l2_row, dphi, hdr_rows, bits_rows, B,
      busy0, next0, freqs, max_ppm, eof, C, K, verdicts, busy1, next1,
      deferred_at, bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_floor_launch(const float* y_cross, const uint8_t* valid,
                               const int* jc, int cap, const int* bound,
                               int K, const float* mag_nf0, int C,
                               float* mag_nf1, float* nf_seq,
                               float* nf_read, void* stream) {
  if (C <= 0) return 0;
  const int blocks = (C + kThreads - 1) / kThreads;
  nf_floor_kernel<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      y_cross, valid, jc, cap, bound, K, mag_nf0, C, mag_nf1, nf_seq,
      nf_read);
  return static_cast<int>(cudaGetLastError());
}
