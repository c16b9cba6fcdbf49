// Shared pieces of the two seeding kernels: the rolling canonical ntHash of a
// thread's run of consecutive windows, the skewed shared-memory layout its
// codes are read from, and the cp.async helpers of the tile ring.
//
// Rolling ntHash. For a window of l codes starting at t,
//   fwd[t] = XOR_{i<l} rol(S[c[t+i]], l-1-i),   rev[t] = XOR_{i<l} rol(R[c[t+i]], i)
// with S = SEED32, R = SEED32C and 32-bit rotations. Keep the pre-states over
// the window's first l-1 codes,
//   P[t] = XOR_{i<l-1} rol(S[c[t+i]], l-2-i),    Q[t] = XOR_{i<l-1} rol(R[c[t+i]], i);
// then, with in = c[t+l-1] and out = c[t],
//   fwd[t] = rol(P[t], 1) ^ S[in]               rev[t] = Q[t] ^ rol(R[in], l-1)
//   P[t+1] = fwd[t] ^ rol(S[out], l-1)          Q[t+1] = ror(rev[t] ^ R[out], 1)
// which is fwd[t+1] = rol(fwd[t], 1) ^ rol(S[c[t]], l) ^ S[c[t+l]] and
// rev[t+1] = ror(rev[t] ^ R[c[t]], 1) ^ rol(R[c[t+l]], l-1) split at the
// point where the window holds l-1 codes. It holds for every 4 <= l <= 32
// (a rotation by 32 is the identity). A run of kRun windows costs l-1
// warm-up steps (P and Q from zero) and then one step per window.
//
// Codes are looked up by their low two bits, so a code >= 4 (INVALID) is
// hashed with a valid code's seeds. Its contribution enters and leaves the
// state with the same value, so only windows that hold it get other values
// than the plain version's, and those windows are invalid: neither kernel
// outputs a hash there (nthash_sel's contract leaves canon free at invalid
// windows). Validity is tracked as the run-local index of the last code >= 4
// seen: window m is invalid iff that index is >= m.
//
// The lookups are selects over tables held in registers (no indexed memory).
// Tensor cores do not apply: rotate-and-XOR over 32-bit words has no
// matrix-product form worth using.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mq {

// Seeds of codes 0..3 (the INVALID code's are never read, see above).
struct Seeds {
  uint32_t f[4];  // SEED32
  uint32_t r[4];  // SEED32C
};

__device__ __forceinline__ uint32_t rol32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);  // shift amount taken mod 32
}

__device__ __forceinline__ uint32_t ror32(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

// Per low-two-bit code value: S, rol(S, l-1), rol(R, l-1), R.
struct RollTables {
  uint32_t s_in[4];
  uint32_t s_out[4];
  uint32_t r_in[4];
  uint32_t r_out[4];
};

__device__ __forceinline__ RollTables make_tables(const Seeds& seeds, int l) {
  RollTables tb;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    tb.s_in[c] = seeds.f[c];
    tb.s_out[c] = rol32(seeds.f[c], l - 1);
    tb.r_in[c] = rol32(seeds.r[c], l - 1);
    tb.r_out[c] = seeds.r[c];
  }
  return tb;
}

// t[code] for the code in byte `sh / 8` of w, by its low two bits.
__device__ __forceinline__ uint32_t pick(const uint32_t (&t)[4], uint32_t w, int sh) {
  const bool b0 = (w >> sh) & 1u;
  const bool b1 = (w >> sh) & 2u;
  const uint32_t lo = b0 ? t[1] : t[0];
  const uint32_t hi = b0 ? t[3] : t[2];
  return b1 ? hi : lo;
}

// Whether the code in byte `sh / 8` of w is >= 4 (INVALID or above).
__device__ __forceinline__ bool is_bad(uint32_t w, int sh) {
  return (w & (0xFCu << sh)) != 0;
}

// Skewed layout of a byte stream in shared memory for runs of kRun codes:
// 32-bit word w lives at word w + w / (kRun / 4). A thread whose run starts at
// word k * kRun / 4 reads its j-th word at k * (kRun / 4 + 1) + j', and
// kRun / 4 + 1 (5 or 9) is odd, so a warp's 32 reads at one j hit 32 banks,
// where the plain layout would put 4 or 8 threads on each bank.
template <int kRun>
__device__ __forceinline__ int skew_word(int w) { return w + w / (kRun / 4); }
template <int kRun>
__device__ __forceinline__ int skew_byte(int i) { return i + (i / kRun) * 4; }
template <int kRun>
constexpr int skewed_words(int words) { return words + words / (kRun / 4); }

// Rolls one run of kRun windows over the codes at bytes [4 * w0, ...) of a
// skewed stream: it reads codes 4 * w0 .. 4 * w0 + kRun + l + 2. For each
// window m = 0 .. kRun-1 (starting at code 4 * w0 + m) it calls
// emit(m, canon, invalid) with canon = min(fwd, rev) (unsigned).
template <int kRun, class Emit>
__device__ __forceinline__ void roll_run(const uint32_t* words, int w0, int l,
                                         const RollTables& tb, Emit&& emit) {
  static_assert(kRun % 4 == 0, "a run is whole words");
  uint32_t p = 0, q = 0;
  int lastbad = -1;
  // warm-up: P and Q over codes 0 .. l-2 of the run
  for (int i = 0; i < l - 1; i += 4) {
    const uint32_t w = words[skew_word<kRun>(w0 + (i >> 2))];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (i + b < l - 1) {
        const int sh = 8 * b;
        p = rol32(p, 1) ^ pick(tb.s_in, w, sh);
        q ^= rol32(pick(tb.r_out, w, sh), i + b);
        if (is_bad(w, sh)) lastbad = i + b;
      }
    }
  }
  // main loop: out-codes m (aligned words), in-codes m + l - 1 (funnel-shifted)
  const int q0 = (l - 1) >> 2;
  const int sh0 = ((l - 1) & 3) * 8;
  uint32_t lo = words[skew_word<kRun>(w0 + q0)];
#pragma unroll
  for (int g = 0; g < kRun / 4; ++g) {
    const uint32_t ow = words[skew_word<kRun>(w0 + g)];
    const uint32_t hi = words[skew_word<kRun>(w0 + q0 + g + 1)];
    const uint32_t iw = __funnelshift_r(lo, hi, sh0);
    lo = hi;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int m = 4 * g + b;
      const int sh = 8 * b;
      const uint32_t fwd = rol32(p, 1) ^ pick(tb.s_in, iw, sh);
      const uint32_t rev = q ^ pick(tb.r_in, iw, sh);
      if (is_bad(iw, sh)) lastbad = m + l - 1;
      emit(m, fwd < rev ? fwd : rev, lastbad >= m);
      p = fwd ^ pick(tb.s_out, ow, sh);
      q = ror32(rev ^ pick(tb.r_out, ow, sh), 1);
    }
  }
}

// --- cp.async ring ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, global -> shared, bypassing L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 4 bytes, global -> shared; bytes past `src_bytes` (0..4) are zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Persistent grid: as many CTAs as fit on the card at once, at most one per
// tile. Returns 0 and sets *grid, or a cudaError_t.
template <class Kernel>
inline int persistent_grid(Kernel kernel, int threads, int tiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return (int)err;
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  *grid = tiles < fit ? tiles : fit;
  return 0;
}

}  // namespace mq
