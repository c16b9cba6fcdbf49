// nthash_sel: canonical 32-bit ntHash of every l-mer of HPC codes, plus the
// density-selected position key.
//
// Replaces the Pallas pair _kernel_fwd (mapquik_tpu/ops/pallas_seeding.py:83-110)
// and _kernel_rev (:113-128), reached through nthash_sel_pallas (:141-175),
// together with that wrapper's combine. The fwd/rev split worked around a
// TPU compiler fault; here one kernel does both strands and the combine. The
// plain PyTorch version is mapquik_tpu_torch/ops/cuda_seeding.py:nthash_sel_plain.
//
// Contract (held against the Pallas kernels): selkey[t] = t where the window
// [t, t + l) holds no INVALID code, t <= L - l and canon[t] < threshold
// (unsigned), else 0x7FFFFFFF; canon[t] = min(fwd[t], rev[t]) with
//   fwd[t] = XOR_{i<l} rol(SEED32[c[t+i]], l-1-i),
//   rev[t] = XOR_{i<l} rol(SEED32C[c[t+i]], i)
// (the prefix-XOR identity the TPU kernels scan for), codes past L reading as
// INVALID (seed 0). So no scan and no carry between blocks is needed: each
// thread hashes its windows directly from a shared-memory tile.
//
// Design. One CTA of 256 threads per (row, 1024-position tile); the tile plus
// a 32-byte lookahead is staged in shared memory and each thread hashes 4
// positions (l <= 32 steps each).
//
// Bound on the card: bytes. It reads B * L bytes and writes 2 * B * L * 4
// bytes; at B = 256, L = 65536 that is 151 MB, 45 us at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int kLook = 32;
constexpr int kThreads = 256;
constexpr int kInvalid = 4;
constexpr int32_t kBig = 0x7FFFFFFF;

struct Seeds {
  uint32_t f[5];
  uint32_t r[5];
};

__global__ void __launch_bounds__(kThreads)
nthash_sel_kernel(const uint8_t* __restrict__ hc, int32_t* __restrict__ canon_out,
                  int32_t* __restrict__ selkey_out, int L, int l, uint32_t threshold,
                  Seeds seeds) {
  __shared__ uint8_t s_c[kTile + kLook];
  __shared__ uint32_t s_seed[10];
  const int row = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const uint8_t* src = hc + (size_t)row * L;
  if (threadIdx.x < 5) {
    s_seed[threadIdx.x] = seeds.f[threadIdx.x];
    s_seed[5 + threadIdx.x] = seeds.r[threadIdx.x];
  }
  for (int i = threadIdx.x; i < kTile + kLook; i += kThreads) {
    const int p = base + i;
    s_c[i] = p < L ? src[p] : (uint8_t)kInvalid;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < kTile; u += kThreads) {
    const int t = base + u;
    if (t >= L) break;
    uint32_t fwd = 0, rev = 0;
    bool bad = false;
    for (int i = 0; i < l; ++i) {
      int c = s_c[u + i];
      bad |= c >= kInvalid;
      c = c > kInvalid ? kInvalid : c;
      fwd ^= __funnelshift_l(s_seed[c], s_seed[c], l - 1 - i);
      rev ^= __funnelshift_l(s_seed[5 + c], s_seed[5 + c], i);
    }
    const uint32_t canon = fwd < rev ? fwd : rev;
    const size_t o = (size_t)row * L + t;
    canon_out[o] = (int32_t)canon;
    selkey_out[o] = (!bad && t <= L - l && canon < threshold) ? t : kBig;
  }
}

}  // namespace

// hcodes: uint8 [B, L]; canon, selkey: int32 [B, L]; seeds: host array of
// SEED32[0..5) then SEED32C[0..5). Returns cudaGetLastError().
extern "C" int mq_nthash_sel(const void* hcodes, void* canon, void* selkey, int B, int L,
                             int l, uint32_t threshold, const uint32_t* seeds,
                             void* stream) {
  Seeds s;
  for (int i = 0; i < 5; ++i) {
    s.f[i] = seeds[i];
    s.r[i] = seeds[5 + i];
  }
  dim3 grid((L + kTile - 1) / kTile, B);
  nthash_sel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)hcodes, (int32_t*)canon, (int32_t*)selkey, L, l, threshold, s);
  return (int)cudaGetLastError();
}
