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
// [t, t + l) holds no code >= 4, t <= L - l and canon[t] < threshold
// (unsigned), else 0x7FFFFFFF; canon[t] = min(fwd[t], rev[t]) at every such
// valid window (elsewhere canon is left free).
//
// Tiles and the copy ring. The batch is one flat stream of n = B * L codes
// (n < 2^31). A tile is 4096 consecutive positions; its codes plus a 64-byte
// lookahead come in with 4-byte cp.async copies (zero-filled past n) into a
// ring of two stages, in the skewed layout of rolling_nthash.cuh, while the
// CTA works on the previous tile. The grid is persistent: as many 128-thread
// CTAs as fit on the card, each walking tiles blockIdx.x, + gridDim.x, ...
// Windows that cross a row's end read the next row's codes; they are exactly
// the windows with t > L - l, which the contract makes invalid, and their
// canon is free. So rows need no padding and any B and L work.
//
// Hashing. Each thread rolls the canonical ntHash over its run of 32
// consecutive positions (rolling_nthash.cuh): l - 1 warm-up steps, then one
// step per position. The seed tables are selects over registers; codes are
// read as 32-bit words, conflict-free in the skewed layout. Tensor cores do
// not apply: rotate-and-XOR over 32-bit words has no matrix-product form
// worth using.
//
// Output. Each thread puts its canon and selkey values into shared memory as
// 16-byte vectors (swizzled so that neither the writes nor the reads conflict),
// and after one barrier the CTA writes the tile's two planes with coalesced
// 16-byte stores. Two barriers per tile.
//
// Bound on the card: bytes. It reads B * L bytes and writes 2 * B * L * 4
// bytes: 151 MB at B = 256, L = 65536, 45.1 us at 3.35 TB/s. The integer
// work the function needs is 16 operations per rolling step of one position
// (4 seed lookups, 6 rotates and XORs, 2 for validity, min, threshold test,
// 2 for the key) plus one l - 1 step warm-up per row: 0.269 G operations at
// B = 256, L = 65536, l = 31, 16.1 us at the int32 rate of 132 SMs x 64 lanes
// x 1.98 GHz. The kernel executes more: each lookup is 3 selects, and every
// 32-position run has its own warm-up.

#include <cstdint>
#include <cuda_runtime.h>

#include "rolling_nthash.cuh"

namespace {

using mq::Seeds;

constexpr int kThreads = 128;
constexpr int kRun = 32;                        // positions per thread
constexpr int kTile = kThreads * kRun;          // 4096 positions per tile
constexpr int kVec = kRun / 4;                  // 16-byte vectors per thread and plane
constexpr int kLoadWords = (kTile + 64) / 4;    // tile + lookahead (l - 1 <= 31, read-ahead)
constexpr int kStageWords = mq::skewed_words<kRun>(kLoadWords);
constexpr int32_t kBig = 0x7FFFFFFF;

static_assert(kVec == 8, "the output swizzle assumes 8 vectors per thread");

// Slot of thread k's q-th output vector: a phase of 8 threads writing their
// q-th vectors, and 8 consecutive vectors read back, each hit 8 bank groups.
__device__ __forceinline__ int out_slot(int k, int q) { return kVec * k + (q ^ (k & 7)); }

__device__ __forceinline__ void set_lane(int4& v, int i, int x) {
  if (i == 0) v.x = x;
  else if (i == 1) v.y = x;
  else if (i == 2) v.z = x;
  else v.w = x;
}

__global__ void __launch_bounds__(kThreads)
nthash_sel_kernel(const uint8_t* __restrict__ hc, int32_t* __restrict__ canon_out,
                  int32_t* __restrict__ selkey_out, int n, int L, int l, uint32_t threshold,
                  Seeds seeds) {
  __shared__ __align__(16) uint32_t s_in[2][kStageWords];
  __shared__ int4 s_canon[kTile / 4];
  __shared__ int4 s_sel[kTile / 4];

  const int tid = threadIdx.x;
  const int ntiles = (n - 1) / kTile + 1;
  const mq::RollTables tb = mq::make_tables(seeds, l);

  auto load = [&](int tile, int stage) {
    const long long f0 = (long long)tile * kTile;
    for (int w = tid; w < kLoadWords; w += kThreads) {
      const long long o = f0 + 4 * w;
      const long long left = (long long)n - o;
      const int bytes = left >= 4 ? 4 : (left > 0 ? (int)left : 0);
      mq::cp_async4(&s_in[stage][mq::skew_word<kRun>(w)], bytes > 0 ? hc + o : hc, bytes);
    }
  };

  int tile = blockIdx.x;
  if (tile < ntiles) load(tile, 0);
  mq::cp_async_commit();
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    // the other stage was last read before the previous tile's output barrier
    const int next = tile + gridDim.x;
    if (next < ntiles) load(next, (it + 1) & 1);
    mq::cp_async_commit();
    mq::cp_async_wait<1>();
    __syncthreads();  // this tile's codes have landed; the output stage is free

    const long long f0 = (long long)tile * kTile;
    const int u0 = tid * kRun;
    if (f0 + u0 < n) {
      // position in its row of the run's first window (f0 + u0 < n < 2^31)
      int t = (int)((unsigned)(f0 + u0) % (unsigned)L);
      int4 cv, sv;
      mq::roll_run<kRun>(s_in[it & 1], u0 / 4, l, tb, [&](int m, uint32_t canon, bool bad) {
        set_lane(cv, m & 3, (int)canon);
        set_lane(sv, m & 3, (!bad && t <= L - l && canon < threshold) ? t : kBig);
        t = t + 1 == L ? 0 : t + 1;
        if ((m & 3) == 3) {
          s_canon[out_slot(tid, m >> 2)] = cv;
          s_sel[out_slot(tid, m >> 2)] = sv;
        }
      });
    }
    __syncthreads();  // the tile's outputs are staged

    for (int g = tid; g < kTile / 4; g += kThreads) {
      const long long e = f0 + 4 * g;
      if (e >= n) break;
      const int slot = out_slot(g / kVec, g % kVec);
      const int4 cv = s_canon[slot];
      const int4 sv = s_sel[slot];
      if (e + 4 <= n) {
        *reinterpret_cast<int4*>(canon_out + e) = cv;
        *reinterpret_cast<int4*>(selkey_out + e) = sv;
      } else {
        const int c4[4] = {cv.x, cv.y, cv.z, cv.w};
        const int s4[4] = {sv.x, sv.y, sv.z, sv.w};
        for (int i = 0; i < n - e; ++i) {
          canon_out[e + i] = c4[i];
          selkey_out[e + i] = s4[i];
        }
      }
    }
  }
  mq::cp_async_wait<0>();
}

}  // namespace

// hcodes: uint8 [B, L], 16-byte aligned, B * L < 2^31; canon, selkey: int32
// [B, L], 16-byte aligned; seeds: host array of SEED32[0..4) then
// SEED32C[0..4). Returns 0 or the cudaError_t of the launch.
extern "C" int mq_nthash_sel(const void* hcodes, void* canon, void* selkey, int B, int L,
                             int l, uint32_t threshold, const uint32_t* seeds,
                             void* stream) {
  Seeds s;
  for (int i = 0; i < 4; ++i) {
    s.f[i] = seeds[i];
    s.r[i] = seeds[4 + i];
  }
  const int n = B * L;
  int grid = 0;
  const int err = mq::persistent_grid(nthash_sel_kernel, kThreads, (n - 1) / kTile + 1, &grid);
  if (err != 0) return err;
  nthash_sel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)hcodes, (int32_t*)canon, (int32_t*)selkey, n, L, l, threshold, s);
  return (int)cudaGetLastError();
}
