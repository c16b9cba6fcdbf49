// seed_select_compact: HPC compaction + canonical ntHash + density selection
// + per-block compaction of the selected minimizers, in one pass over the
// packed code | run_start << 3 bytes of a read batch.
//
// Replaces the Pallas kernel _kernel_seed_compact
// (mapquik_tpu/ops/pallas_seeding.py:363-437, reached through
// seed_select_compact :452-477). Output is bit-identical to it in both planes,
// including the per-block slot layout, the empty-slot fills and both causes
// of the 0x7FFFFFFE marker; the plain PyTorch version is
// mapquik_tpu_torch/ops/cuda_seeding.py:seed_select_compact_plain.
//
// Tiles and the copy ring. A tile is one (row, 2048-lane block): its
// 2304-byte window (2048 core lanes + 256 halo lanes). The grid is
// persistent (as many 128-thread CTAs as fit on the card); each CTA walks
// tiles blockIdx.x, + gridDim.x, ... and keeps the next tile's window in
// flight with 16-byte cp.async copies into a ring of two stages while it
// works on the current one. Row stride L + 256 and block offset 2048 j keep
// every copy 16-byte aligned.
//
// Per tile, four CTA barriers:
//   1. the tile has landed (cp.async.wait_group 1, then the barrier);
//   2. compaction 1 (run starts -> a stream of (position, code)) is a block
//      scan of per-thread counts: each thread owns 18 contiguous lanes,
//      counts its run starts with __popc, warp shuffles scan the counts and
//      one barrier publishes the four warp totals. The count of run starts
//      in the core lanes (the owned runs, c_core) rides in the high half of
//      the same scan;
//   3. the stream is written (positions as int32, codes as bytes in the
//      skewed layout of rolling_nthash.cuh);
//   4. compaction 2 (selected owned runs -> kblk slots) is the same block
//      scan, with the halo-exhaustion flag riding in its high half.
// Runs at stream index t only ever read indices t .. t + l <= 2079 < 2304, so
// the wrap-around of the TPU kernel's lane rolls never reaches an owned run.
//
// Hashing. Each of the first 64 threads rolls the canonical ntHash over its
// run of 32 consecutive stream entries (rolling_nthash.cuh): l - 1 warm-up
// steps, then one step per entry, instead of an l-step loop per entry. At 3/4
// of lanes starting a run that is 48 threads per tile; runs of 16 over all
// 128 threads measured 5-7% slower (PERF.md). __launch_bounds__ caps the
// registers at 64, so 8 CTAs reside per SM. The seed tables are selects over
// registers; codes are read as 32-bit words, conflict-free in the skewed
// layout. Tensor cores do not apply: rotate-and-XOR over 32-bit words has no
// matrix-product form worth using.
//
// Bound on the card: operations. Per launch it reads B * (L + 256) bytes and
// writes 2 * B * (L / 2048) * kblk * 4 bytes: 16.8 MB at B = 256, L = 32768,
// kblk = 256, 5.0 us at 3.35 TB/s. The integer work the function needs
// depends on the data; per tile it is 2 operations per window lane (test the
// run-start flag, count it), 2 per run start (stream index, packed entry) and
// 16 per rolling step of one owned window (4 seed lookups, 6 rotates and XORs,
// 2 for validity, min, threshold test, 2 for the selection), plus one l - 1
// step warm-up of the tile's stream. On chip_smoke.py's main-shape rows (3/4
// of lanes start a run) that is 0.134 G operations, 8.0 us at the int32 rate
// of 132 SMs x 64 lanes x 1.98 GHz, which bounds the function; chip_smoke.py
// counts it from each run's data. The kernel executes more: each lookup is 3
// selects, and every 32-entry run has its own warm-up.

#include <cstdint>
#include <cuda_runtime.h>

#include "rolling_nthash.cuh"

namespace {

using mq::Seeds;

constexpr int kCblk = 2048;
constexpr int kHalo = 256;
constexpr int kWc = kCblk + kHalo;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = kWc / kThreads;          // 18 window lanes per thread
constexpr int kRun = 32;                        // stream entries per thread run
constexpr int kMinCtas = 8;                     // per SM: caps registers at 64
constexpr int kChunks = kWc / 16;               // 16-byte copies per tile
constexpr int kStageBytes = kWc + 16;           // + the word compaction 1 reads past the end
constexpr int kStreamFill = kCblk + 64;         // stream entries an owned run may read
constexpr int kCodeWords = mq::skewed_words<kRun>(kWc / 4);
constexpr int kFullThreads = kCblk / kLanes;    // threads whose lanes are all core (113)
constexpr int kInvalid = 4;
constexpr int32_t kBig = 0x7FFFFFFF;
constexpr int32_t kMarker = 0x7FFFFFFE;
constexpr int32_t kFillPos = 0x0FFFFFFF;

static_assert(kLanes * kThreads == kWc, "window must split evenly");
static_assert(kRun * kThreads >= kCblk && kRun <= 32, "runs cover the core, one bit each");
static_assert(kLanes % 2 == 0, "a thread's lanes start 2-byte aligned");
static_assert(kStreamFill <= kWc, "fill stays in the stream");

// Exclusive prefix sum of x over the CTA with one barrier; *total gets the
// CTA sum. s_warp must not be written again before the next CTA barrier.
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = s_warp[w];
    before += w < warp ? v : 0;
    sum += v;
  }
  *total = sum;
  return before + incl - x;
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
seed_select_compact_kernel(const uint8_t* __restrict__ ck, int32_t* __restrict__ canon_out,
                           int32_t* __restrict__ pse_out, int B, int L, int l,
                           uint32_t threshold, int kblk, Seeds seeds) {
  __shared__ __align__(16) uint8_t s_ck[2][kStageBytes];
  __shared__ int32_t s_pos[kWc];
  __shared__ uint32_t s_code[kCodeWords];
  __shared__ uint32_t s_canon[kCblk];
  __shared__ int s_scan1[kWarps];
  __shared__ int s_scan2[kWarps];

  const int tid = threadIdx.x;
  const int nb = L / kCblk;
  const int ntiles = B * nb;
  const mq::RollTables tb = mq::make_tables(seeds, l);
  uint8_t* s_code8 = reinterpret_cast<uint8_t*>(s_code);

  auto load = [&](int tile, int stage) {
    const int row = tile / nb;
    const int j = tile - row * nb;
    const uint8_t* src = ck + (size_t)row * (L + kHalo) + (size_t)j * kCblk;
    for (int c = tid; c < kChunks; c += kThreads) mq::cp_async16(&s_ck[stage][16 * c], src + 16 * c);
  };

  int tile = blockIdx.x;
  if (tile < ntiles) load(tile, 0);
  mq::cp_async_commit();
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    // the other stage was last read before barrier 3 of the previous tile
    const int next = tile + gridDim.x;
    if (next < ntiles) load(next, (it + 1) & 1);
    mq::cp_async_commit();
    mq::cp_async_wait<1>();
    __syncthreads();  // 1: this tile's window has landed

    const int32_t block_start = (tile % nb) * kCblk;
    const uint8_t* win = s_ck[it & 1];

    // --- compaction 1: run starts -> stream (position, code) ---
    const int l0 = tid * kLanes;
    const uint32_t* ww = reinterpret_cast<const uint32_t*>(win) + (l0 >> 2);
    const int off = (l0 & 3) * 8;
    uint32_t a[kLanes / 4 + 1];  // lanes l0 .. l0 + 19 as words
    {
      uint32_t prev = ww[0];
#pragma unroll
      for (int i = 0; i < kLanes / 4 + 1; ++i) {
        const uint32_t nxt = ww[i + 1];
        a[i] = __funnelshift_r(prev, nxt, off);
        prev = nxt;
      }
    }
    uint32_t keep = 0;
#pragma unroll
    for (int u = 0; u < kLanes; ++u) keep |= ((a[u >> 2] >> (8 * (u & 3) + 3)) & 1u) << u;
    const uint32_t core = tid < kFullThreads ? (1u << kLanes) - 1
                        : tid == kFullThreads ? (1u << (kCblk - kFullThreads * kLanes)) - 1
                        : 0u;
    int tot1;
    int r = block_exclusive_scan(__popc(keep) | (__popc(keep & core) << 16), s_scan1, &tot1);
    r &= 0xFFFF;
    const int c_total = tot1 & 0xFFFF;
    const int c_core = tot1 >> 16;
#pragma unroll
    for (int u = 0; u < kLanes; ++u) {
      if (keep & (1u << u)) {
        s_pos[r] = block_start + l0 + u;
        s_code8[mq::skew_byte<kRun>(r)] = (a[u >> 2] >> (8 * (u & 3))) & 7u;
        ++r;
      }
    }
    for (int t = c_total + tid; t < kStreamFill; t += kThreads) {
      s_pos[t] = kFillPos;
      s_code8[mq::skew_byte<kRun>(t)] = kInvalid;
    }
    __syncthreads();  // 3: the stream is written

    // --- hash and select owned runs (stream index t < c_core) ---
    const int t0 = tid * kRun;
    uint32_t sel = 0;
    if (t0 < c_core) {
      mq::roll_run<kRun>(s_code, t0 / 4, l, tb, [&](int m, uint32_t canon, bool bad) {
        if (t0 + m < c_core && !bad && canon < threshold) {
          sel |= 1u << m;
          s_canon[t0 + m] = canon;
        }
      });
    }
    // an owned valid run whose l-run window reaches past the window's runs
    int need = 0;
    const int t_hi = min(t0 + kRun, c_core);
    for (int t = max(t0, c_total - l); t < t_hi; ++t)
      need |= s_code8[mq::skew_byte<kRun>(t)] != kInvalid;

    // --- compaction 2: selected runs -> kblk output slots, markers ---
    int tot2;
    int slot = block_exclusive_scan(__popc(sel) | (need << 16), s_scan2, &tot2) & 0xFFFF;
    const int count2 = tot2 & 0xFFFF;
    const bool eof = c_total > 0 && s_code8[mq::skew_byte<kRun>(c_total - 1)] == kInvalid;
    const bool mark = count2 > kblk || ((tot2 >> 16) != 0 && !eof);
    const size_t out0 = (size_t)tile * kblk;  // (row * nb + j) * kblk
    for (uint32_t s = sel; s; s &= s - 1) {
      const int t = t0 + __ffs(s) - 1;
      if (slot < kblk) {
        canon_out[out0 + slot] = (int32_t)s_canon[t];
        pse_out[out0 + slot] = (mark && slot == kblk - 1)
                                   ? kMarker
                                   : (int32_t)(((uint32_t)s_pos[t] << 16) | (uint32_t)s_pos[t + l]);
      }
      ++slot;
    }
    // empty slots [count2, kblk): 16-byte stores (kblk is a multiple of 128)
    for (int g = tid; g < kblk / 4; g += kThreads) {
      const int s0 = 4 * g;
      if (s0 + 4 <= count2) continue;
      if (s0 >= count2) {
        int4 p = make_int4(kBig, kBig, kBig, kBig);
        if (mark && s0 + 4 == kblk) p.w = kMarker;
        *reinterpret_cast<int4*>(canon_out + out0 + s0) = make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(pse_out + out0 + s0) = p;
      } else {
        for (int s = count2; s < s0 + 4; ++s) {
          canon_out[out0 + s] = 0;
          pse_out[out0 + s] = (mark && s == kblk - 1) ? kMarker : kBig;
        }
      }
    }
  }
  mq::cp_async_wait<0>();
}

}  // namespace

// ck: uint8 [B, L + 256], 16-byte aligned; canon, pse: int32
// [B, (L / 2048) * kblk], 16-byte aligned; seeds: host array of SEED32[0..4)
// then SEED32C[0..4). Returns 0 or the cudaError_t of the launch.
extern "C" int mq_seed_select_compact(const void* ck, void* canon, void* pse, int B, int L,
                                      int l, uint32_t threshold, int kblk,
                                      const uint32_t* seeds, void* stream) {
  Seeds s;
  for (int i = 0; i < 4; ++i) {
    s.f[i] = seeds[i];
    s.r[i] = seeds[4 + i];
  }
  int grid = 0;
  const int err = mq::persistent_grid(seed_select_compact_kernel, kThreads, B * (L / kCblk), &grid);
  if (err != 0) return err;
  seed_select_compact_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ck, (int32_t*)canon, (int32_t*)pse, B, L, l, threshold, kblk, s);
  return (int)cudaGetLastError();
}
