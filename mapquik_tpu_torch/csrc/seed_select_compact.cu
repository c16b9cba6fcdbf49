// seed_select_compact: HPC compaction + canonical ntHash + density selection
// + per-block compaction of the selected minimizers, in one pass over the
// packed code | run_start << 3 bytes of a read batch.
//
// Replaces the Pallas kernel _kernel_seed_compact
// (mapquik_tpu/ops/pallas_seeding.py:363-437, reached through
// seed_select_compact :452-477). Output is bit-identical to it in both planes,
// including the per-block slot layout, the empty-slot fills and the
// 0x7FFFFFFE marker; the plain PyTorch version is
// mapquik_tpu_torch/ops/cuda_seeding.py:seed_select_compact_plain.
//
// Design. One CTA of 256 threads per (row, 2048-lane block). The block's
// 2304-byte window (2048 core lanes + 256 halo lanes) is staged in shared
// memory with 4-byte loads. Compaction 1 (run starts -> a stream of
// (position, code)) and compaction 2 (selected owned runs -> output slots)
// are block-wide prefix sums: each thread owns a contiguous chunk of lanes,
// counts its flags with __popc over a bit mask, and the chunk offsets come
// from a warp-shuffle scan of the counts. Each owned run's l-run window is
// hashed directly from the shared-memory stream (l <= 32 steps). Runs at
// stream index t only ever read indices t .. t + l <= 2079 < 2304, so the
// wrap-around of the TPU kernel's lane rolls never reaches an owned run.
//
// Bound on the card: bytes. Per launch it reads B * (L + 256) bytes once and
// writes 2 * B * (L / 2048) * kblk * 4 bytes; at B = 256, L = 32768,
// kblk = 256 that is 16.8 MB, 5.0 us at 3.35 TB/s. The hashing is l integer
// operations per run on shared memory, far below the card's integer rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCblk = 2048;
constexpr int kHalo = 256;
constexpr int kWc = kCblk + kHalo;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer1 = kWc / kThreads;    // 9 window lanes per thread
constexpr int kPer2 = kCblk / kThreads;  // 8 stream entries per thread
constexpr int kInvalid = 4;
constexpr int32_t kBig = 0x7FFFFFFF;
constexpr int32_t kMarker = 0x7FFFFFFE;
constexpr int32_t kFillPos = 0x0FFFFFFF;

static_assert(kPer1 * kThreads == kWc, "window must split evenly");
static_assert(kPer2 * kThreads == kCblk, "core must split evenly");

struct Seeds {
  uint32_t f[5];
  uint32_t r[5];
};

__device__ __forceinline__ uint32_t rol32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);  // shift amount taken mod 32
}

// Exclusive prefix sum of `x` over the CTA; *total gets the CTA sum.
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) s_warp[lane] = t;
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : s_warp[warp - 1];
  *total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp is reused by the next scan
  return before + incl - x;
}

__global__ void __launch_bounds__(kThreads)
seed_select_compact_kernel(const uint8_t* __restrict__ ck, int32_t* __restrict__ canon_out,
                           int32_t* __restrict__ pse_out, int L, int l, uint32_t threshold,
                           int kblk, Seeds seeds) {
  __shared__ __align__(16) uint8_t s_ck[kWc];
  __shared__ int32_t s_pos[kWc];
  __shared__ uint8_t s_code[kWc];
  __shared__ uint32_t s_seed[10];
  __shared__ int s_warp[kWarps];

  const int j = blockIdx.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int nb = L / kCblk;
  const int32_t block_start = j * kCblk;
  const int32_t block_end = block_start + kCblk;

  if (tid < 5) {
    s_seed[tid] = seeds.f[tid];
    s_seed[5 + tid] = seeds.r[tid];
  }
  // stage the window: row stride L + 256 and j * 2048 keep 4-byte alignment
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(ck + (size_t)row * (L + kHalo) + block_start);
  uint32_t* dst = reinterpret_cast<uint32_t*>(s_ck);
  for (int i = tid; i < kWc / 4; i += kThreads) dst[i] = src[i];
  __syncthreads();

  // --- compaction 1: run starts -> stream (position, code) ---
  const int l0 = tid * kPer1;
  unsigned keep_mask = 0;
#pragma unroll
  for (int u = 0; u < kPer1; ++u) keep_mask |= ((s_ck[l0 + u] >> 3) & 1u) << u;
  int c_total;
  int r = block_exclusive_scan(__popc(keep_mask), s_warp, &c_total);
#pragma unroll
  for (int u = 0; u < kPer1; ++u) {
    if (keep_mask & (1u << u)) {
      s_pos[r] = block_start + l0 + u;
      s_code[r] = s_ck[l0 + u] & 7;
      ++r;
    }
  }
  for (int t = c_total + tid; t < kWc; t += kThreads) {
    s_pos[t] = kFillPos;
    s_code[t] = kInvalid;
  }
  __syncthreads();

  // --- hash and select owned runs (stream index t < 2048 holds every one) ---
  const int t0 = tid * kPer2;
  unsigned sel_mask = 0;
  int need = 0;
  uint32_t canon_v[kPer2];
  int32_t pse_v[kPer2];
#pragma unroll
  for (int u = 0; u < kPer2; ++u) {
    const int t = t0 + u;
    canon_v[u] = 0;
    pse_v[u] = kBig;
    const int32_t pos = s_pos[t];
    if (pos >= block_end) continue;  // not owned (holes carry kFillPos)
    const int code = s_code[t];
    if (code != kInvalid && t + l >= c_total) need = 1;
    uint32_t fwd = 0, rev = 0;
    bool bad = false;
    for (int i = 0; i < l; ++i) {
      int c = s_code[t + i];
      bad |= c >= kInvalid;
      c = c > kInvalid ? kInvalid : c;
      fwd ^= rol32(s_seed[c], l - 1 - i);
      rev ^= rol32(s_seed[5 + c], i);
    }
    const uint32_t canon = fwd < rev ? fwd : rev;
    if (!bad && canon < threshold) {
      sel_mask |= 1u << u;
      canon_v[u] = canon;
      pse_v[u] = (int32_t)(((uint32_t)pos << 16) | (uint32_t)s_pos[t + l]);
    }
  }
  const int any_need = __syncthreads_or(need);

  // --- compaction 2: selected runs -> kblk output slots, markers ---
  int count2;
  int slot = block_exclusive_scan(__popc(sel_mask), s_warp, &count2);
  const bool eof = c_total > 0 && s_code[c_total - 1] == kInvalid;
  const bool mark = count2 > kblk || (any_need && !eof);
  const size_t out0 = (size_t)row * nb * kblk + (size_t)j * kblk;
#pragma unroll
  for (int u = 0; u < kPer2; ++u) {
    if (sel_mask & (1u << u)) {
      if (slot < kblk) {
        canon_out[out0 + slot] = (int32_t)canon_v[u];
        pse_out[out0 + slot] = (mark && slot == kblk - 1) ? kMarker : pse_v[u];
      }
      ++slot;
    }
  }
  for (int s = count2 + tid; s < kblk; s += kThreads) {
    canon_out[out0 + s] = 0;
    pse_out[out0 + s] = (mark && s == kblk - 1) ? kMarker : kBig;
  }
}

}  // namespace

// ck: uint8 [B, L + 256]; canon, pse: int32 [B, (L / 2048) * kblk];
// seeds: host array of SEED32[0..5) then SEED32C[0..5). Returns cudaGetLastError().
extern "C" int mq_seed_select_compact(const void* ck, void* canon, void* pse, int B, int L,
                                      int l, uint32_t threshold, int kblk,
                                      const uint32_t* seeds, void* stream) {
  Seeds s;
  for (int i = 0; i < 5; ++i) {
    s.f[i] = seeds[i];
    s.r[i] = seeds[5 + i];
  }
  dim3 grid(L / kCblk, B);
  seed_select_compact_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ck, (int32_t*)canon, (int32_t*)pse, L, l, threshold, kblk, s);
  return (int)cudaGetLastError();
}
