// Valid-slot compaction of a packed search stage: the stage's compact
// download.
//
// Replaces matchtigs_tpu/ops/sssp.py:_sssp_run_pool_compact (K4), which
// filters the packed rows on the device and compacts the survivors in
// row-major order by one two-key sort over an int32 flat-position key
// with an invalid bit at 2^30 (a key that overflows once (S+1) * C
// reaches 2^30).  Here the same output comes from one scan, with int64
// positions:
//
//   * a slot is valid when its node is not the sentinel, 1 <= dist <=
//     max_weight, and its row did not overflow;
//   * counts[r] is row r's number of valid slots (int8 when C <= 127, else
//     int32), total their sum (int64);
//   * the valid values, in row-major order, fill out[0, min(total,
//     budget)); values past the budget are dropped (the caller then
//     fetches the full rows).
//
// One launch, a single-pass scan.  A block takes a tile of kTileSlots
// slots by an atomic ticket (so every earlier tile's block is already
// running): kTileSlots / C whole rows, or, for a row longer than a tile,
// one piece of it.  It loads the tile's slots with 16-byte loads where
// they are aligned, flags the valid ones, scans the flags across the block
// (popcounts, warp shuffles and one warp-sum array), writes each row's
// count from the scan at the row's end, publishes its own count and finds
// the count of all earlier tiles by a decoupled look-back, stages its
// survivors compacted in shared memory and writes them as one contiguous
// range, cut at the budget.  The last piece of a long row takes the row's
// count from the look-back prefix before the row's first piece, and the
// last tile writes the total.  What bounds it: bytes, the [S, C] rows and
// the flags read once, the counts and survivors written once; here the
// rows are read once and the survivors are written coalesced.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (a plain C ABI, loaded with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDistBits = 7;
constexpr int kDistCap = (1 << kDistBits) - 1;
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kSlotsPerThread = 16;
constexpr int kTileSlots = kBlock * kSlotsPerThread;  // 16 KB of rows
constexpr unsigned long long kFlagAggregate = 1ull << 62;  // the tile's count
constexpr unsigned long long kFlagPrefix = 1ull << 63;     // tiles [0, tile]
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

// A tile is tile_rows whole rows (C <= kTileSlots), or one of a row's
// chunks pieces (C > kTileSlots).
struct Tiling {
  long long tiles;
  int tile_rows;
  int chunks;
};

Tiling tiling(int n_rows, int C) {
  if (C <= kTileSlots) {
    const int r = kTileSlots / C;
    return {(n_rows + (long long)r - 1) / r, r, 1};
  }
  const int chunks = (C + kTileSlots - 1) / kTileSlots;
  return {(long long)n_rows * chunks, 1, chunks};
}

__device__ __forceinline__ bool valid_slot(int key, int sentinel,
                                           int max_weight) {
  const int node = key >> kDistBits, dist = key & kDistCap;
  return node != sentinel && dist >= 1 && dist <= max_weight;
}

// Exclusive scan of x over the block; *total receives the block's sum.
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sum[w];
    if (w < warp) before += s;
    sum += s;
  }
  *total = sum;
  return before + v - x;
}

__global__ void __launch_bounds__(kBlock)
compact_kernel(const int* __restrict__ rows, const uint8_t* __restrict__ over,
               int n_rows, int C, int sentinel, int max_weight,
               long long budget, int* __restrict__ out, void* counts,
               int counts_int8, unsigned long long* __restrict__ state,
               long long* __restrict__ total, Tiling t) {
  __shared__ int survivors[kTileSlots];
  __shared__ int row_end[kTileSlots];  // inclusive count at each row's end
  __shared__ uint8_t over_s[kTileSlots];
  __shared__ long long tile_s, before_s;
  if (threadIdx.x == 0) tile_s = (long long)atomicAdd(&state[0], 1ull);
  __syncthreads();
  const long long tile = tile_s;
  const long long row0 = tile / t.chunks * t.tile_rows;
  const int chunk = (int)(tile % t.chunks);
  const int n_tile_rows =
      (int)(n_rows - row0 < t.tile_rows ? n_rows - row0 : t.tile_rows);
  const int n_slots = t.chunks == 1
                          ? n_tile_rows * C
                          : min(kTileSlots, C - chunk * kTileSlots);
  for (int r = threadIdx.x; r < n_tile_rows; r += kBlock) {
    over_s[r] = over[row0 + r];
  }

  // this thread's slots: [local0, local0 + kSlotsPerThread) of the tile
  const int local0 = threadIdx.x * kSlotsPerThread;
  const int* src = rows + row0 * C + (long long)chunk * kTileSlots + local0;
  int key[kSlotsPerThread];
  if (local0 + kSlotsPerThread <= n_slots && ((uintptr_t)src & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kSlotsPerThread / 4; ++q) {
      const int4 v = reinterpret_cast<const int4*>(src)[q];
      key[4 * q] = v.x;
      key[4 * q + 1] = v.y;
      key[4 * q + 2] = v.z;
      key[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSlotsPerThread; ++j) {
      key[j] = local0 + j < n_slots ? src[j] : 0;
    }
  }
  __syncthreads();  // over_s
  const int r0 = t.chunks == 1 ? local0 / C : 0;  // row of slot local0
  const int col0 = t.chunks == 1 ? local0 - r0 * C : 0;
  unsigned valid = 0;  // bit j: slot local0 + j survives
  int r = r0, col = col0;
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    if (local0 + j < n_slots && !over_s[r] &&
        valid_slot(key[j], sentinel, max_weight)) {
      valid |= 1u << j;
    }
    if (++col == C) {
      col = 0;
      ++r;
    }
  }
  int tile_count;
  const int excl = block_exclusive_scan(__popc(valid), &tile_count);
  int at = excl;
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    if (valid >> j & 1) survivors[at++] = key[j];
  }
  if (t.chunks == 1) {
    r = r0;
    col = col0;
    for (int j = 0; j < kSlotsPerThread && local0 + j < n_slots; ++j) {
      if (++col == C) {
        row_end[r] = excl + __popc(valid & ((2u << j) - 1));
        col = 0;
        ++r;
      }
    }
  }

  // decoupled look-back: the count of all earlier tiles
  if (threadIdx.x == 0) {
    volatile unsigned long long* lookback = state + 1;
    unsigned long long before = 0;
    if (tile == 0) {
      lookback[0] = kFlagPrefix | (unsigned long long)tile_count;
    } else {
      lookback[tile] = kFlagAggregate | (unsigned long long)tile_count;
      for (long long j = tile - 1;; --j) {
        unsigned long long w;
        do {
          w = lookback[j];
        } while (w == 0);
        before += w & kValueMask;
        if (w & kFlagPrefix) break;
      }
      lookback[tile] = kFlagPrefix | (before + tile_count);
    }
    if (t.chunks > 1 && chunk == t.chunks - 1) {
      // the last piece of a long row: its end minus the prefix before the
      // row's first piece
      const long long first = tile - chunk;
      unsigned long long start = 0;
      if (first > 0) {
        unsigned long long w;
        do {
          w = lookback[first - 1];
        } while (!(w & kFlagPrefix));
        start = w & kValueMask;
      }
      static_cast<int*>(counts)[row0] = (int)(before + tile_count - start);
    }
    if (tile == t.tiles - 1) *total = (long long)(before + tile_count);
    before_s = (long long)before;
  }
  __syncthreads();
  if (t.chunks == 1) {
    for (int i = threadIdx.x; i < n_tile_rows; i += kBlock) {
      const int c = row_end[i] - (i > 0 ? row_end[i - 1] : 0);
      if (counts_int8) {
        static_cast<int8_t*>(counts)[row0 + i] = (int8_t)c;
      } else {
        static_cast<int*>(counts)[row0 + i] = c;
      }
    }
  }
  const long long base = before_s;
  for (int i = threadIdx.x; i < tile_count && base + i < budget; i += kBlock) {
    out[base + i] = survivors[i];
  }
}

}  // namespace

// Words of the uint64 state sssp_compact_launch takes for n_rows rows of C
// slots: the tile ticket, then one look-back word per tile.
extern "C" long long sssp_compact_state_words(int n_rows, int C) {
  if (n_rows < 1 || C < 1) return 0;
  return 1 + tiling(n_rows, C).tiles;
}

// rows: int32 [n_rows, C] packed search rows; over: uint8 [n_rows].
// counts: int8 [n_rows] when counts_int8, else int32 [n_rows].  state:
// uint64 [sssp_compact_state_words(n_rows, C)] scratch, zeroed here; total:
// one int64.  out: int32 [budget].  Returns the cudaError_t of the launch.
extern "C" int sssp_compact_launch(const int* rows, const uint8_t* over,
                                   int n_rows, int C, int sentinel,
                                   int max_weight, long long budget,
                                   int* out, void* counts, int counts_int8,
                                   unsigned long long* state,
                                   long long* total, void* stream) {
  if (n_rows < 1 || C < 1 || (counts_int8 && C > 127)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tiling t = tiling(n_rows, C);
  cudaError_t e = cudaMemsetAsync(
      state, 0, sizeof(unsigned long long) * (size_t)(1 + t.tiles), s);
  if (e != cudaSuccess) return (int)e;
  compact_kernel<<<(unsigned)t.tiles, kBlock, 0, s>>>(
      rows, over, n_rows, C, sentinel, max_weight, budget, out, counts,
      counts_int8, state, total, t);
  return (int)cudaGetLastError();
}
