// Sort and merge-split of int64 keys: the mesh's acceptance sort.
//
// Replaces matchtigs_tpu/parallel/mesh.py:_sharded_sort_impl (K7).  There
// each shard sorts its block of 64-bit keys, carried as (hi int32, lo
// uint32) pairs, with a two-key lax.sort; then n_dev odd-even
// transposition rounds exchange whole blocks between neighbouring shards
// and sort each 2L concatenation again, the left shard keeping the low L
// keys and the right shard the high L.  Here the keys are signed int64 as
// they are, and the two parts are two entries:
//
//   * mesh_sort_launch sorts n keys ascending by a key-only LSD radix sort:
//     8 passes of 8-bit digits.  The top digit is read with its sign bit
//     flipped, so negative keys come first; the keys themselves are never
//     changed.  One kernel reads every key once (16-byte loads) and builds
//     all 8 digit histograms (per-block shared counters, merged by
//     atomics); its last block scans them into each digit's global start
//     and plans the passes: a pass whose digit is the same in every key is
//     skipped, and the active passes alternate between out and tmp so that
//     the last one writes out (in is only read).  Each pass is then one
//     scatter kernel: a block takes a tile of kTileKeys keys by an atomic
//     ticket (so every earlier tile's block is already running) and loads
//     it coalesced; it ranks its keys by digit, stably in input order, with
//     8 ballots per key (one per digit bit) and per-warp digit counters in
//     shared memory; it publishes its per-digit counts, reorders the tile
//     by digit in shared memory, finds the counts of all earlier tiles by a
//     decoupled look-back, and writes each digit's run contiguously.
//   * mesh_merge_split_launch merges two sorted blocks of L keys and
//     writes only the outputs [0, L) or [L, 2L), a tile of kMergeTile
//     outputs per block: two warps find where the tile's first and last
//     diagonals cross the two blocks (32 probes per step), the block loads
//     the tile's ranges of a and b into shared memory and stores its
//     outputs coalesced, and each thread merges kItems outputs in shared
//     memory.
//
// What bounds it: bytes.  The least work reads and writes every key once
// (16 bytes per key).  The sort reads every key once for the histograms,
// then reads and writes it once per active pass: 16 bytes per key per
// pass, half of what a radix sort that also carries an int64 index moves,
// in 9 launches where the merge sort this replaces took 13 (each of its
// merge passes read the two runs uncoalesced).  Equal keys are
// interchangeable, but LSD needs every pass stable, so the rank is in
// input order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (a plain C ABI, loaded with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPasses = 8;           // 8-bit digits of a 64-bit key
constexpr int kDigits = 256;
constexpr int kThreads = 256;        // one thread per digit in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerThread = 16;
constexpr int kTileKeys = kThreads * kKeysPerThread;  // 32 KB of keys
constexpr int kHistCopies = 4;       // shared histograms per block, by warp
// state: 64-bit words, zeroed by the launch; a look-back word holds two
// flags and a 62-bit count, so no key count a card can hold overflows it
using Word = unsigned long long;
constexpr Word kFlagAggregate = 1ull << 62;  // the tile's own count
constexpr Word kFlagPrefix = 1ull << 63;     // count of tiles [0, tile]
constexpr Word kValueMask = kFlagAggregate - 1;
constexpr Word kSkip = ~0ull;                // plan of a skipped pass
constexpr int kCountsAt = 0;                   // [8][256] digit counts
constexpr int kBasesAt = kPasses * kDigits;    // [8][256] digit starts
constexpr int kPlanAt = 2 * kPasses * kDigits; // [8] kSkip, or src | dst << 2
constexpr int kTicketAt = kPlanAt + kPasses;   // [8] tile tickets
constexpr int kDoneAt = kTicketAt + kPasses;   // histogram blocks done
constexpr int kLookbackAt = kDoneAt + 16;      // [8][tiles][256]
enum Buffer { kIn = 0, kOut = 1, kTmp = 2 };

// outputs per merge thread: odd, so that the threads' runs in shared memory
// start on different banks
constexpr int kItems = 9;
constexpr int kMergeThreads = 256;
constexpr int kMergeTile = kMergeThreads * kItems;  // outputs per block

__device__ __forceinline__ unsigned digit(long long key, int pass) {
  const unsigned d = (unsigned)((unsigned long long)key >> (8 * pass)) & 0xffu;
  return pass == kPasses - 1 ? d ^ 0x80u : d;  // the sign bit
}

// Exclusive scan of x over the block's kThreads threads; *sum receives the
// block's total.
template <typename T>
__device__ T block_exclusive_scan(T x, T* sum) {
  __shared__ T warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T v = x;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  T before = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const T s = warp_sum[w];
    if (w < warp) before += s;
    total += s;
  }
  __syncthreads();  // warp_sum is reused by the next call
  *sum = total;
  return before + v - x;
}

// The lanes of the warp whose key is valid and has digit d (8 ballots, one
// per bit of the digit).
__device__ __forceinline__ unsigned match_digit(unsigned d, bool ok) {
  unsigned peers = __ballot_sync(0xffffffffu, ok);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned bits = __ballot_sync(0xffffffffu, (d >> b) & 1u);
    peers &= ((d >> b) & 1u) ? bits : ~bits;
  }
  return peers;
}

// Adds one key to the block's 8 histograms.
__device__ __forceinline__ void count_key(unsigned (*h)[kDigits],
                                          long long key) {
#pragma unroll
  for (int p = 0; p < kPasses; ++p) atomicAdd(&h[p][digit(key, p)], 1u);
}

// All 8 digit histograms in one read of the keys (16-byte loads where in is
// 16-byte aligned); the last block to finish scans them and plans the
// passes.
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const long long* __restrict__ in, long long n,
                 Word* __restrict__ state) {
  __shared__ unsigned hs[kHistCopies][kPasses][kDigits];
  __shared__ int active[kPasses];
  __shared__ bool last;
  for (int i = threadIdx.x; i < kHistCopies * kPasses * kDigits; i += kThreads) {
    (&hs[0][0][0])[i] = 0;
  }
  __syncthreads();
  unsigned (*h)[kDigits] = hs[(threadIdx.x >> 5) % kHistCopies];
  const bool vec = ((uintptr_t)in & 15) == 0;
  const long long units = vec ? n / 2 : n;  // key pairs, or keys
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long u = (long long)blockIdx.x * kThreads + threadIdx.x; u < units;
       u += stride) {
    if (vec) {
      const longlong2 v = reinterpret_cast<const longlong2*>(in)[u];
      count_key(h, v.x);
      count_key(h, v.y);
    } else {
      count_key(h, in[u]);
    }
  }
  if (vec && (n & 1) && blockIdx.x == 0 && threadIdx.x == 0) {
    count_key(h, in[n - 1]);
  }
  __syncthreads();
  Word* counts = state + kCountsAt;
  for (int i = threadIdx.x; i < kPasses * kDigits; i += kThreads) {
    unsigned c = 0;
    for (int copy = 0; copy < kHistCopies; ++copy) c += (&hs[copy][0][0])[i];
    if (c) atomicAdd(&counts[i], (Word)c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&state[kDoneAt], 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int d = threadIdx.x;
  for (int p = 0; p < kPasses; ++p) {
    const Word c = ((volatile Word*)counts)[p * kDigits + d];
    Word total;
    state[kBasesAt + p * kDigits + d] = block_exclusive_scan(c, &total);
    const int nonzero = __syncthreads_count(c != 0);
    if (d == 0) active[p] = nonzero > 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int k = 0;
    for (int p = 0; p < kPasses; ++p) k += active[p];
    if (k == 0) {  // all keys equal: one pass copies them to out
      active[0] = 1;
      k = 1;
    }
    int src = kIn, a = 0;
    for (int p = 0; p < kPasses; ++p) {
      if (!active[p]) {
        state[kPlanAt + p] = kSkip;
        continue;
      }
      const int dst = ((k - 1 - a) & 1) ? kTmp : kOut;
      state[kPlanAt + p] = (Word)(src | dst << 2);
      src = dst;
      ++a;
    }
  }
}

// One pass: a stable scatter of the keys by digit `pass`.
__global__ void __launch_bounds__(kThreads, 4)
scatter_kernel(const long long* in, long long* out, long long* tmp,
               long long n, int pass, Word* __restrict__ state,
               long long tiles) {
  __shared__ long long tile_keys[kTileKeys];
  __shared__ unsigned warp_count[kWarps][kDigits];
  __shared__ unsigned tile_off[kDigits];
  __shared__ long long run_base[kDigits];
  __shared__ long long tile_s;
  const Word plan = state[kPlanAt + pass];
  if (plan == kSkip) return;  // every key has the same digit here
  const int code = (int)plan;
  const long long* __restrict__ src =
      (code & 3) == kIn ? in : (code & 3) == kOut ? out : tmp;
  long long* __restrict__ dst = (code >> 2) == kOut ? out : tmp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d_own = threadIdx.x;  // this thread's digit in the scans
  if (threadIdx.x == 0) {
    tile_s = (long long)atomicAdd(&state[kTicketAt + pass], 1ull);
  }
  for (int w = 0; w < kWarps; ++w) warp_count[w][d_own] = 0;
  __syncthreads();
  const long long tile = tile_s;
  const long long tile_base = tile * kTileKeys;

  // load warp-striped: key i of lane l of warp w is the tile's key
  // w * 32 * kKeysPerThread + i * 32 + l, so each load is one contiguous
  // 256-byte span and (warp, i, lane) is the input order
  long long keys[kKeysPerThread];
  unsigned rank[kKeysPerThread];
  const long long warp_base = tile_base + (long long)warp * 32 * kKeysPerThread;
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const long long idx = warp_base + i * 32 + lane;
    keys[i] = idx < n ? src[idx] : 0;
  }
  // rank: the key's place among the warp's keys of its digit, input order
  const unsigned lower = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const bool ok = warp_base + i * 32 + lane < n;
    const unsigned d = ok ? digit(keys[i], pass) : kDigits;
    const unsigned peers = match_digit(d, ok);
    const int leader = ok ? __ffs((int)peers) - 1 : lane;
    unsigned old = 0;
    if (ok && lane == leader) old = atomicAdd(&warp_count[warp][d], __popc(peers));
    rank[i] = __shfl_sync(0xffffffffu, old, leader) + __popc(peers & lower);
  }
  __syncthreads();

  // per digit: the warps' exclusive offsets and the tile's count, published
  // at once so that later tiles can go on
  unsigned count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = warp_count[w][d_own];
    warp_count[w][d_own] = count;
    count += c;
  }
  volatile Word* lookback =
      state + kLookbackAt + ((long long)pass * tiles + tile) * kDigits;
  lookback[d_own] = (tile == 0 ? kFlagPrefix : kFlagAggregate) | count;
  unsigned tile_keys_n;
  const unsigned off = block_exclusive_scan(count, &tile_keys_n);
  tile_off[d_own] = off;
  __syncthreads();

  // reorder the tile by digit in shared memory
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    if (warp_base + i * 32 + lane < n) {
      const unsigned d = digit(keys[i], pass);
      tile_keys[tile_off[d] + warp_count[warp][d] + rank[i]] = keys[i];
    }
  }
  // decoupled look-back: the digit's count in all earlier tiles
  Word earlier = 0;
  if (tile > 0) {
    for (long long j = 1;; ++j) {
      Word w;
      do {
        w = lookback[-j * kDigits + d_own];
      } while (w == 0);
      earlier += w & kValueMask;
      if (w & kFlagPrefix) break;
    }
    lookback[d_own] = kFlagPrefix | (earlier + count);
  }
  run_base[d_own] =
      (long long)(state[kBasesAt + pass * kDigits + d_own] + earlier) - off;
  __syncthreads();

  // write each digit's run
  for (int i = threadIdx.x; i < (int)tile_keys_n; i += kThreads) {
    const long long key = tile_keys[i];
    dst[run_base[digit(key, pass)] + i] = key;
  }
}

// The number of a's keys among outputs [0, diag) of the merge of sorted
// a[0, la) and b[0, lb), a's keys first on ties; called by a whole warp.
// The split is the first i with a[i] > b[diag - 1 - i]: each step probes
// 32 points of the range at once and keeps the gap between the last probe
// below the split and the first above it.
__device__ long long warp_split(const long long* __restrict__ a, long long la,
                                const long long* __restrict__ b, long long lb,
                                long long diag) {
  const int lane = threadIdx.x & 31;
  long long lo = diag > lb ? diag - lb : 0, hi = diag < la ? diag : la;
  while (hi - lo > 32) {
    const long long m = hi - lo;
    const long long i = lo + (lane + 1) * m / 33;  // in [lo, hi)
    const unsigned below = __ballot_sync(0xffffffffu, a[i] <= b[diag - 1 - i]);
    const int c = __popc(below);  // the probes below the split come first
    const long long last = __shfl_sync(0xffffffffu, i, c > 0 ? c - 1 : 0);
    const long long next = __shfl_sync(0xffffffffu, i, c < 32 ? c : 31);
    if (c > 0) lo = last + 1;
    if (c < 32) hi = next;
  }
  const long long i = lo + lane;
  const bool p = i < hi && a[i] <= b[diag - 1 - i];
  return lo + __popc(__ballot_sync(0xffffffffu, p));
}

// One tile of kMergeTile outputs of the kept half per block: warps 0 and 1
// find where the tile's first and last diagonals cross a and b, the block
// loads the tile's a and b ranges into shared memory coalesced, each thread
// merges kItems outputs there (its own split by a binary search in shared
// memory), and the block stores the tile coalesced.
__global__ void __launch_bounds__(kMergeThreads)
merge_split_kernel(const long long* __restrict__ a,
                   const long long* __restrict__ b, long long L, int keep_high,
                   long long* __restrict__ out) {
  __shared__ long long tile[kMergeTile];
  __shared__ long long split[2];
  const long long first = (long long)blockIdx.x * kMergeTile;
  const int count = (int)(L - first < kMergeTile ? L - first : kMergeTile);
  const long long diag = first + (keep_high ? L : 0);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long s = warp_split(a, L, b, L, diag + (warp ? count : 0));
    if ((threadIdx.x & 31) == 0) split[warp] = s;
  }
  __syncthreads();
  const long long a0 = split[0], b0 = diag - a0;
  const int na = (int)(split[1] - a0), nb = count - na;
  for (int t = threadIdx.x; t < count; t += kMergeThreads) {
    tile[t] = t < na ? a[a0 + t] : b[b0 + (t - na)];
  }
  __syncthreads();
  // outputs [d, d + n) of the tile's merge of tile[0, na) and tile[na, count)
  const int d = threadIdx.x * kItems;
  const int n = count - d < kItems ? count - d : kItems;
  long long v[kItems];
  if (n > 0) {
    int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tile[mid] <= tile[na + d - 1 - mid]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int i = lo, j = d - lo;
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      if (t < n) {
        const bool take_a = j >= nb || (i < na && tile[i] <= tile[na + j]);
        v[t] = take_a ? tile[i++] : tile[na + j++];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    if (t < n) tile[d + t] = v[t];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < count; t += kMergeThreads) {
    out[first + t] = tile[t];
  }
}

long long sort_tiles(long long n) { return (n + kTileKeys - 1) / kTileKeys; }

}  // namespace

// 64-bit words of the state mesh_sort_launch takes for n keys.
extern "C" long long mesh_sort_state_words(long long n) {
  return kLookbackAt + kPasses * sort_tiles(n) * kDigits;
}

// in, out, tmp: int64 [n], n >= 1; state: 64-bit words
// [mesh_sort_state_words(n)] scratch, zeroed here.  The sorted keys land in
// out; in is only read.  Returns the cudaError_t of the launches.
extern "C" int mesh_sort_launch(const long long* in, long long* out,
                                long long* tmp, Word* state, long long n,
                                void* stream) {
  if (n < 1 || tmp == nullptr || state == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      state, 0, sizeof(Word) * (size_t)mesh_sort_state_words(n), s);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const long long units = (n + 1) / 2;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  histogram_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(in, n, state);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long tiles = sort_tiles(n);
  for (int pass = 0; pass < kPasses; ++pass) {
    scatter_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(in, out, tmp, n, pass,
                                                        state, tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// a, b: int64 [L], each sorted ascending; out: int64 [L] receives outputs
// [0, L) of their merge, or [L, 2L) when keep_high.  Returns the
// cudaError_t of the launch.
extern "C" int mesh_merge_split_launch(const long long* a, const long long* b,
                                       long long L, int keep_high,
                                       long long* out, void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((L + kMergeTile - 1) / kMergeTile);
  merge_split_kernel<<<blocks, kMergeThreads, 0, s>>>(a, b, L, keep_high, out);
  return (int)cudaGetLastError();
}
