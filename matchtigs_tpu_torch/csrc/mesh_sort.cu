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
//   * mesh_sort_launch sorts n keys ascending.  Each block sorts a tile of
//     kTile keys in shared memory with a bitonic network (the tile is
//     padded with INT64_MAX, which sorts to its tail and is never written
//     back), then ceil(log2(n / kTile)) passes of one merge-path kernel
//     double the sorted runs: every thread binary-searches where its
//     diagonal of kItems outputs crosses the two runs, then merges its
//     outputs sequentially.  The passes alternate between out and tmp,
//     starting from the one that makes the last pass land in out.
//   * mesh_merge_split_launch merges two sorted blocks of L keys and
//     writes only the outputs [0, L) or [L, 2L): the same merge-path
//     kernel, restricted to one half of the diagonals.
//
// Equal keys are interchangeable (the sort holds keys only), so neither
// part needs to be stable.  What bounds it: bytes.  The least work reads
// and writes every key once (16 bytes per key); the tile sort does that
// once and each merge pass once more, with the merge's reads of the two
// runs only partly coalesced.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (a plain C ABI, loaded with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;          // keys per tile: 16 KB of shared memory
constexpr int kSortThreads = 1024;
constexpr int kItems = 8;            // outputs per merge thread
constexpr int kMergeThreads = 256;
constexpr long long kSpan = (long long)kMergeThreads * kItems;
constexpr long long kMaxKey = 0x7fffffffffffffffLL;

__global__ void __launch_bounds__(kSortThreads)
tile_sort_kernel(const long long* __restrict__ in, long long* __restrict__ out,
                 long long n) {
  __shared__ long long s[kTile];
  const long long base = (long long)blockIdx.x * kTile;
  for (int t = threadIdx.x; t < kTile; t += kSortThreads) {
    const long long i = base + t;
    s[t] = i < n ? in[i] : kMaxKey;
  }
  __syncthreads();
  for (int k = 2; k <= kTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < kTile; t += kSortThreads) {
        const int x = t ^ j;
        if (x > t) {
          const long long a = s[t], b = s[x];
          if ((a > b) == ((t & k) == 0)) {
            s[t] = b;
            s[x] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < kTile; t += kSortThreads) {
    const long long i = base + t;
    if (i < n) out[i] = s[t];
  }
}

// Writes outputs [diag, diag + count) of the merge of sorted a[0, la) and
// b[0, lb) to out[0, count).  The split point is the number of a's keys
// among the first diag outputs (a's keys first on ties).
__device__ __forceinline__ void merge_items(const long long* __restrict__ a,
                                            long long la,
                                            const long long* __restrict__ b,
                                            long long lb, long long diag,
                                            int count,
                                            long long* __restrict__ out) {
  long long lo = diag > lb ? diag - lb : 0, hi = diag < la ? diag : la;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= b[diag - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  long long i = lo, j = diag - lo;
  for (int t = 0; t < count; ++t) {
    const bool take_a = j >= lb || (i < la && a[i] <= b[j]);
    out[t] = take_a ? a[i++] : b[j++];
  }
}

// One merge pass: runs of `width` sorted keys, pairwise merged into runs of
// 2 * width.  width is a multiple of kItems, so no thread's outputs cross
// two pairs.
__global__ void __launch_bounds__(kMergeThreads)
merge_pass_kernel(const long long* __restrict__ src, long long* __restrict__ dst,
                  long long n, long long width) {
  const long long first =
      ((long long)blockIdx.x * kMergeThreads + threadIdx.x) * kItems;
  if (first >= n) return;
  const long long base = first / (2 * width) * (2 * width);
  const long long la = width < n - base ? width : n - base;
  const long long rest = n - base - la;
  const long long lb = width < rest ? width : rest;
  const long long left = n - first;
  merge_items(src + base, la, src + base + la, lb, first - base,
              left < kItems ? (int)left : kItems, dst + first);
}

__global__ void __launch_bounds__(kMergeThreads)
merge_split_kernel(const long long* __restrict__ a,
                   const long long* __restrict__ b, long long L, int keep_high,
                   long long* __restrict__ out) {
  const long long first =
      ((long long)blockIdx.x * kMergeThreads + threadIdx.x) * kItems;
  if (first >= L) return;
  const long long left = L - first;
  merge_items(a, L, b, L, first + (keep_high ? L : 0),
              left < kItems ? (int)left : kItems, out + first);
}

}  // namespace

// in, out: int64 [n]; tmp: int64 [n] scratch (unused when n <= 2048).  The
// sorted keys land in out.  Returns the cudaError_t of the launches.
extern "C" int mesh_sort_launch(const long long* in, long long* out,
                                long long* tmp, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int passes = 0;
  for (long long w = kTile; w < n; w <<= 1) ++passes;
  if (passes > 0 && tmp == nullptr) return (int)cudaErrorInvalidValue;
  long long* src = (passes & 1) ? tmp : out;
  long long* dst = (passes & 1) ? out : tmp;
  const long long tiles = (n + kTile - 1) / kTile;
  tile_sort_kernel<<<(unsigned)tiles, kSortThreads, 0, s>>>(in, src, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((n + kSpan - 1) / kSpan);
  for (long long w = kTile; w < n; w <<= 1) {
    merge_pass_kernel<<<blocks, kMergeThreads, 0, s>>>(src, dst, n, w);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    long long* t = src;
    src = dst;
    dst = t;
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
  const unsigned blocks = (unsigned)((L + kSpan - 1) / kSpan);
  merge_split_kernel<<<blocks, kMergeThreads, 0, s>>>(a, b, L, keep_high, out);
  return (int)cudaGetLastError();
}
