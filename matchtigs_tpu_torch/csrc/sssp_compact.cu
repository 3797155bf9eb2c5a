// Valid-slot compaction of a packed search stage: the stage's compact
// download.
//
// Replaces matchtigs_tpu/ops/sssp.py:_sssp_run_pool_compact (K4), which
// filters the packed rows on the device and compacts the survivors in
// row-major order by one two-key sort over an int32 flat-position key
// with an invalid bit at 2^30 (a key that overflows once (S+1) * C
// reaches 2^30).  Here the same output comes from counts and a prefix sum,
// with int64 positions:
//
//   * a slot is valid when its node is not the sentinel, 1 <= dist <=
//     max_weight, and its row did not overflow;
//   * counts[r] is row r's number of valid slots (int8 when C <= 127, else
//     int32), total their sum (int64);
//   * the valid values, in row-major order, fill out[0, min(total,
//     budget)); values past the budget are dropped (the caller then
//     fetches the full rows).
//
// Three launches: (1) one thread per row counts its valid slots and a
// block scan turns the counts into row offsets inside the block plus the
// block's sum; (2) one block scans the block sums into int64 block
// offsets and the total; (3) one thread per row writes its valid values at
// block offset + row offset.  The scans are warp shuffles and one shared
// array per block.  What bounds it: reading the [S, C] rows twice and
// writing the survivors; at C = 4 that is 16 bytes per row each pass.
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

__device__ __forceinline__ bool valid_slot(int key, int sentinel,
                                           int max_weight) {
  const int node = key >> kDistBits, dist = key & kDistCap;
  return node != sentinel && dist >= 1 && dist <= max_weight;
}

// Exclusive scan of x over the block; *total receives the block's sum.
template <typename T>
__device__ T block_exclusive_scan(T x, T* total) {
  __shared__ T warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T v = x;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_sum[lane] : T(0);
    for (int o = 1; o < kWarps; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sum[lane] = w;
  }
  __syncthreads();
  const T excl = v - x + (warp > 0 ? warp_sum[warp - 1] : T(0));
  *total = warp_sum[kWarps - 1];
  __syncthreads();  // warp_sum is reused by the next call
  return excl;
}

__global__ void __launch_bounds__(kBlock)
count_kernel(const int* __restrict__ rows, const uint8_t* __restrict__ over,
             int n_rows, int C, int sentinel, int max_weight,
             void* counts, int counts_int8, int* __restrict__ row_off,
             long long* __restrict__ block_sum) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  int c = 0;
  if (r < n_rows && !over[r]) {
    const int* row = rows + (size_t)r * C;
    for (int t = 0; t < C; ++t) c += valid_slot(row[t], sentinel, max_weight);
  }
  int sum;
  const int excl = block_exclusive_scan<int>(c, &sum);
  if (r < n_rows) {
    row_off[r] = excl;
    if (counts_int8) {
      static_cast<int8_t*>(counts)[r] = (int8_t)c;
    } else {
      static_cast<int*>(counts)[r] = c;
    }
  }
  if (threadIdx.x == 0) block_sum[blockIdx.x] = sum;
}

// One block: block_sum becomes the exclusive int64 block offsets.
__global__ void __launch_bounds__(kBlock)
scan_blocks_kernel(long long* __restrict__ block_sum, int n_blocks,
                   long long* __restrict__ total) {
  long long carry = 0;
  for (int base = 0; base < n_blocks; base += kBlock) {
    const int b = base + threadIdx.x;
    const long long x = b < n_blocks ? block_sum[b] : 0;
    long long sum;
    const long long excl = block_exclusive_scan<long long>(x, &sum);
    if (b < n_blocks) block_sum[b] = carry + excl;
    carry += sum;
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(kBlock)
scatter_kernel(const int* __restrict__ rows, const uint8_t* __restrict__ over,
               int n_rows, int C, int sentinel, int max_weight,
               const int* __restrict__ row_off,
               const long long* __restrict__ block_off, long long budget,
               int* __restrict__ out) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= n_rows || over[r]) return;
  long long pos = block_off[blockIdx.x] + row_off[r];
  const int* row = rows + (size_t)r * C;
  for (int t = 0; t < C && pos < budget; ++t) {
    const int key = row[t];
    if (valid_slot(key, sentinel, max_weight)) out[pos++] = key;
  }
}

}  // namespace

// rows: int32 [n_rows, C] packed search rows; over: uint8 [n_rows].
// counts: int8 [n_rows] when counts_int8, else int32 [n_rows].  row_off:
// int32 [n_rows] scratch; block_sum: int64 [ceil(n_rows / 256)] scratch;
// total: one int64.  out: int32 [budget].  Returns the cudaError_t of the
// launches.
extern "C" int sssp_compact_launch(const int* rows, const uint8_t* over,
                                   int n_rows, int C, int sentinel,
                                   int max_weight, long long budget,
                                   int* out, void* counts, int counts_int8,
                                   int* row_off, long long* block_sum,
                                   long long* total, void* stream) {
  if (n_rows < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = (n_rows + kBlock - 1) / kBlock;
  count_kernel<<<n_blocks, kBlock, 0, s>>>(rows, over, n_rows, C, sentinel,
                                           max_weight, counts, counts_int8,
                                           row_off, block_sum);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_blocks_kernel<<<1, kBlock, 0, s>>>(block_sum, n_blocks, total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_kernel<<<n_blocks, kBlock, 0, s>>>(rows, over, n_rows, C, sentinel,
                                             max_weight, row_off, block_sum,
                                             budget, out);
  return (int)cudaGetLastError();
}
