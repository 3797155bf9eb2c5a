// Bounded multi-source shortest paths: the greedy-matchtig search stage.
//
// Replaces matchtigs_tpu/ops/sssp.py:_relax_round + _pool_impl (the
// persistent-pool scheduler that runs bounded Bellman-Ford rounds over a
// [P, C] working set with two sorts per round).  The kernel computes the
// stage's output contract directly instead of replaying the rounds:
//
//   * a source's ball is every node at distance <= max_weight, the source
//     itself at 0 included;
//   * if the ball has at most C nodes, row i holds exactly the ball as
//     (node << 7) | dist, sorted by (dist, node), empty slots
//     (sentinel << 7) | 127, and overflow[i] = 0;
//   * otherwise overflow[i] = 1 and the row's contents are unspecified
//     (the caller finishes those sources on the host).
//
// Edge weights are >= 1, so one exact Dijkstra per source over a working
// set of at most C entries meets the contract: every node it discovers
// with a tentative distance <= max_weight lies in the ball, so discovering
// a (C+1)-th distinct one proves the overflow, and it expands each ball
// node exactly once.
//
// What bounds it: one dependent, random 16-byte adjacency row load per
// expanded node (the packed [N+1, 4] int32 adjacency, neighbor << 7 |
// min(weight, 127)); the arithmetic is a few compares per slot.  Its
// design against that:
//
//   * one thread per source, assigned statically (thread i takes source
//     i): no cursor to claim from and nothing to zero before the launch;
//     the hardware's block scheduler starts a new block wherever one
//     finishes, which balances the small balls of these capacities;
//   * the working set is one register array of C keys, dist << 24 | node
//     (node < 2^24, the packed-output precondition), empty slots
//     (127 << 24) | sentinel, and a bit mask of the settled entries: the
//     next entry to expand is the least unsettled key (C unsigned mins), a
//     relaxation is one compare and one min per entry, and the final row
//     order is the keys' order, so a bitonic network over the C registers
//     sorts them (all indexing is over compile-time C, so the array never
//     leaves the registers);
//   * C in {4, 8, 16, 32}: at C = 64 one thread per source is several
//     times slower than the wide kernel's warp per source (a warp runs as
//     long as its largest ball, and every step scans all C registers;
//     PERF.md), so ops/sssp.py sends C = 64 there;
//   * one vectorized int4 load per row through the read-only path, and the
//     row written as C/4 int4 stores, so a warp's stores are contiguous;
//   * the launch queries nothing: the grid is ceil(S / 256) blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (a plain C ABI, loaded with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDistBits = 7;
constexpr unsigned kDistCap = (1u << kDistBits) - 1;  // empty-slot distance
constexpr int kNodeBits = 24;
constexpr unsigned kNodeMask = (1u << kNodeBits) - 1;
constexpr int kBlock = 256;

template <int C>
__global__ void __launch_bounds__(kBlock)
sssp_pool_kernel(const int4* __restrict__ adj, int sentinel,
                 const int* __restrict__ sources, int n_sources,
                 int max_weight, int* __restrict__ out,
                 uint8_t* __restrict__ overflow) {
  static_assert(C >= 4 && C <= 32 && (C & (C - 1)) == 0,
                "C is a power of two in [4, 32]");
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_sources) return;
  const int src = __ldg(sources + i);
  // an empty slot's key is above every real key (dist <= max_weight < 126)
  const unsigned empty = (kDistCap << kNodeBits) | (unsigned)sentinel;
  unsigned key[C];
#pragma unroll
  for (int t = 0; t < C; ++t) key[t] = empty;
  // the sentinel source has an empty ball; an id outside [0, sentinel]
  // is flagged instead of read
  const bool real = src >= 0 && src < sentinel;
  bool over = !real && src != sentinel;
  int n = 0;
  if (real) {
    key[0] = (unsigned)src;  // dist 0
    n = 1;
  }
  unsigned settled = 0;  // bit t: entry t expanded

  while (!over) {
    // the unsettled entry of least (dist, node)
    unsigned best = empty;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      best = min(best, (settled >> t) & 1u ? empty : key[t]);
    }
    if (best == empty) break;
#pragma unroll
    for (int t = 0; t < C; ++t) settled |= (key[t] == best ? 1u : 0u) << t;
    const int bd = (int)(best >> kNodeBits);
    const int4 row = __ldg(adj + (best & kNodeMask));
    const int slots[4] = {row.x, row.y, row.z, row.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = slots[j] >> kDistBits;
      const int nd = bd + (slots[j] & (int)kDistCap);
      if (v == sentinel || nd > max_weight) continue;
      const unsigned nk = ((unsigned)nd << kNodeBits) | (unsigned)v;
      // the entry of node v keeps the lesser key (a settled entry holds
      // dist <= bd <= nd, so it is never lowered)
      bool found = false;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const bool same = ((key[t] ^ (unsigned)v) & kNodeMask) == 0;
        found |= same;
        key[t] = min(key[t], same ? nk : ~0u);
      }
      if (found) continue;
      if (n == C) {
        over = true;
        break;
      }
#pragma unroll
      for (int t = 0; t < C; ++t) key[t] = t == n ? nk : key[t];
      ++n;
    }
  }

  // (dist, node) order is the keys' order: a bitonic network over the
  // registers
#pragma unroll
  for (int size = 2; size <= C; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const int p = t ^ stride;
        if (p > t) {
          const unsigned a = key[t], b = key[p];
          const bool up = (t & size) == 0;
          key[t] = up ? min(a, b) : max(a, b);
          key[p] = up ? max(a, b) : min(a, b);
        }
      }
    }
  }
  int4* row_out = reinterpret_cast<int4*>(out + (size_t)i * C);
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    int w[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const unsigned x = key[4 * q + t];
      w[t] = (int)(((x & kNodeMask) << kDistBits) | (x >> kNodeBits));
    }
    row_out[q] = make_int4(w[0], w[1], w[2], w[3]);
  }
  overflow[i] = over ? 1 : 0;
}

template <int C>
int launch(const int* adj, int n_nodes, const int* sources, int n_sources,
           int max_weight, int* out, uint8_t* overflow, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n_sources + kBlock - 1) / kBlock);
  sssp_pool_kernel<C><<<grid, kBlock, 0, stream>>>(
      reinterpret_cast<const int4*>(adj), n_nodes, sources, n_sources,
      max_weight, out, overflow);
  return (int)cudaGetLastError();
}

template <int C>
int attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, sssp_pool_kernel<C>);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)e;
}

}  // namespace

// adj: int32 [n_nodes + 1, 4] packed adjacency (row n_nodes = sentinel);
// sources: int32 [n_sources] in [0, n_nodes], n_sources >= 1; out: int32
// [n_sources, C], 16-byte aligned; overflow: uint8 [n_sources].  The launch
// goes to `device` on `stream`, whatever device the calling thread has
// current.  Returns the cudaError_t of the launch (0 = success); an
// unsupported capacity returns cudaErrorInvalidValue without launching.
extern "C" int sssp_pool_launch(const int* adj, int n_nodes,
                                const int* sources, int n_sources,
                                int max_weight, int capacity, int* out,
                                uint8_t* overflow, int device, void* stream) {
  int current = device;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (capacity) {
    case 4:
      err = launch<4>(adj, n_nodes, sources, n_sources, max_weight, out,
                      overflow, s);
      break;
    case 8:
      err = launch<8>(adj, n_nodes, sources, n_sources, max_weight, out,
                      overflow, s);
      break;
    case 16:
      err = launch<16>(adj, n_nodes, sources, n_sources, max_weight, out,
                       overflow, s);
      break;
    case 32:
      err = launch<32>(adj, n_nodes, sources, n_sources, max_weight, out,
                       overflow, s);
      break;
    default:
      err = (int)cudaErrorInvalidValue;
  }
  if (current != device) cudaSetDevice(current);
  return err;
}

// Registers per thread and local (spilled) bytes per thread of the kernel
// at `capacity`, from cudaFuncGetAttributes.  Returns the cudaError_t.
extern "C" int sssp_pool_attributes(int capacity, int* regs, int* local_bytes) {
  switch (capacity) {
    case 4: return attributes<4>(regs, local_bytes);
    case 8: return attributes<8>(regs, local_bytes);
    case 16: return attributes<16>(regs, local_bytes);
    case 32: return attributes<32>(regs, local_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}
