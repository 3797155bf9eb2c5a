// Bounded multi-source shortest paths at any capacity, degree and bound:
// the search stage's wide kernel.
//
// Replaces, beside csrc/sssp_pool.cu, the modes of
// matchtigs_tpu/ops/sssp.py that the register kernel cannot take:
// _pool_impl / _sssp_run_pool (K2) at a capacity C outside the compiled
// set, over an adjacency with more than four slots per row or the
// unpacked (nbr, nw) pair, with unpacked (nodes, dist) rows; and the batch
// schedule _sssp_kernel / _run_batches_impl / _sssp_run_batches (K3).  It
// computes the stage's contract, not the reference's relaxation rounds:
//
//   * a source's ball is every node at distance <= max_weight, the source
//     itself at 0 included; the sentinel source has an empty ball;
//   * if the ball has at most C nodes, row i holds exactly the ball sorted
//     by (dist, node): packed as (node << 7) | dist with empty slots
//     (sentinel << 7) | 127, or unpacked as nodes / dist with empty slots
//     (sentinel, INF = 1 << 20); overflow[i] = 0;
//   * otherwise overflow[i] = 1 and the row holds empty slots.
//
// Design: one thread block per source.  The pool schedule takes sources
// from an atomicAdd cursor (a block that finishes a small ball starts the
// next at once); the batch schedule gives block b the sources b, b + grid,
// b + 2 grid, ... (a launch argument, not a second kernel).  Edge weights
// are >= 1 and distances are small integers, so the ball grows level by
// level (Dial's order): at level d the block expands, in parallel over
// (entry, slot) pairs, every unsettled entry whose distance is d; a level
// never lowers an entry below d + 1, so those entries are final.  Members
// live in an open-addressing hash set (atomicCAS on the node, atomicMin on
// the distance); the unsettled entries, the fringe, live in a list that
// each level partitions.  The (C+1)-th insertion proves the overflow and
// stops the source.  Per source the work is one pass over the hash table
// to clear it, O(sum over levels of the fringe) for the level scans,
// O(ball x deg) for the expansion and a bitonic sort of the ball's 64-bit
// (dist << 32 | node) keys, so the row is deterministic whatever the order
// of the atomics.
//
// What bounds it: the dependent random loads of adjacency rows, one per
// expanded (entry, slot) pair, and the block barriers between levels.  The
// working set (hash table, keys, fringe lists: about 8C + 12C bytes) lives
// in dynamic shared memory while it fits; beyond that in one global slab
// per resident block, allocated by the caller once per launch.  The block
// is as wide as C up to 256 threads, so small capacities still fill an SM
// with many blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (a plain C ABI, loaded with ctypes).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kDistBits = 7;
constexpr int kDistCap = (1 << kDistBits) - 1;  // packed empty-slot distance
constexpr int kInf = 1 << 20;                   // unpacked empty-slot distance
constexpr int kEmpty = -1;                      // free hash slot
constexpr int kMaxBlock = 256;
constexpr int kMaxCapacity = 1 << 20;
constexpr size_t kSharedLimit = 200 * 1024;           // dynamic shared bytes
constexpr size_t kScratchLimit = (size_t)4 << 30;     // global slab bytes

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Working-set layout of one block, in int32 words: hash nodes [H], hash
// distances [H], sort keys [Cp] (64-bit), fringe lists [C] x 3; the total
// is a multiple of four words, so every slab keeps the keys 16-byte
// aligned.
struct Layout {
  int H, Cp;
  size_t ints;
};

__host__ __device__ inline Layout layout(int C) {
  Layout l;
  l.H = next_pow2(2 * C);
  l.Cp = next_pow2(C);
  l.ints = (2 * (size_t)l.H + 2 * (size_t)l.Cp + 3 * (size_t)C + 3) & ~(size_t)3;
  return l;
}

struct Params {
  const int* adj;  // packed [N+1, deg] when nw is null, else nbr
  const int* nw;   // weights [N+1, deg], or null
  int sentinel;
  int deg;
  const int* sources;
  int n_sources;
  int max_weight;
  int capacity;
  int* out_a;         // packed rows, or nodes
  int* out_b;         // dist (unpacked rows), or null for packed rows
  uint8_t* overflow;
  int* cursor;        // pool schedule; null = batch schedule
  int* scratch;       // per-block slabs; null = dynamic shared memory
  long long slab_ints;
};

__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

struct Shared {
  int i, count, over, n_fringe, n_next, n_front, dmin;
};

// Insert v at distance nd, or lower its distance.  A new member is
// appended to the next fringe; the (C+1)-th member sets the overflow.
__device__ __forceinline__ void insert(int v, int nd, int* hnode, int* hdist,
                                       int mask, int C, int* next,
                                       Shared* s) {
  unsigned h = mix((unsigned)v) & mask;
  for (int probe = 0; probe <= mask; ++probe) {
    const int cur = *(volatile int*)&hnode[h];
    if (cur == v) {
      atomicMin(&hdist[h], nd);
      return;
    }
    if (cur == kEmpty) {
      const int old = atomicCAS(&hnode[h], kEmpty, v);
      if (old == kEmpty) {
        atomicMin(&hdist[h], nd);
        if (atomicAdd(&s->count, 1) >= C) {
          *(volatile int*)&s->over = 1;
          return;
        }
        next[atomicAdd(&s->n_next, 1)] = (int)h;
        return;
      }
      if (old == v) {
        atomicMin(&hdist[h], nd);
        return;
      }
    }
    if (*(volatile int*)&s->over) return;
    h = (h + 1) & mask;
  }
  *(volatile int*)&s->over = 1;  // table full: only after an overflow
}

__device__ void bitonic_sort(unsigned long long* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int x = t ^ j;
        if (x > t) {
          const unsigned long long a = keys[t], b = keys[x];
          if ((a > b) == ((t & k) == 0)) {
            keys[t] = b;
            keys[x] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kMaxBlock) sssp_wide_kernel(Params p) {
  extern __shared__ __align__(16) int smem[];
  __shared__ Shared s;
  const int C = p.capacity;
  const Layout L = layout(C);
  const int mask = L.H - 1;
  const int tid = threadIdx.x, bd = blockDim.x;
  int* ws = p.scratch ? p.scratch + (size_t)blockIdx.x * p.slab_ints : smem;
  int* hnode = ws;
  int* hdist = hnode + L.H;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(hdist + L.H);
  int* list_a = reinterpret_cast<int*>(keys + L.Cp);
  int* list_b = list_a + C;
  int* front = list_b + C;

  for (int round = 0;; ++round) {
    if (tid == 0) {
      s.i = p.cursor ? atomicAdd(p.cursor, 1) : blockIdx.x + round * gridDim.x;
    }
    __syncthreads();
    const int i = s.i;
    if (i >= p.n_sources) return;
    const int src = p.sources[i];
    const bool real = src >= 0 && src < p.sentinel;
    for (int t = tid; t < L.H; t += bd) {
      hnode[t] = kEmpty;
      hdist[t] = INT_MAX;
    }
    if (tid == 0) {
      // an id outside [0, sentinel] is flagged instead of read
      s.over = !real && src != p.sentinel;
      s.count = 0;
      s.n_fringe = 0;
    }
    __syncthreads();
    if (tid == 0 && real) {
      const int h = mix((unsigned)src) & mask;
      hnode[h] = src;
      hdist[h] = 0;
      list_a[0] = h;
      s.count = 1;
      s.n_fringe = 1;
    }
    int* fringe = list_a;
    int* next = list_b;
    for (;;) {
      __syncthreads();
      const int nf = s.n_fringe;
      if (nf == 0 || s.over) break;
      if (tid == 0) {
        s.dmin = INT_MAX;
        s.n_front = 0;
        s.n_next = 0;
      }
      __syncthreads();
      // the level: least distance on the fringe
      int m = INT_MAX;
      for (int u = tid; u < nf; u += bd) m = min(m, hdist[fringe[u]]);
      for (int o = 16; o > 0; o >>= 1) {
        m = min(m, __shfl_down_sync(0xffffffffu, m, o));
      }
      if ((tid & 31) == 0) atomicMin(&s.dmin, m);
      __syncthreads();
      const int d = s.dmin;
      // split the fringe: entries at d are final and expand now
      for (int u = tid; u < nf; u += bd) {
        const int h = fringe[u];
        if (hdist[h] == d) {
          front[atomicAdd(&s.n_front, 1)] = h;
        } else {
          next[atomicAdd(&s.n_next, 1)] = h;
        }
      }
      __syncthreads();
      const long long work = (long long)s.n_front * p.deg;
      for (long long q = tid; q < work; q += bd) {
        if (*(volatile int*)&s.over) break;
        const int u = hnode[front[q / p.deg]];
        const size_t off = (size_t)u * p.deg + (size_t)(q % p.deg);
        int v, w;
        if (p.nw) {
          v = __ldg(p.adj + off);
          w = __ldg(p.nw + off);
        } else {
          const int a = __ldg(p.adj + off);
          v = a >> kDistBits;
          w = a & kDistCap;
        }
        if (v == p.sentinel || w > p.max_weight - d) continue;
        insert(v, d + w, hnode, hdist, mask, C, next, &s);
      }
      __syncthreads();
      if (tid == 0) s.n_fringe = s.n_next;
      int* t = fringe;
      fringe = next;
      next = t;
    }

    __syncthreads();
    const bool over = s.over;
    const int n = over ? 0 : s.count;
    if (n > 0) {
      if (tid == 0) s.n_front = 0;
      __syncthreads();
      for (int t = tid; t < L.H; t += bd) {
        const int v = hnode[t];
        if (v != kEmpty) {
          keys[atomicAdd(&s.n_front, 1)] =
              ((unsigned long long)(unsigned)hdist[t] << 32) | (unsigned)v;
        }
      }
      const int np2 = next_pow2(n);
      for (int t = n + tid; t < np2; t += bd) keys[t] = ~0ull;
      __syncthreads();
      bitonic_sort(keys, np2);
    }
    const size_t row = (size_t)i * C;
    for (int t = tid; t < C; t += bd) {
      int node = p.sentinel, dist = -1;
      if (t < n) {
        node = (int)(keys[t] & 0xffffffffu);
        dist = (int)(keys[t] >> 32);
      }
      if (p.out_b) {
        p.out_a[row + t] = node;
        p.out_b[row + t] = dist < 0 ? kInf : dist;
      } else {
        p.out_a[row + t] = (node << kDistBits) | (dist < 0 ? kDistCap : dist);
      }
    }
    if (tid == 0) p.overflow[i] = over ? 1 : 0;
  }
}

}  // namespace

// Launch shape for `capacity` and `n_sources`: grid and block size, the
// dynamic shared bytes, and the global slab per block in int32 words (0
// when the working set fits shared memory; the caller then allocates
// grid * slab_ints words of scratch).  Returns a cudaError_t.
extern "C" int sssp_wide_plan(int capacity, int n_sources, int* grid,
                              int* block, long long* smem_bytes,
                              long long* slab_ints) {
  if (capacity < 1 || capacity > kMaxCapacity) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = layout(capacity);
  const size_t bytes = L.ints * sizeof(int);
  const bool shared = bytes <= kSharedLimit;
  const int want = next_pow2(capacity);
  const int bs = want < 32 ? 32 : (want > kMaxBlock ? kMaxBlock : want);
  const size_t smem = shared ? bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sssp_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sssp_wide_kernel, bs, smem);
  if (e != cudaSuccess) return (int)e;
  long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (!shared) {
    const long long cap = (long long)(kScratchLimit / bytes);
    if (g > cap) g = cap;
  }
  if (g > n_sources) g = n_sources;
  if (g < 1) g = 1;
  *grid = (int)g;
  *block = bs;
  *smem_bytes = (long long)smem;
  *slab_ints = shared ? 0 : (long long)L.ints;
  return 0;
}

// adj: int32 [n_nodes + 1, deg], packed (neighbor << 7 | min(weight, 127))
// when nw is null, else the neighbor ids with nw the int32 weights; row
// n_nodes is the sentinel row.  sources: int32 [n_sources] in
// [0, n_nodes].  out_a: int32 [n_sources, capacity] packed rows, or the
// nodes with out_b the distances (out_b null = packed rows).  overflow:
// uint8 [n_sources].  cursor: one int32, zero on entry, for the pool
// schedule; null runs the batch schedule.  grid, block, smem_bytes and
// slab_ints come from sssp_wide_plan; scratch holds grid * slab_ints
// int32 words when slab_ints > 0.  Returns the launch's cudaError_t.
extern "C" int sssp_wide_launch(const int* adj, const int* nw, int n_nodes,
                                int deg, const int* sources, int n_sources,
                                int max_weight, int capacity, int* out_a,
                                int* out_b, uint8_t* overflow, int* cursor,
                                int* scratch, int grid, int block,
                                long long smem_bytes, long long slab_ints,
                                void* stream) {
  if (capacity < 1 || capacity > kMaxCapacity || deg < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sssp_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  Params p;
  p.adj = adj;
  p.nw = nw;
  p.sentinel = n_nodes;
  p.deg = deg;
  p.sources = sources;
  p.n_sources = n_sources;
  p.max_weight = max_weight;
  p.capacity = capacity;
  p.out_a = out_a;
  p.out_b = out_b;
  p.overflow = overflow;
  p.cursor = cursor;
  p.scratch = slab_ints > 0 ? scratch : nullptr;
  p.slab_ints = slab_ints;
  sssp_wide_kernel<<<grid, block, (size_t)smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
