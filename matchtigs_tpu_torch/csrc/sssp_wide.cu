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
// Search: edge weights are >= 1 and distances are small integers, so a
// ball grows level by level (Dial's order).  Members live in an
// open-addressing hash set (atomicCAS on the node, atomicMin on the
// distance) and, in insertion order, in a member list.  Every member at a
// distance above the last expanded level d is unsettled, so a level needs
// no fringe list: one pass over the members from the first unsettled one
// gathers those at d (final, since a level never lowers an entry below
// d + 1) and notes the least distance of the rest; the group expands the
// gathered (entry, slot) pairs in parallel, noting the least distance each
// insertion set; two warp min-reductions then give the next level and the
// new first unsettled member.  That is two group barriers per level.  The
// (limit+1)-th insertion stops the source.  The row is the members'
// 64-bit (dist << 32 | node) keys sorted, so it is the same whatever the
// order of the atomics; a source clears only the hash slots its members
// used (the whole table after an overflow).
//
// Two tiers, one launch each on the caller's stream, no host sync between:
//
//   * tier 1, one warp per source, eight warps per block, a working set of
//     W = 64 members (a 128-slot hash set, the member and level lists:
//     1.8 KB of shared memory per warp, so up to 64 warps per SM).  The
//     flagship's balls are mostly chains of 5-8 nodes, and 87% of those that
//     overflow C = 4 have at most 64 nodes.  Only __syncwarp and warp
//     intrinsics; the keys are sorted in registers: a ball of at most 32
//     nodes by rank (each lane counts the smaller keys over n shuffles), a
//     larger one by a bitonic network over shuffles, two keys per lane.
//     When C <= W this tier is final.  When C > W,
//     a ball that reaches W + 1 members is spilled: the warp appends the
//     source to a device list and writes nothing.
//   * tier 2 takes the spill list (its length is read on the card):
//     persistent blocks claim entries from it and redo each source with a
//     working set of C members (32C bytes): a block of one warp per 16 KB
//     of it (one warp up to C = 512, at most eight), in shared memory or,
//     beyond 200 KB, in a global slab per block.  Its keys are sorted by a
//     bitonic network in the working set.
//
// Only one tier writes a source's row and flag, and tier 2 writes every
// slot, so stream order alone makes the result right.  The pool schedule
// claims sources from an atomicAdd cursor; the batch schedule gives tier
// 1's warp w the sources w, w + warps, ... and tier 2's block b the spill
// entries b, b + grid, ... (a launch argument, not a second kernel).
//
// What bounds it: the dependent chain of levels, each waiting on an L2
// load of adjacency rows, and the per-source work besides (sort, row
// write).  The design answers it with many sources in flight: a warp per
// source instead of a block.
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
constexpr int kMaxCapacity = 1 << 20;
constexpr int kWarpTier = 64;                   // W: tier 1's members per source
constexpr int kWarpHash = 2 * kWarpTier;        // tier 1's hash slots
constexpr int kTier1Warps = 8;                  // warps per tier-1 block
constexpr int kTier2Block = 256;                // threads of the largest tier-2 block
constexpr size_t kWarpSet = 16 * 1024;          // tier 2's working set per warp
constexpr size_t kSharedLimit = 200 * 1024;     // dynamic shared bytes
constexpr size_t kScratchLimit = (size_t)4 << 30;  // global slab bytes
constexpr int kCounters = 4;  // tier-1 cursor, tier-2 cursor, spill count, pad
constexpr int kMaxDevices = 64;

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Tier 2's working set, in int32 words: hash nodes [H], hash distances
// [H], members [Cp], level list [Cp], sort keys [Cp] (64-bit); the total is
// a multiple of four words, so every slab keeps the keys 16-byte aligned.
struct Layout {
  int H, Cp;
  size_t ints;
};

__host__ __device__ inline Layout layout(int C) {
  Layout l;
  l.H = next_pow2(2 * C);
  l.Cp = next_pow2(C);
  l.ints = (2 * (size_t)l.H + 4 * (size_t)l.Cp + 3) & ~(size_t)3;
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
  bool pool;          // pool schedule (cursors), else batch (strides)
  int* counters;      // [kCounters], zero on entry
  int* spill;         // [n_sources] sources that tier 1 hands to tier 2
  int* slabs;         // tier 2's per-block slabs; null = shared memory
  long long slab_ints;
};

// What a group (a warp, or a block) shares about its current source.
// nf, dmin and lo are double-buffered by level parity, so resetting the
// next level's copy never races with reading this level's.
struct Ctl {
  int i, count, over, nf[2], dmin[2], lo[2];
};

__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

struct Warp {
  int rank, size;
  __device__ Warp() : rank(threadIdx.x & 31), size(32) {}
  __device__ void sync() const { __syncwarp(); }
  __device__ int min(int m, int*, int) const { return __reduce_min_sync(~0u, m); }
};

struct Block {
  int rank, size;
  __device__ Block() : rank(threadIdx.x), size(blockDim.x) {}
  __device__ void sync() const { __syncthreads(); }
  // the block's least m, through slot[level & 1] (INT_MAX on entry)
  __device__ int min(int m, int* slot, int level) const {
    m = __reduce_min_sync(~0u, m);
    if (size == 32) return m;
    if ((rank & 31) == 0) atomicMin(&slot[level & 1], m);
    __syncthreads();
    const int d = slot[level & 1];
    if (rank == 0) slot[(level + 1) & 1] = INT_MAX;
    return d;
  }
};

// The tables of one source's search.
struct Tables {
  int* hnode;    // [mask + 1]
  int* hdist;    // [mask + 1]
  int* members;  // [limit]: hash slots in insertion order
  int* level;    // [limit]: nodes of the level being expanded
  int mask;
};

// Insert v at distance nd, or lower its distance.  Returns nd if that
// set the entry's distance, else INT_MAX.  The (limit+1)-th member sets
// the overflow; a full table (only after that) does too.
__device__ __forceinline__ int insert(int v, int nd, const Tables& t,
                                      int limit, Ctl* c) {
  unsigned h = mix((unsigned)v) & t.mask;
  for (int probe = 0; probe <= t.mask; ++probe) {
    const int old = atomicCAS(&t.hnode[h], kEmpty, v);
    if (old == kEmpty || old == v) {
      const bool set = atomicMin(&t.hdist[h], nd) > nd;
      if (old == kEmpty) {
        const int idx = atomicAdd(&c->count, 1);
        if (idx < limit) {
          t.members[idx] = (int)h;
        } else {
          *(volatile int*)&c->over = 1;
        }
      }
      return set ? nd : INT_MAX;
    }
    if (*(volatile int*)&c->over) return INT_MAX;
    h = (h + 1) & t.mask;
  }
  *(volatile int*)&c->over = 1;
  return INT_MAX;
}

// Grow the ball of source i (group-uniform) into the tables, stopping at
// limit + 1 members.  Returns with the group synchronized; unless c->over
// says the ball passed the limit, its c->count members are listed.
template <class G>
__device__ void grow(const G& g, const Params& p, int i, const Tables& t,
                     int limit, Ctl* c) {
  const int src = p.sources[i];
  const bool real = src >= 0 && src < p.sentinel;
  if (g.rank == 0) {
    // an id outside [0, sentinel] is flagged instead of read
    c->over = !real && src != p.sentinel;
    c->count = real ? 1 : 0;
    c->nf[0] = c->nf[1] = 0;
    c->dmin[0] = c->dmin[1] = c->lo[0] = c->lo[1] = INT_MAX;
    if (real) {
      const int h = mix((unsigned)src) & t.mask;
      t.hnode[h] = src;
      t.hdist[h] = 0;
      t.members[0] = h;
    }
  }
  g.sync();
  int d = real ? 0 : INT_MAX;  // the level
  int lo = 0;                  // members before lo are settled
  for (int lv = 0; d != INT_MAX; ++lv) {
    const int n = c->count;
    if (c->over) return;
    int next = INT_MAX, first = INT_MAX;
    for (int j = lo + g.rank; j < n; j += g.size) {
      const int h = t.members[j];
      const int dj = t.hdist[h];
      if (dj == d) {
        t.level[atomicAdd(&c->nf[lv & 1], 1)] = t.hnode[h];
      } else if (dj > d) {
        next = min(next, dj);
        first = min(first, j);
      }
    }
    g.sync();
    const int nf = c->nf[lv & 1];
    if (g.rank == 0) c->nf[(lv + 1) & 1] = 0;
    const int work = nf * p.deg;
    for (int q = g.rank; q < work; q += g.size) {
      if (*(volatile int*)&c->over) break;
      const int e = q / p.deg;
      const size_t off = (size_t)t.level[e] * p.deg + (size_t)(q - e * p.deg);
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
      next = min(next, insert(v, d + w, t, limit, c));
    }
    g.sync();
    d = g.min(next, c->dmin, lv);
    first = g.min(first, c->lo, lv);
    lo = first == INT_MAX ? n : first;
  }
}

__device__ __forceinline__ unsigned long long member_key(const Tables& t, int j) {
  const int h = t.members[j];
  return ((unsigned long long)(unsigned)t.hdist[h] << 32) | (unsigned)t.hnode[h];
}

__device__ __forceinline__ void write_slot(const Params& p, size_t row, int s,
                                           unsigned long long key, bool valid) {
  const int node = valid ? (int)(key & 0xffffffffu) : p.sentinel;
  const int dist = (int)(key >> 32);
  if (p.out_b) {
    p.out_a[row + s] = node;
    p.out_b[row + s] = valid ? dist : kInf;
  } else {
    p.out_a[row + s] = (node << kDistBits) | (valid ? dist : kDistCap);
  }
}

// Clear the hash slots of the c->count members, or the whole table after
// an overflow (the group is synchronized).
template <class G>
__device__ void clear_tables(const G& g, const Tables& t, const Ctl* c) {
  const bool all = c->over;
  for (int j = g.rank; j < (all ? t.mask + 1 : c->count); j += g.size) {
    const int h = all ? j : t.members[j];
    t.hnode[h] = kEmpty;
    t.hdist[h] = INT_MAX;
  }
}

__device__ __forceinline__ unsigned long long exchange(unsigned long long x,
                                                       int t, int j, int k) {
  const unsigned long long y = __shfl_xor_sync(~0u, x, j);
  const bool up = (t & k) == 0, lower = (t & j) == 0;
  return (lower == up) ? (x < y ? x : y) : (x < y ? y : x);
}

// Ascending bitonic sort of the warp's 64 keys: slot lane in a, slot
// lane + 32 in b.
__device__ __forceinline__ void warp_sort64(unsigned long long& a,
                                            unsigned long long& b, int lane) {
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // k == 64: a and b are partners, ascending
        const unsigned long long lo = a < b ? a : b;
        b = a < b ? b : a;
        a = lo;
      } else {
        a = exchange(a, lane, j, k);
        b = exchange(b, lane + 32, j, k);
      }
    }
  }
}

// Eight blocks of eight warps fill an SM's 64 warps (32 registers each).
__global__ void __launch_bounds__(32 * kTier1Warps, 8)
sssp_wide_tier1(Params p) {
  __shared__ int s_hnode[kTier1Warps][kWarpHash];
  __shared__ int s_hdist[kTier1Warps][kWarpHash];
  __shared__ int s_members[kTier1Warps][kWarpTier];
  __shared__ int s_level[kTier1Warps][kWarpTier];
  __shared__ Ctl s_ctl[kTier1Warps];
  const Warp g;
  const int wib = threadIdx.x >> 5;
  const int C = p.capacity;
  const int limit = C < kWarpTier ? C : kWarpTier;
  const bool spills = C > kWarpTier;
  const Tables t{s_hnode[wib], s_hdist[wib], s_members[wib], s_level[wib],
                 kWarpHash - 1};
  Ctl* c = &s_ctl[wib];
  for (int s = g.rank; s < kWarpHash; s += 32) {
    t.hnode[s] = kEmpty;
    t.hdist[s] = INT_MAX;
  }
  const int warp = blockIdx.x * kTier1Warps + wib;
  const int warps = gridDim.x * kTier1Warps;
  for (int round = 0;; ++round) {
    int i = warp + round * warps;
    if (p.pool) {
      if (g.rank == 0) i = atomicAdd(&p.counters[0], 1);
      i = __shfl_sync(~0u, i, 0);
    }
    if (i >= p.n_sources) return;
    g.sync();  // the previous source's tables are cleared
    grow(g, p, i, t, limit, c);
    const bool over = c->over;
    const int src = p.sources[i];
    if (over && spills && src >= 0 && src < p.sentinel) {
      if (g.rank == 0) p.spill[atomicAdd(&p.counters[2], 1)] = i;
    } else {
      const int n = over ? 0 : c->count;  // <= min(C, W)
      const size_t row = (size_t)i * C;
      unsigned long long a = g.rank < n ? member_key(t, g.rank) : ~0ull;
      if (n <= 32) {  // the key's slot is its rank among the n keys
        int r = 0;
        for (int j = 0; j < n; ++j) r += __shfl_sync(~0u, a, j) < a;
        if (g.rank < n) write_slot(p, row, r, a, true);
        for (int s = n + g.rank; s < C; s += 32) write_slot(p, row, s, ~0ull, false);
      } else {
        unsigned long long b = g.rank + 32 < n ? member_key(t, g.rank + 32) : ~0ull;
        warp_sort64(a, b, g.rank);
        if (g.rank < C) write_slot(p, row, g.rank, a, g.rank < n);
        if (g.rank + 32 < C) write_slot(p, row, g.rank + 32, b, g.rank + 32 < n);
        for (int s = g.rank + 64; s < C; s += 32) write_slot(p, row, s, ~0ull, false);
      }
      if (g.rank == 0) p.overflow[i] = over ? 1 : 0;
    }
    g.sync();  // every lane has read the tables
    clear_tables(g, t, c);
  }
}

// Ascending bitonic sort of keys[0, n), n a power of two, by the group.
template <class G>
__device__ void group_sort(const G& g, unsigned long long* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int s = g.rank; s < n; s += g.size) {
        const int x = s ^ j;
        if (x > s) {
          const unsigned long long a = keys[s], b = keys[x];
          if ((a > b) == ((s & k) == 0)) {
            keys[s] = b;
            keys[x] = a;
          }
        }
      }
      g.sync();
    }
  }
}

__global__ void __launch_bounds__(kTier2Block) sssp_wide_tier2(Params p) {
  extern __shared__ __align__(16) int smem[];
  __shared__ Ctl ctl;
  const Block g;
  const int C = p.capacity;
  const Layout L = layout(C);
  int* ws = p.slabs ? p.slabs + (size_t)blockIdx.x * p.slab_ints : smem;
  const Tables t{ws, ws + L.H, ws + 2 * L.H, ws + 2 * L.H + L.Cp, L.H - 1};
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(ws + 2 * L.H + 2 * L.Cp);
  for (int s = g.rank; s < L.H; s += g.size) {
    t.hnode[s] = kEmpty;
    t.hdist[s] = INT_MAX;
  }
  const int n_spill = *(volatile int*)&p.counters[2];
  for (int round = 0;; ++round) {
    if (g.rank == 0) {
      ctl.i = p.pool ? atomicAdd(&p.counters[1], 1) : blockIdx.x + round * gridDim.x;
    }
    g.sync();  // also: the previous source's tables are cleared
    const int k = ctl.i;
    if (k >= n_spill) return;
    const int i = p.spill[k];
    grow(g, p, i, t, C, &ctl);
    const bool over = ctl.over;
    const int n = over ? 0 : ctl.count;
    const int np2 = next_pow2(n);
    for (int s = g.rank; s < np2; s += g.size) keys[s] = s < n ? member_key(t, s) : ~0ull;
    g.sync();
    group_sort(g, keys, np2);
    const size_t row = (size_t)i * C;
    for (int s = g.rank; s < C; s += g.size) {
      write_slot(p, row, s, s < n ? keys[s] : ~0ull, s < n);
    }
    if (g.rank == 0) p.overflow[i] = over ? 1 : 0;
    clear_tables(g, t, &ctl);
  }
}

// Tier 2's launch shape for `capacity`: block size, dynamic shared bytes,
// global slab per block in int32 words (0 when the working set fits shared
// memory) and the grid.  The large-smem attribute is set once per device.
struct Tier2Plan {
  int grid, block;
  size_t smem;
  long long slab_ints;
};

cudaError_t tier2_plan(int capacity, int n_sources, Tier2Plan* plan) {
  static bool attr_set[kMaxDevices];
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < kMaxDevices && !attr_set[device]) {
    e = cudaFuncSetAttribute(sssp_wide_tier2,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSharedLimit);
    if (e != cudaSuccess) return e;
    attr_set[device] = true;
  }
  const Layout L = layout(capacity);
  const size_t bytes = L.ints * sizeof(int);
  const bool shared = bytes <= kSharedLimit;
  int warps = 1;  // one per kWarpSet bytes of working set, a power of two
  while (32 * warps < kTier2Block && warps * kWarpSet < bytes) warps <<= 1;
  plan->block = 32 * warps;
  plan->smem = shared ? bytes : 0;
  plan->slab_ints = shared ? 0 : (long long)L.ints;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sssp_wide_tier2,
                                                    plan->block, plan->smem);
  if (e != cudaSuccess) return e;
  long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (!shared) {
    const long long cap = (long long)(kScratchLimit / bytes);
    if (g > cap) g = cap;
  }
  if (g > n_sources) g = n_sources;
  plan->grid = g < 1 ? 1 : (int)g;
  return cudaSuccess;
}

// int32 words before tier 2's slabs: the counters and the spill list,
// rounded up to a multiple of four.
long long head_words(int n_sources) {
  return ((long long)kCounters + n_sources + 3) & ~3LL;
}

}  // namespace

// int32 words of scratch that sssp_wide_launch needs for `capacity` and
// `n_sources` on the current device (counters, the spill list and tier
// 2's global slabs), or a negative cudaError_t.
extern "C" long long sssp_wide_scratch_words(int capacity, int n_sources) {
  if (capacity < 1 || capacity > kMaxCapacity || n_sources < 0) {
    return -(long long)cudaErrorInvalidValue;
  }
  long long words = head_words(n_sources);
  if (capacity > kWarpTier && n_sources > 0) {
    Tier2Plan plan;
    const cudaError_t e = tier2_plan(capacity, n_sources, &plan);
    if (e != cudaSuccess) return -(long long)e;
    words += plan.grid * plan.slab_ints;
  }
  return words;
}

// adj: int32 [n_nodes + 1, deg], packed (neighbor << 7 | min(weight, 127))
// when nw is null, else the neighbor ids with nw the int32 weights; row
// n_nodes is the sentinel row.  sources: int32 [n_sources] in
// [0, n_nodes].  out_a: int32 [n_sources, capacity] packed rows, or the
// nodes with out_b the distances (out_b null = packed rows).  overflow:
// uint8 [n_sources].  pool: 1 for the pool schedule, 0 for the batch
// schedule.  scratch: scratch_words int32 words, at least
// sssp_wide_scratch_words(capacity, n_sources); its counters are zeroed
// here.  Enqueues a memset, tier 1 and (C > 64) tier 2 on `stream`.
// Returns the first failing call's cudaError_t.
extern "C" int sssp_wide_launch(const int* adj, const int* nw, int n_nodes,
                                int deg, const int* sources, int n_sources,
                                int max_weight, int capacity, int* out_a,
                                int* out_b, uint8_t* overflow, int pool,
                                int* scratch, long long scratch_words,
                                void* stream) {
  if (capacity < 1 || capacity > kMaxCapacity || deg < 1 || n_sources < 1 ||
      scratch_words < head_words(n_sources)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  p.pool = pool != 0;
  p.counters = scratch;
  p.spill = scratch + kCounters;
  p.slabs = nullptr;
  p.slab_ints = 0;
  Tier2Plan plan{};
  if (capacity > kWarpTier) {
    cudaError_t e = tier2_plan(capacity, n_sources, &plan);
    if (e != cudaSuccess) return (int)e;
    if (plan.slab_ints > 0) {
      if (scratch_words < head_words(n_sources) + plan.grid * plan.slab_ints) {
        return (int)cudaErrorInvalidValue;
      }
      p.slabs = scratch + head_words(n_sources);
      p.slab_ints = plan.slab_ints;
    }
  }
  cudaError_t e = cudaMemsetAsync(scratch, 0, kCounters * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sssp_wide_tier1,
                                                    32 * kTier1Warps, 0);
  if (e != cudaSuccess) return (int)e;
  long long grid1 = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (n_sources + kTier1Warps - 1) / kTier1Warps;
  if (grid1 > need) grid1 = need;
  sssp_wide_tier1<<<(int)grid1, 32 * kTier1Warps, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || capacity <= kWarpTier) return (int)e;
  sssp_wide_tier2<<<plan.grid, plan.block, plan.smem, st>>>(p);
  return (int)cudaGetLastError();
}
