# Ported from matchtigs_tpu/parallel/mesh.py: the sharded search stage (K6) launches the single-device kernels once per shard, the sharded acceptance sort (K7) is csrc/mesh_sort.cu, and the collectives go over torch.distributed (gloo) on host tensors.
"""Multi-device layer: the search stage and the acceptance sort over a mesh.

A mesh is a list of shards in one global order.  Each process of a
``torch.distributed`` group holds the same number of shards, each a torch
device, and shard ids are process-major.  A device may hold several
shards: that is how one card, or one CPU, runs a multi-shard mesh.  Every
process feeds the same global inputs and gets the same results back, so
matching and the Euler passes stay replicated and deterministic on the
host.

- K6, :func:`sharded_bounded_sssp`: the sources are striped round-robin
  over the shards (every shard sees the same difficulty profile); each
  local shard launches the single-device search stage
  (:func:`matchtigs_tpu_torch.ops.sssp.batched_bounded_sssp_dispatch`: the
  CUDA kernels on a card, their plain versions on the CPU) on its device.
  All launches go out before any copy back, so shards on distinct cards
  overlap; then the rows are gathered across processes.
- K7, :func:`sharded_accept_key_sort`: each shard sorts its block of
  acceptance keys (``csrc/mesh_sort.cu``), then ``n_dev`` odd-even
  transposition rounds merge-split neighbouring blocks.  A partner block
  in this process is read directly (a peer copy when the devices differ);
  one in another process comes by send/recv through host memory.
- The host work splits over processes by source (:func:`process_source_slice`,
  :func:`allgather_candidates`) and by component
  (:func:`distributed_euler_break`).

Collectives run on the gloo backend over CPU tensors.  Every process
calls the same collectives in the same order; a gather whose lengths
differ between processes goes in two phases (lengths, then blocks padded
to the longest).  Merge keys, tig flats and lengths stay int64 throughout.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..ops import mesh_sort
from ..ops.candidates import Candidates
from ..ops.device_graph import DeviceGraph
from ..ops.euler import decompose_break_wcc_part, merge_tig_parts
from ..ops.sssp import batched_bounded_sssp_dispatch, extract_candidates, unpack_rows
from ..ops.walks import Walks

KEY_PAD = np.iinfo(np.int64).max  # sorts after every acceptance key


def initialize_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    timeout_s: float = 600.0,
) -> None:
    """Join the process group: call once per process before :func:`make_mesh`.

    A gloo group over ``tcp://<coordinator_address>`` ("host:port", where
    process 0 listens), with the world size and rank the caller gives.  A
    collective that waits longer than ``timeout_s`` raises."""
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def world() -> tuple[int, int]:
    """(number of processes, this process's rank); (1, 0) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass(frozen=True)
class Mesh:
    """This process's shards (torch devices, in global order) of a mesh of
    ``world_size`` processes holding the same number of shards each."""

    devices: tuple[torch.device, ...]
    world_size: int = 1
    rank: int = 0

    @property
    def size(self) -> int:
        """Shards over all processes."""
        return self.world_size * len(self.devices)

    @property
    def first(self) -> int:
        """Global id of this process's first shard."""
        return self.rank * len(self.devices)


def make_mesh(devices=None) -> Mesh:
    """The mesh whose shards in this process are ``devices`` (torch devices
    or their names; one may repeat), by default every visible CUDA device.
    Inside a process group every process must call it (it checks that the
    shard counts agree)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; name the devices "
                "(for example ['cpu'] * 8)"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    counts = [int(c[0]) for c in _allgather(np.array([len(devices)], np.int64))]
    if len(set(counts)) > 1:
        raise ValueError(f"every process needs the same number of shards: {counts}")
    return Mesh(devices, *world())


def _allgather(x: np.ndarray) -> list[np.ndarray]:
    """Every process's ``x``, in rank order (``[x]`` outside a group).  The
    first dimension may differ between processes (lengths go first, then
    blocks padded to the longest); the rest of the shape and the dtype
    may not."""
    world_size, _ = world()
    if world_size == 1:
        return [x]
    local = torch.from_numpy(np.ascontiguousarray(x))
    n = torch.tensor([local.shape[0]], dtype=torch.int64)
    lengths = [torch.empty_like(n) for _ in range(world_size)]
    dist.all_gather(lengths, n)
    lengths = [int(t) for t in lengths]
    block = local.new_zeros((max(1, *lengths), *local.shape[1:]))
    block[: local.shape[0]] = local
    blocks = [torch.empty_like(block) for _ in range(world_size)]
    dist.all_gather(blocks, block)
    return [b[:m].numpy() for b, m in zip(blocks, lengths)]


def _gather_shards(local: list[np.ndarray]) -> np.ndarray:
    """Per-shard arrays of this process -> every shard's, in global order."""
    return np.concatenate(_allgather(np.concatenate(local)))


class ShardedStage:
    """Handle of a launched sharded stage (:func:`sharded_bounded_sssp_dispatch`):
    every local shard computes while the host works; the fetches copy back
    and gather, and are collectives."""

    def __init__(self, handles, srcs: np.ndarray, n_dev: int):
        self._handles = handles
        self.srcs = srcs  # int32 [n_dev * L]: the striped sources, padding = n_nodes
        self._n_dev = n_dev

    def fetch(self):
        """(rows, dist or None for packed rows, overflow bool, srcs) of every
        shard's rows, in the striped order of ``srcs``."""
        parts = [h.fetch() for h in self._handles]
        rows = _gather_shards([p[0] for p in parts])
        dist_ = None if parts[0][1] is None else _gather_shards([p[1] for p in parts])
        over = _gather_shards([p[2].astype(np.uint8) for p in parts]).astype(bool)
        return rows, dist_, over, self.srcs

    def fetch_candidates(self, dg: DeviceGraph, sources: np.ndarray, in_mask):
        """(Candidates of the real rows that fit, overflow [S] bool in the
        order of ``sources``, the sources the stage was launched with).
        Padding rows never reach the extraction."""
        rows, dist_, over, srcs = self.fetch()
        done = ~over & (srcs != dg.n_nodes)
        tri = extract_candidates(dg, rows, dist_, srcs, done, in_mask)
        # srcs[d * L + j] holds source j * n_dev + d
        over_by_source = over.reshape(self._n_dev, -1).T.reshape(-1)[: len(sources)]
        return tri, over_by_source

    def kernel_seconds(self) -> float | None:
        """Device seconds of the local shards' launches, summed; None on
        the CPU."""
        times = [h.kernel_seconds() for h in self._handles]
        return None if any(t is None for t in times) else sum(times)


def sharded_bounded_sssp_dispatch(
    dg: DeviceGraph,
    sources: np.ndarray,
    max_weight: int,
    capacity: int,
    mesh: Mesh,
    schedule: str = "pool",
) -> ShardedStage:
    """Launch the stage on every local shard without waiting.

    The sources are padded with ``dg.n_nodes`` to ``n_dev * L``, L =
    ceil(S / n_dev), and striped: shard d gets sources d, d + n_dev, ...
    (``srcs[d * L + j] = padded[j * n_dev + d]``), the JAX package's layout
    with ``batch_size=None``."""
    n_dev = mesh.size
    sources = np.asarray(sources, dtype=np.int32)
    S = len(sources)
    L = max(1, -(-S // n_dev))
    padded = np.full(L * n_dev, dg.n_nodes, dtype=np.int32)
    padded[:S] = sources
    srcs = np.ascontiguousarray(padded.reshape(L, n_dev).T.reshape(-1))
    handles = [
        batched_bounded_sssp_dispatch(
            dg, srcs[g * L : (g + 1) * L], max_weight, capacity, device,
            schedule=schedule,
        )
        for g, device in enumerate(mesh.devices, start=mesh.first)
    ]
    return ShardedStage(handles, srcs, n_dev)


def sharded_bounded_sssp(
    dg: DeviceGraph,
    sources: np.ndarray,
    max_weight: int,
    capacity: int = 128,
    mesh: Mesh | None = None,
    return_packed: bool = True,
    schedule: str = "pool",
):
    """Bounded balls of ``sources`` over the mesh, on every process.

    Returns ``(result, dist, overflow, srcs)``: rows follow ``srcs`` (the
    striped order; rows with ``srcs == dg.n_nodes`` are padding).  Packed
    rows come back as they are with ``dist`` None when ``return_packed``,
    else unpacked into nodes and distances (empty slots ``(sentinel,
    INF)``), as ``batched_bounded_sssp`` gives them."""
    if mesh is None:
        mesh = make_mesh()
    rows, dist_, over, srcs = sharded_bounded_sssp_dispatch(
        dg, sources, max_weight, capacity, mesh, schedule
    ).fetch()
    if dist_ is not None or return_packed:
        return rows, dist_, over, srcs
    return (*unpack_rows(rows), over, srcs)


def process_source_slice(sources: np.ndarray) -> np.ndarray:
    """This process's strided slice of a host-side source set (the whole
    set outside a group): the host Dijkstra work splits over processes,
    and :func:`allgather_candidates` restores the full set."""
    world_size, rank = world()
    return sources if world_size == 1 else sources[rank::world_size]


def allgather_candidates(c: Candidates) -> Candidates:
    """Every process's candidates, in rank order, on every process."""
    if world()[0] == 1:
        return c
    tri = np.concatenate(_allgather(c.to_triples()))
    return Candidates.from_triples(tri)


def distributed_euler_break(g, k: int) -> Walks | None:
    """Eulerian decomposition + cycle break split over the processes by
    mirror-connected component: each runs
    :func:`~matchtigs_tpu_torch.ops.euler.decompose_break_wcc_part` on its
    share, the tig slices and their int64 merge keys are gathered, and
    :func:`~matchtigs_tpu_torch.ops.euler.merge_tig_parts` restores the
    single-process tig stream.  None outside a group."""
    world_size, rank = world()
    if world_size == 1:
        return None
    walks, keys = decompose_break_wcc_part(g, k, world_size, rank)
    lengths = np.diff(np.asarray(walks.offsets, np.int64), prepend=np.int64(0))
    all_keys = _allgather(np.asarray(keys, np.int64))
    all_lengths = _allgather(lengths)
    all_flats = _allgather(np.asarray(walks.flat, np.int64))
    return merge_tig_parts([
        (Walks(flat, np.cumsum(n)), key)
        for flat, n, key in zip(all_flats, all_lengths, all_keys)
    ])


def _exchange(blocks: list[torch.Tensor], partner: dict, mesh: Mesh) -> dict:
    """Partner blocks that live in other processes, by local shard index:
    one send and one receive each, through host memory."""
    n_local = len(blocks)
    ops, got = [], {}
    for i, block in enumerate(blocks):
        p = partner.get(mesh.first + i)
        if p is None or p // n_local == mesh.rank:
            continue
        mine = block.cpu()
        got[i] = torch.empty_like(mine)
        ops += [
            dist.P2POp(dist.isend, mine, p // n_local),
            dist.P2POp(dist.irecv, got[i], p // n_local),
        ]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


def sharded_accept_key_sort(keys: np.ndarray, mesh: Mesh | None = None) -> np.ndarray:
    """Global ascending sort of int64 acceptance keys (``d << 56 | u << 28 |
    v``) over the mesh, on every process.

    The keys are padded with int64 max (which sorts to the tail and is cut
    off) to ``n_dev * L`` and cut into one block per shard.  Each shard
    sorts its block; then ``n_dev`` odd-even transposition rounds pair
    shards (p, p + 1) for p = parity, parity + 2, ..., and merge-split each
    pair: the left shard keeps the low L keys of the two blocks, the right
    one the high L; a shard outside a pair keeps its block.  With sorted
    blocks and merge-split for compare-exchange, n_dev rounds sort any
    input.  One shard, or fewer than two keys per shard, sort on the host."""
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.size
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    M = len(keys)
    if n_dev == 1 or M < 2 * n_dev:
        return np.sort(keys)
    L = -(-M // n_dev)
    padded = np.full(n_dev * L, KEY_PAD, dtype=np.int64)
    padded[:M] = keys
    first, n_local = mesh.first, len(mesh.devices)
    blocks = [
        mesh_sort.sort_keys(torch.from_numpy(padded[g * L : (g + 1) * L]).to(d))
        for g, d in enumerate(mesh.devices, start=first)
    ]
    for r in range(n_dev):
        partner = {}
        for p in range(r % 2, n_dev - 1, 2):
            partner[p], partner[p + 1] = p + 1, p
        remote = _exchange(blocks, partner, mesh)
        merged = []
        for i, block in enumerate(blocks):
            p = partner.get(first + i)
            if p is None:
                merged.append(block)
                continue
            other = remote[i] if i in remote else blocks[p - first]
            merged.append(mesh_sort.merge_split(
                block, other.to(block.device), keep_high=first + i > p
            ))
        blocks = merged
    local = torch.cat([b.cpu() for b in blocks]).numpy()
    return np.concatenate(_allgather(local))[:M]
