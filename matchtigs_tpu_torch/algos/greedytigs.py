# Ported from matchtigs_tpu/algos/greedytigs.py: the single-device stage with its capacity ladder, overlapped with the host-routed Dijkstra, and the mesh path over parallel/mesh.py.
"""Greedy matchtigs: near-optimal tigs with bounded k-mer repetition.

Capability-equivalent of ``GreedytigAlgorithm``
(upstream src/implementation/greedytigs/mod.rs:200-801):

1. imbalance scan (vectorized) -> out-nodes / in-node target mask;
2. bounded shortest paths from every out-node: the CUDA kernels of
   :mod:`matchtigs_tpu_torch.ops.sssp` for most sources, the native host
   Dijkstra for dense-tangle sources (concurrently with the first stage);
   sources whose ball overflowed a stage's working set finish on the host
   Dijkstra or re-run on the device at 4x capacity (the ladder); with a
   mesh (:mod:`matchtigs_tpu_torch.parallel.mesh`) the sources are striped
   over its shards and the host work over its processes;
3. deterministic global greedy matching over the candidate triples
   (:func:`matchtigs_tpu_torch.ops.matching.greedy_accept`);
4. accepted paths become cheap dummy biedges (weight = distance < k); the
   deterministic breaking balancer + Eulerian decomposition + cycle break
   finish exactly as in eulertigs.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from ..graph.bigraph import Bigraph
from ..ops import euler
from ..ops.candidates import Candidates
from ..ops.device_graph import build_device_graph
from ..ops.matching import greedy_accept, unbalanced_nodes
from ..utils.tracing import ELAPSED, span

logger = logging.getLogger(__name__)


@dataclass
class GreedytigConfig:
    k: int
    # Working-set capacity C of the first device stage (any C >= 1; the
    # register kernel serves ops.sssp.CAPACITIES, the wide kernel the
    # rest).  Ball sizes are heavily skewed; sources whose ball exceeds C
    # finish on the host Dijkstra or climb the ladder.  Deep-ball regimes
    # (k >= 63) should raise this.
    initial_capacity: int = 4
    # The ladder's last capacity: sources still overflowing there raise.
    max_capacity: int = 1 << 16
    # Device of the search stage: "cuda" (the current card; every visible
    # card as mesh shards), a named device such as "cuda:1", or "cpu" (the
    # kernels' plain torch versions).  A list names the mesh's shards; a
    # device may repeat.  Never guessed: the device stage ("auto" or
    # "device") without CUDA raises unless this names the CPU.
    device: str | torch.device | list = "cuda"
    # Shard the device stage and the acceptance sort over a mesh
    # (parallel/mesh.py): "auto" when it has more than one shard (devices
    # or processes), True even with one shard, False never.
    use_mesh: bool | str = "auto"
    # Overflow handling: "host" finishes capacity-overflow sources with
    # the native C++ Dijkstra; "ladder" re-runs them on the device at 4x
    # capacity per stage until none overflows.
    overflow_mode: str = "host"
    # Device scheduler: "pool" claims sources from a device cursor as
    # blocks free up; "batch" assigns them statically (the reference's
    # batch schedule).  The rows, and so the tigs, are the same.
    device_schedule: str = "pool"
    # Sources whose minimum incident edge weight is <= this threshold are
    # routed straight to the native host Dijkstra, running on the CPU
    # while the kernel runs (they sit in dense tangles with deep multi-hop
    # balls, exactly the ones that overflow the device working set).
    # -1 disables the split.
    host_route_threshold: int = 1
    # Reverse-Cuthill-McKee node renumbering of the device graph (gather
    # locality; a serial scipy BFS on the host).  The tigs do not change.
    renumber: bool = False
    # Threads for the native host Dijkstra (None = all cores).
    host_threads: int | None = None
    # Search engine: "auto" and "device" run the device stage on
    # ``device`` (without CUDA it raises unless ``device`` names the CPU);
    # "host" runs the native host Dijkstra alone.  "auto" never falls back
    # to the host for want of a card.
    engine: str = "auto"
    # Opt-in per-source search counters (ball-size histogram, max/avg) —
    # the analog of the reference's --dijkstra-performance-data-type
    # Complete heap/distance-array statistics (greedytigs/mod.rs:646-673).
    performance_counters: bool = False
    # Host search strategy: "dial" = Dial-bucket queue + dense epoch
    # distance arrays (the default); "heap" = per-source binary heap +
    # hashmap distance map (the reference's default semantics).
    host_strategy: str = "dial"


@dataclass
class SearchStats:
    """Counters for the shortest-path phase (reference analog:
    DijkstraPerformanceCounter, greedytigs/mod.rs:646-673)."""

    sources: int = 0
    candidates: int = 0
    retries: int = 0
    capacity_final: int = 0
    stage_sources: list[int] = field(default_factory=list)
    host_routed: int = 0
    # Per device stage: wall seconds from launch to extracted candidates
    # (the host-routed Dijkstra runs inside it), the kernel's own device
    # seconds (CUDA events; not measured on the CPU), the fraction of
    # done slots holding a kept candidate, and the overflow fraction.
    stage_times: list[float] = field(default_factory=list)
    stage_kernel_times: list[float] = field(default_factory=list)
    stage_occupancy: list[float] = field(default_factory=list)
    stage_overflow_frac: list[float] = field(default_factory=list)

    def log_ball_sizes(self, candidates: "Candidates", n_nodes: int,
                       out_nodes: np.ndarray) -> None:
        """Per-source candidate-ball statistics (opt-in; the analog of the
        reference's max/average heap and distance-array size counters,
        greedytigs/mod.rs:646-673).  A source's "ball" here is its number
        of reported in-node candidates within the distance bound."""
        counts = np.bincount(
            candidates.u, minlength=n_nodes
        )[np.asarray(out_nodes, dtype=np.int64)]
        if not len(counts):
            return
        logger.info(
            "Ball sizes: max %d, mean %.1f, median %d "
            "(%d sources with zero candidates)",
            int(counts.max()),
            float(counts.mean()),
            int(np.median(counts)),
            int((counts == 0).sum()),
        )
        hist = np.bincount(
            np.where(counts > 0, np.log2(np.maximum(counts, 1)).astype(int) + 1, 0)
        )
        for b, n in enumerate(hist):
            if n:
                lo = 0 if b == 0 else 1 << (b - 1)
                hi = 0 if b == 0 else (1 << b) - 1
                logger.info("  ball size %s: %d sources",
                            "0" if b == 0 else f"[{lo}, {hi}]", int(n))

    def log(self) -> None:
        logger.info(
            "Search stats: %d sources (%d host-routed), %d candidates, "
            "%d capacity retries (stage sizes %s, final capacity %d)",
            self.sources,
            self.host_routed,
            self.candidates,
            self.retries,
            self.stage_sources,
            self.capacity_final,
        )
        for i, (t, occ, ovf) in enumerate(
            zip(self.stage_times, self.stage_occupancy, self.stage_overflow_frac)
        ):
            logger.info(
                "  device stage %d: %.2fs, slot occupancy %.1f%% "
                "(wasted %.1f%%), overflow %.2f%%",
                i,
                t,
                100 * occ,
                100 * (1 - occ),
                100 * ovf,
            )


def _check_config(config: GreedytigConfig) -> None:
    """Reject unknown modes."""
    if config.use_mesh not in ("auto", True, False):
        raise ValueError(f"unknown use_mesh: {config.use_mesh!r}")
    if config.overflow_mode not in ("host", "ladder"):
        raise ValueError(f"unknown overflow_mode: {config.overflow_mode!r}")
    if config.device_schedule not in ("pool", "batch"):
        raise ValueError(f"unknown device_schedule: {config.device_schedule!r}")
    if config.initial_capacity < 1:
        raise ValueError(
            f"initial_capacity must be >= 1, got {config.initial_capacity}"
        )
    if config.engine not in ("auto", "device", "host"):
        raise ValueError(f"unknown engine: {config.engine!r}")


def _host_search_fn(config: GreedytigConfig):
    """Resolve the host search engine from the strategy selection."""
    from ..ops import sssp

    if config.host_strategy == "heap":
        return sssp.reference_dijkstra_candidates
    if config.host_strategy != "dial":
        raise ValueError(f"unknown host_strategy: {config.host_strategy!r}")
    return sssp.host_dijkstra_candidates


def _use_host_engine(config: GreedytigConfig) -> bool:
    """True when the search skips the device stage entirely: only when
    the host engine is asked for."""
    return config.engine == "host"


def _stage_devices(config: GreedytigConfig) -> list[torch.device]:
    """The devices ``config.device`` names: "cuda" without an index is the
    current card, or under a mesh every visible card.  Raises when it names
    CUDA and there is none."""
    named = config.device if isinstance(config.device, (list, tuple)) else [config.device]
    devices = [torch.device(d) for d in named]
    if not devices:
        raise ValueError("GreedytigConfig.device names no device")
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError(
            f"the device stage was asked for {config.device!r} and no CUDA "
            "device is present; pass device='cpu' to run it on the CPU"
        )
    if devices == [torch.device("cuda")]:
        if config.use_mesh is not False:
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [torch.device("cuda", torch.cuda.current_device())]
    return devices


def _stage_placement(config: GreedytigConfig):
    """(devices, mesh) of the device stage; the mesh is None for the
    single-device path.  Under a process group making the mesh is a
    collective, so every process calls this once per run."""
    from ..parallel.mesh import make_mesh, world

    devices = _stage_devices(config)
    if config.use_mesh is False:
        if len(devices) > 1:
            raise ValueError("several devices need use_mesh")
        return devices, None
    if config.use_mesh == "auto" and len(devices) == 1 and world()[0] == 1:
        return devices, None
    return devices, make_mesh(devices)


def split_device_sources(dg, out_nodes: np.ndarray, host_route_threshold: int):
    """(device sources in search order, host-routed sources or None).

    Sources whose minimum incident edge weight is <= the threshold go to
    the host (unless all would).  The device sources are ordered by that
    weight descending (small weights mean deep multi-hop balls, so the
    shallowest balls come first), then by node id for gather locality,
    as the JAX package orders them.  Results carry source
    ids and acceptance re-sorts globally, so the order never changes the
    output."""
    pending = np.asarray(out_nodes, dtype=np.int32)
    difficulty = dg.nw.min(axis=1)[pending]
    hard_sources = None
    if host_route_threshold >= 0:
        hard = difficulty <= host_route_threshold
        if hard.any() and not hard.all():
            hard_sources = pending[hard]
            pending = pending[~hard]
            difficulty = difficulty[~hard]
    if len(pending):
        maxd = np.int64(int(difficulty.max()))
        key = ((maxd - difficulty.astype(np.int64)) << 32) | pending.astype(
            np.int64
        )
        key.sort()
        pending = (key & np.int64(0xFFFFFFFF)).astype(pending.dtype)
    return pending, hard_sources


def collect_candidates(
    g: Bigraph,
    out_nodes: np.ndarray,
    in_mask: np.ndarray,
    k: int,
    config: GreedytigConfig,
    stats: SearchStats | None = None,
    return_chunks: bool = False,
    placement=None,
) -> Candidates:
    """Run the bounded SSSP and extract (out, in, dist) columns.

    ``return_chunks`` skips the final column concatenation and returns
    the per-producer chunk list instead (device extraction, host-routed,
    overflow tail): greedy acceptance packs chunks straight into its
    sort key.  ``placement`` is the stage's ``(devices, mesh)`` when the
    caller has made it already (``compute_greedytigs`` reuses its mesh for
    the acceptance sort); by default it is made here.
    """
    _check_config(config)
    stats = stats if stats is not None else SearchStats()
    stats.sources = len(out_nodes)
    host_search = _host_search_fn(config)
    if _use_host_engine(config):
        with span("search.device_graph"):
            dg = build_device_graph(g)
        stats.host_routed = len(out_nodes)
        with span("search.host", timed=True) as sp:
            res = host_search(
                dg,
                np.asarray(out_nodes, dtype=np.int64),
                k - 1,
                in_mask,
                n_threads=config.host_threads,
            )
            sp.add(sources=len(out_nodes), candidates=len(res))
            sp.lap(logger, "Native host Dijkstra: %d sources, %d candidates in %.2fs",
                   len(out_nodes), len(res), ELAPSED)
        stats.candidates = len(res)
        return [res] if return_chunks else res

    devices, mesh = placement if placement is not None else _stage_placement(config)
    with span("search.device_graph", timed=True) as sp:
        dg = build_device_graph(g, renumber=config.renumber)
        sp.add(nodes=dg.n_nodes, slots=dg.nbr.size)
        sp.lap(logger, "Device graph build (renumber=%s): %.2fs", config.renumber, ELAPSED)
    if dg.to_orig is not None:
        in_mask = np.asarray(in_mask)[dg.to_orig]

    def search_on_host(sources: np.ndarray) -> Candidates:
        """The host Dijkstra over device-numbered sources, in original ids."""
        res = host_search(dg, sources, k - 1, in_mask, n_threads=config.host_threads)
        if dg.to_orig is not None and len(res):
            res.u, res.v = dg.unmap_nodes(res.u), dg.unmap_nodes(res.v)
        return res

    # Upload the adjacency first (once per graph, device and layout).
    from ..ops.sssp import KERNEL_LAUNCHES, _can_pack_adj, batched_bounded_sssp_dispatch
    from ..parallel.mesh import (
        allgather_candidates,
        process_source_slice,
        sharded_bounded_sssp_dispatch,
    )

    for device in devices if mesh is None else mesh.devices:
        dg.device_buffers(device, adj_packed=_can_pack_adj(dg, k - 1))
    chunks: list[Candidates] = []

    with span("search.split") as sp:
        pending, hard_sources = split_device_sources(
            dg, dg.map_sources(np.asarray(out_nodes, dtype=np.int32)),
            config.host_route_threshold,
        )
        sp.add(device_sources=len(pending),
               host_routed=0 if hard_sources is None else len(hard_sources))
    if hard_sources is not None:
        stats.host_routed = len(hard_sources)
        logger.info(
            "Routing %d dense-tangle sources to the host Dijkstra",
            len(hard_sources),
        )
    capacity = config.initial_capacity

    def launch():
        """One asynchronous stage over ``pending`` at ``capacity``."""
        stats.stage_sources.append(len(pending))
        stats.capacity_final = capacity
        with span("search.dispatch") as sp:
            before = dict(KERNEL_LAUNCHES) if sp else None
            if mesh is not None:
                handle = sharded_bounded_sssp_dispatch(
                    dg, pending, k - 1, capacity, mesh,
                    schedule=config.device_schedule,
                )
            else:
                handle = batched_bounded_sssp_dispatch(
                    dg, pending, k - 1, capacity, devices[0],
                    schedule=config.device_schedule,
                )
            if sp:  # this stage's launches, by kernel
                sp.add(sources=len(pending), capacity=capacity,
                       **{f"launches_{name}": n - before[name]
                          for name, n in KERNEL_LAUNCHES.items() if n != before[name]})
        return handle

    # One stage per capacity: an asynchronous launch and one synchronizing
    # copy back; the host-routed Dijkstra runs on the CPU while the first
    # stage computes.  Overflowed sources finish on the host, or go to the
    # next stage at 4x capacity.  Under a mesh each process runs the host
    # Dijkstra on its slice of the sources and the candidates are gathered
    # on this thread, after the stages, so every process calls the same
    # collectives in the same order.
    routed = None
    while len(pending):
        # the stage's lap runs from its launch to its candidates
        with span("search.stage", timed=True) as stage:
            handle = launch()
            if hard_sources is not None:  # while the first stage computes
                routed = _host_routed(search_on_host, hard_sources, mesh, chunks)
                hard_sources = None
            tri, over = handle.fetch_candidates(dg, pending, in_mask)
            n_overflow = int(over.sum())
            stage.add(overflowed=n_overflow)
            kernel_s = handle.kernel_seconds()
            stage.lap(
                logger, "Device stage: %d sources at capacity %d in %.2fs (kernel %s)",
                len(pending), capacity, ELAPSED,
                "not measured" if kernel_s is None else f"{kernel_s:.4f}s",
            )
        stats.stage_times.append(stage.seconds)
        if kernel_s is not None:
            stats.stage_kernel_times.append(kernel_s)
        stats.stage_overflow_frac.append(n_overflow / len(pending))
        stats.stage_occupancy.append(
            len(tri) / max(1, (len(pending) - n_overflow) * capacity)
        )
        if len(tri):
            chunks.append(tri)
        pending = pending[over]
        if not n_overflow:
            break
        stats.retries += 1
        if config.overflow_mode == "host":
            # Finish the heavy tail with the native host Dijkstra.
            stats.stage_sources.append(n_overflow)
            with span("search.overflow_tail", timed=True) as sp:
                tail = search_on_host(
                    pending if mesh is None else process_source_slice(pending)
                )
                if mesh is not None:
                    tail = allgather_candidates(tail)
                if len(tail):
                    chunks.append(tail)
                sp.add(sources=n_overflow, candidates=len(tail))
                sp.lap(logger, "Finished %d overflowed sources on host in %.2fs",
                       n_overflow, ELAPSED)
            break
        if capacity >= config.max_capacity:
            raise RuntimeError(
                f"SSSP capacity {capacity} exhausted for {n_overflow} sources"
            )
        capacity *= 4
        logger.info(
            "Retrying %d overflowed sources with capacity %d",
            n_overflow, capacity,
        )
    if routed is not None:
        routed = allgather_candidates(routed)
        if len(routed):
            chunks.append(routed)

    if return_chunks:
        stats.candidates = sum(len(c) for c in chunks)
        return chunks
    with span("search.concat"):
        result = Candidates.concat(chunks)
    stats.candidates = len(result)
    return result


def _host_routed(search_on_host, hard_sources, mesh, chunks):
    """The host-routed Dijkstra, run while the first device stage
    computes.  Its candidates go to ``chunks``; under a mesh this process's
    slice is returned instead, to be gathered after the stages."""
    from ..parallel.mesh import process_source_slice

    with span("search.host_routed", timed=True) as sp:
        res = search_on_host(
            hard_sources if mesh is None else process_source_slice(hard_sources)
        )
        sp.add(sources=len(hard_sources), candidates=len(res))
        sp.lap(logger, "Host-routed Dijkstra (%d sources) during the device stage: "
               "%.2fs", len(hard_sources), ELAPSED)
    if mesh is not None:
        return res
    if len(res):
        chunks.append(res)
    return None


def compute_greedytigs(
    g: Bigraph, config: GreedytigConfig, stats: SearchStats | None = None
) -> "Walks":
    """Mutates `g` (adds dummy biedges) and returns edge walks.

    ``stats``, when given, is filled in place with the search-phase
    counters (device stage times/occupancy, host-routed counts).
    """
    k = config.k
    # timed: the "total" of the last lap runs from the scan's start
    with span("search.scan", timed=True) as scan:
        out_nodes, in_mask, mult = unbalanced_nodes(g)
        n_in = int(in_mask.sum())
        scan.add(out_nodes=len(out_nodes), in_nodes=n_in)
    logger.info(
        "Found %d nodes with missing outgoing and %d with missing incoming edges",
        len(out_nodes),
        n_in,
    )

    _check_config(config)
    with span("search.placement"):
        placement = None if _use_host_engine(config) else _stage_placement(config)
    mesh = None if placement is None else placement[1]
    stats = stats if stats is not None else SearchStats()
    candidates = collect_candidates(
        g, out_nodes, in_mask, k, config, stats, return_chunks=True,
        placement=placement,
    )
    stats.log()
    if config.performance_counters and stats.candidates:
        # the opt-in ball counters need the concatenated columns
        with span("search.ball_sizes"):
            candidates = [Candidates.concat(candidates)]
            stats.log_ball_sizes(candidates[0], g.n_nodes, out_nodes)
    logger.info("Found %d candidate shortest paths", stats.candidates)

    # Acceptance owns the chunk list: it empties it and frees each chunk's
    # columns and its own sort scratch, so nothing candidate-sized lives on
    # into balance, Euler and write.
    with span("join.accept", timed=True) as sp:
        accepted = None
        if mesh is not None:
            # The acceptance sort runs over the mesh; the multiplicity scan
            # stays on the host.  Ids or distances beyond the packed key's
            # ranges take the host accept.
            from ..ops.matching import greedy_accept_sorted_keys, pack_accept_keys
            from ..parallel.mesh import sharded_accept_key_sort

            keys = pack_accept_keys(candidates)
            if keys is not None:
                candidates.clear()
                sorted_keys = sharded_accept_key_sort(keys, mesh)
                del keys
                accepted = greedy_accept_sorted_keys(g, sorted_keys, mult)
                del sorted_keys
                logger.info("Acceptance sort ran over %d mesh shards", mesh.size)
        if accepted is None:
            accepted = greedy_accept(g, candidates, mult, sp)
        del candidates
        sp.add(accepted=len(accepted))
        sp.lap(logger, "Accepted %d paths as cheap dummy edges in %.2fs",
               len(accepted), ELAPSED)

    dummy_edge_id = 0
    if len(accepted):
        n = len(accepted)
        with span("join.add_dummies") as sp:
            dummy_ids = np.arange(1, n + 1, dtype=np.int64)
            g.add_biedge_pairs(
                src=accepted[:, 0].astype(np.int32),
                dst=accepted[:, 1].astype(np.int32),
                weight=accepted[:, 2],
                handle=np.full(n, -1, dtype=np.int64),
                forward=np.ones(n, dtype=bool),
                dummy_id=dummy_ids,
            )
            sp.add(edges=2 * n)
        dummy_edge_id = n

    # Full-graph invariant scans: debug_assert! analogs, off in production
    # (utils/debug.py).
    from ..utils.debug import debug_checks

    if debug_checks():
        assert g.verify_node_pairing()
        assert g.verify_edge_mirror_property()

    with span("join.balance", timed=True) as sp:
        logger.info("Making graph Eulerian by adding breaking dummy edges")
        euler.make_eulerian_with_breaking_edges(g, k, dummy_edge_id)
        if not euler.decomposes_into_eulerian_bicycles(g):
            raise AssertionError("Failed to make the graph Eulerian")
        if debug_checks():
            euler.assert_no_consecutive_dummy_edges(g, k)
        sp.lap(logger, "Balancing took %.2fs", ELAPSED)

    with span("join.euler_break", timed=True) as sp:
        if mesh is not None and mesh.world_size > 1:
            # Euler + break split over the processes by component; the merge
            # restores the single-process tig stream.
            from ..parallel.mesh import distributed_euler_break

            tigs = distributed_euler_break(g, k)
            logger.info("Euler+break ran over %d processes", mesh.world_size)
        else:
            cycles = euler.eulerian_bicycle_decomposition(g)
            logger.info("Found %d Eulerian bicycles", len(cycles))
            tigs = euler.break_cycles(g, cycles, k)
            sp.add(cycles=len(cycles))
        sp.add(tigs=len(tigs))
        sp.lap(logger, "Found %d greedytigs (euler+break %.2fs, total %.2fs)",
               len(tigs), ELAPSED, scan)
    return tigs
