# Ported from matchtigs_tpu/ops/sssp.py: the search stage is csrc/sssp_pool.cu, csrc/sssp_wide.cu and csrc/sssp_compact.cu, each beside its plain torch version; the host engines are copies.
"""Batched k-bounded multi-source shortest paths (the hot kernel).

Replacement for the reference's per-source binary-heap Dijkstra
(``traitgraph-algo``; call sites upstream
src/implementation/greedytigs/mod.rs:324-341): every out-node's bounded
ball (all nodes at distance <= max_weight) is searched on the device,
with a working set of C (node, dist) slots per source.

The stage's output contract, shared by the CUDA kernels and their plain
torch version (:func:`pool_sssp_plain`):

- row: for a source whose ball has at most C nodes (the source itself at
  0 included) the row holds exactly that ball sorted by (dist, node);
  packed rows hold ``(node << DIST_BITS) | dist`` with empty slots
  ``(sentinel << DIST_BITS) | 127``, unpacked rows hold ``nodes`` and
  ``dist`` with empty slots ``(sentinel, INF)`` (in both schedules);
- overflow flag: set iff the ball has more than C nodes; such rows are
  unspecified and their sources finish on the host Dijkstra or at the
  next capacity of the ladder.

Packed rows need max_weight < 126 and node ids < 2^24; the packed
adjacency needs max_weight < 127.  Outside them (k >= 128, huge graphs)
the stage runs on the unpacked ``(nbr, nw)`` pair with unpacked rows.

Routing: the pool schedule over the packed adjacency with four slots per
row and C in ``CAPACITIES`` (4 to 32) runs the register kernel
``csrc/sssp_pool.cu`` (a thread per source); every other capacity, degree,
layout and the batch schedule run the wide kernel ``csrc/sssp_wide.cu`` (a
warp per source up to ``WARP_TIER_CAPACITY`` members, then a second tier
for the larger balls).
``csrc/sssp_compact.cu`` compacts a packed stage's valid slots on the
device for a smaller download.

Bellman-Ford sets only grow and edge weights are >= 1, so both the
round-by-round plain version and the kernels' per-source searches meet
the contract bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..utils.tracing import span
from .candidates import Candidates
from .device_graph import ADJ_W_BITS, ADJ_W_MASK, DeviceGraph

INF = np.int32(1 << 20)  # unpacked empty-slot distance
DIST_BITS = 7  # distances < 128 (k <= 127); nodes < 2^24 for packed rows
DIST_CAP = (1 << DIST_BITS) - 1  # empty-slot distance in packed rows
# the register kernel's compiled capacities; at C = 64 the wide kernel's
# warp tier is faster (csrc/sssp_pool.cu)
CAPACITIES = (4, 8, 16, 32)
MAX_WIDE_CAPACITY = 1 << 20  # the wide kernel's largest capacity
# members per source of the wide kernel's warp tier; a larger ball at a
# larger capacity is redone by its second tier (csrc/sssp_wide.cu)
WARP_TIER_CAPACITY = 64
SCHEDULES = ("pool", "batch")

# Launches per kernel by its wrapper, for runs that must show the main
# path went through it.
KERNEL_LAUNCHES = {
    "sssp_pool": 0, "sssp_wide": 0, "sssp_compact": 0,
    "mesh_sort": 0, "mesh_merge_split": 0,
}

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_kernel_libs: dict[str, ctypes.CDLL] | None = None
_PLAIN_CHUNK = 1 << 24  # working-set elements per chunk of the plain version


def reset_kernel_launches() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def _can_pack_out(dg: DeviceGraph, max_weight: int) -> bool:
    """Packed rows (one int32 per slot) need node < 2^24 and a bound
    below the empty-slot distance."""
    return (
        max_weight < (1 << DIST_BITS) - 1
        and dg.n_nodes + 1 < (1 << (31 - DIST_BITS))
    )


def _can_pack_adj(dg: DeviceGraph, max_weight: int) -> bool:
    """Packed adjacency (neighbor id + clamped weight per int32): node
    ids < 2^24 and a bound under the weight clamp, so clamped weights
    (== ADJ_W_MASK) filter exactly like their originals."""
    return max_weight < ADJ_W_MASK and dg.can_pack_adj


def build_kernels() -> dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` with nvcc, one process per source, all
    started together, into the package's ``build/<hash>/`` (one hash over
    all sources and the flags), and load them: {source stem: library}."""
    global _kernel_libs
    if _kernel_libs is not None:
        return _kernel_libs
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = _BUILD_DIR / h.hexdigest()[:16]
    todo = [s for s in sources if not (out_dir / f"{s.stem}.so").exists()]
    if todo:
        from torch.utils.cpp_extension import CUDA_HOME

        nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
        if not CUDA_HOME or not nvcc.exists():
            raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            tmp = out_dir / f"{src.stem}.so.build{os.getpid()}"
            procs.append((src, tmp, subprocess.Popen(
                [str(nvcc), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )))
        errors = []
        for src, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"{src.name}: {err[-4000:]}")
            else:
                os.replace(tmp, out_dir / f"{src.stem}.so")  # atomic
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    libs = {s.stem: ctypes.CDLL(str(out_dir / f"{s.stem}.so")) for s in sources}
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pi = ctypes.POINTER(ctypes.c_int)
    for fn, args in (
        (libs["sssp_pool"].sssp_pool_launch, [vp, ci, vp, ci, ci, ci, vp, vp, ci, vp]),
        (libs["sssp_pool"].sssp_pool_attributes, [ci, pi, pi]),
        (libs["sssp_wide"].sssp_wide_launch, [
            vp, vp, ci, ci, vp, ci, ci, ci, vp, vp, vp, ci, vp, ll, vp,
        ]),
        (libs["sssp_compact"].sssp_compact_launch, [
            vp, vp, ci, ci, ci, ci, ll, vp, vp, ci, vp, vp, vp,
        ]),
        (libs["mesh_sort"].mesh_sort_launch, [vp, vp, vp, vp, ll, vp]),
        (libs["mesh_sort"].mesh_merge_split_launch, [vp, vp, ll, ci, vp, vp]),
    ):
        fn.restype = ci
        fn.argtypes = args
    for fn, args in (
        (libs["sssp_wide"].sssp_wide_scratch_words, [ci, ci]),
        (libs["sssp_compact"].sssp_compact_state_words, [ci, ci]),
        (libs["mesh_sort"].mesh_sort_state_words, [ll]),
    ):
        fn.restype = ll
        fn.argtypes = args
    _kernel_libs = libs
    return libs


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_stage_args(adj, nw, sources, max_weight: int, capacity: int,
                      pack_out: bool) -> None:
    """What every search entry takes: int32 contiguous operands on one
    device, a capacity >= 1 and a bound the layouts can hold."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if adj.dtype != torch.int32 or adj.dim() != 2:
        raise ValueError("adj must be an int32 [N+1, deg] adjacency")
    if sources.dtype != torch.int32 or sources.dim() != 1:
        raise ValueError("sources must be a 1-D int32 tensor")
    operands = (adj, sources) if nw is None else (adj, nw, sources)
    if nw is not None and (nw.dtype != torch.int32 or nw.shape != adj.shape):
        raise ValueError("nw must be int32 with the shape of nbr")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("adj, nw and sources must be contiguous")
    if any(t.device != adj.device for t in operands):
        raise ValueError("adj, nw and sources must be on one device")
    bound = ADJ_W_MASK if nw is None else int(INF)
    if not 0 <= max_weight < bound:
        raise ValueError(f"max_weight must be in [0, {bound}) for this adjacency")
    if nw is None and adj.shape[0] > (1 << (31 - ADJ_W_BITS)):
        raise ValueError("node ids exceed the packed adjacency layout")
    if pack_out and (max_weight >= DIST_CAP or adj.shape[0] >= (1 << (31 - DIST_BITS))):
        raise ValueError("packed rows need max_weight < 126 and node ids < 2^24")


def pool_sssp(
    adj: torch.Tensor,
    sources: torch.Tensor,
    max_weight: int,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bounded balls of ``sources`` over the packed adjacency ``adj``
    (int32 [N+1, deg], row N the sentinel row); sources are ids in [0, N].

    Returns (packed rows int32 [S, C], overflow uint8 [S]) on the input's
    device, under the module's output contract.  A CUDA tensor launches
    ``csrc/sssp_pool.cu`` when deg == 4 and C is in ``CAPACITIES``, else the
    wide kernel's pool schedule, on the current stream without
    synchronizing; a CPU tensor runs :func:`pool_sssp_plain`."""
    _check_stage_args(adj, None, sources, max_weight, capacity, True)
    if adj.device.type == "cpu":
        key, _, over = pool_sssp_plain(adj, sources, max_weight, capacity)
        return key, over
    if adj.shape[1] != 4 or capacity not in CAPACITIES:
        key, _, over = wide_sssp(adj, sources, max_weight, capacity)
        return key, over
    if adj.device.type != "cuda":
        raise ValueError(f"unsupported device {adj.device}")
    lib = build_kernels()["sssp_pool"]
    S, dev = sources.shape[0], adj.device
    # one allocation for the rows and the flags behind them
    buf = torch.empty((S * capacity + (S + 3) // 4,), dtype=torch.int32, device=dev)
    out = buf[: S * capacity].view(S, capacity)
    over = buf[S * capacity:].view(torch.uint8)[:S]
    if S == 0:
        return out, over
    # The launch sets the device itself, so no device guard here; the raw
    # handle of the current stream spares building a torch.cuda.Stream.
    err = lib.sssp_pool_launch(
        adj.data_ptr(), adj.shape[0] - 1, sources.data_ptr(), S,
        int(max_weight), capacity, out.data_ptr(), over.data_ptr(),
        dev.index, torch._C._cuda_getCurrentRawStream(dev.index),
    )
    if err != 0:
        raise RuntimeError(f"sssp_pool_launch failed: cudaError {err}")
    KERNEL_LAUNCHES["sssp_pool"] += 1
    return out, over


def pool_kernel_attributes(capacity: int) -> tuple[int, int]:
    """(registers per thread, spilled local bytes per thread) of the
    register kernel at ``capacity`` (``cudaFuncGetAttributes``; builds the
    kernels, needs CUDA)."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = build_kernels()["sssp_pool"].sssp_pool_attributes(
        capacity, ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"sssp_pool_attributes failed: cudaError {err}")
    return regs.value, local.value


def wide_sssp(
    adj: torch.Tensor,
    sources: torch.Tensor,
    max_weight: int,
    capacity: int,
    *,
    nw: torch.Tensor | None = None,
    pack_out: bool = True,
    schedule: str = "pool",
):
    """The wide kernel (``csrc/sssp_wide.cu``): bounded balls at any
    capacity 1 <= C <= MAX_WIDE_CAPACITY over the packed adjacency
    ``adj`` (int32 [N+1, deg]) or, with ``nw``, the unpacked pair
    ``(adj, nw)``.

    Returns (rows, dist, overflow uint8 [S]) under the module's output
    contract: packed rows and ``dist=None`` with ``pack_out``, else the
    nodes and distances (empty slots ``(sentinel, INF)``).  ``schedule``
    "pool" claims sources from a device cursor, "batch" assigns them to
    warps statically (the reference's batch schedule); the rows are the
    same.  A CUDA tensor enqueues the kernel's two tiers (a warp per source
    up to ``WARP_TIER_CAPACITY`` members, then the larger balls) on the
    current stream without synchronizing, and counts one launch; a CPU
    tensor runs :func:`pool_sssp_plain`."""
    _check_stage_args(adj, nw, sources, max_weight, capacity, pack_out)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule: {schedule!r}")
    if capacity > MAX_WIDE_CAPACITY:
        raise ValueError(f"capacity {capacity} above {MAX_WIDE_CAPACITY}")
    if adj.device.type == "cpu":
        return pool_sssp_plain(
            adj, sources, max_weight, capacity, nw=nw, pack_out=pack_out
        )
    if adj.device.type != "cuda":
        raise ValueError(f"unsupported device {adj.device}")
    lib = build_kernels()["sssp_wide"]
    S, C, dev = sources.shape[0], capacity, adj.device
    out_a = torch.empty((S, C), dtype=torch.int32, device=dev)
    out_b = None if pack_out else torch.empty((S, C), dtype=torch.int32, device=dev)
    over = torch.empty((S,), dtype=torch.uint8, device=dev)
    if S == 0:
        return out_a, out_b, over
    with torch.cuda.device(dev):
        words = lib.sssp_wide_scratch_words(C, S)
        if words < 0:
            raise RuntimeError(f"sssp_wide_scratch_words failed: cudaError {-words}")
        scratch = torch.empty((words,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sssp_wide_launch(
            adj.data_ptr(), _ptr(nw), adj.shape[0] - 1, adj.shape[1],
            sources.data_ptr(), S, int(max_weight), C, out_a.data_ptr(),
            _ptr(out_b), over.data_ptr(), int(schedule == "pool"),
            scratch.data_ptr(), words, stream,
        )
    if err != 0:
        raise RuntimeError(f"sssp_wide_launch failed: cudaError {err}")
    KERNEL_LAUNCHES["sssp_wide"] += 1
    return out_a, out_b, over


def _relax_round(adj, nw, nodes, dist, max_weight: int):
    """One bounded relaxation round on an int64 [S, C] working set with
    empty slots (sentinel, INF) (the torch form of the reference package's
    ``_relax_round``): expansion gather, per-node min-dedup by a
    (node << 32 | dist) sort, compaction to the C closest by a
    (dist << 32 | node) sort.  Returns (nodes, dist, overflow): overflow
    marks rows holding a (C+1)-th valid entry."""
    S, C = nodes.shape
    sentinel = adj.shape[0] - 1
    live = (dist <= max_weight)[:, :, None]
    if nw is None:
        a = adj[nodes]  # [S, C, deg]
        nn, w = a >> ADJ_W_BITS, a & ADJ_W_MASK
    else:
        nn, w = adj[nodes], nw[nodes]
    nn = torch.where(live, nn.long(), sentinel)
    nd = dist[:, :, None] + w
    ok = (nn != sentinel) & (nd <= max_weight)
    all_n = torch.cat([nodes, torch.where(ok, nn, sentinel).reshape(S, -1)], 1)
    all_d = torch.cat([dist, torch.where(ok, nd, int(INF)).reshape(S, -1)], 1)

    key, _ = torch.sort((all_n << 32) | all_d, dim=1)
    sn, sd = key >> 32, key & 0xFFFFFFFF
    first = torch.ones_like(sn, dtype=torch.bool)
    first[:, 1:] = sn[:, 1:] != sn[:, :-1]
    keep = first & (sd <= max_weight) & (sn != sentinel)
    sd = torch.where(keep, sd, int(INF))
    sn = torch.where(keep, sn, sentinel)

    key, _ = torch.sort((sd << 32) | sn, dim=1)
    dn, dd = key & 0xFFFFFFFF, key >> 32
    return dn[:, :C], dd[:, :C], dd[:, C] <= max_weight


def _fixpoint(adj, nw, nodes, dist, over, max_weight: int) -> None:
    """Relaxation rounds on the rows of ``nodes``/``dist``/``over`` (in
    place) until each row stops changing (fixpoint) or overflows.  A row
    still changing after max_weight + 2 rounds is flagged overflow, the
    reference's defensive round cap."""
    active = torch.nonzero(~over).flatten()
    for _ in range(max_weight + 2):
        if active.numel() == 0:
            break
        nn, nd, ov = _relax_round(adj, nw, nodes[active], dist[active], max_weight)
        changed = (nn != nodes[active]).any(1) | (nd != dist[active]).any(1)
        nodes[active], dist[active], over[active] = nn, nd, ov
        active = active[changed & ~ov]
    over[active] = True  # round cap


def pool_sssp_plain(
    adj: torch.Tensor,
    sources: torch.Tensor,
    max_weight: int,
    capacity: int,
    *,
    nw: torch.Tensor | None = None,
    pack_out: bool = True,
):
    """Plain torch version of the search stage (:func:`pool_sssp` and
    :func:`wide_sssp`, either schedule): any capacity, any degree, the
    packed adjacency or the unpacked pair ``(adj, nw)``, packed or
    unpacked rows.  Each row runs relaxation rounds until its working set
    stops changing or overflows; rows go in chunks of about
    ``_PLAIN_CHUNK`` working-set elements.  Returns (rows, dist or None,
    overflow uint8 [S]) as :func:`wide_sssp` does."""
    _check_stage_args(adj, nw, sources, max_weight, capacity, pack_out)
    S, C = sources.shape[0], capacity
    sentinel = adj.shape[0] - 1
    dev = adj.device
    src = sources.long()
    real = (src >= 0) & (src <= sentinel)  # the kernels flag other ids
    nodes = torch.full((S, C), sentinel, dtype=torch.int64, device=dev)
    dist = torch.full((S, C), int(INF), dtype=torch.int64, device=dev)
    nodes[:, 0] = torch.where(real, src, sentinel)
    dist[:, 0] = 0
    over = ~real
    rows = max(1, _PLAIN_CHUNK // (C * (adj.shape[1] + 1)))
    for lo in range(0, S, rows):
        part = slice(lo, lo + rows)  # views: _fixpoint writes through
        _fixpoint(adj, nw, nodes[part], dist[part], over[part], max_weight)
    if pack_out:
        capped = torch.where(dist <= max_weight, dist, DIST_CAP)
        return ((nodes << DIST_BITS) | capped).int(), None, over.to(torch.uint8)
    return nodes.int(), dist.int(), over.to(torch.uint8)


def _check_compact_args(rows, over, budget: int) -> None:
    if rows.dtype != torch.int32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError("rows must be contiguous int32 [S, C] packed rows")
    if over.dtype != torch.uint8 or over.shape != rows.shape[:1]:
        raise ValueError("over must be uint8 [S]")
    if over.device != rows.device:
        raise ValueError("rows and over must be on one device")
    if budget < 0:
        raise ValueError("budget must be >= 0")


def compact_rows(
    rows: torch.Tensor,
    over: torch.Tensor,
    sentinel: int,
    max_weight: int,
    budget: int,
):
    """Valid-slot compaction of packed stage rows (``csrc/sssp_compact.cu``).

    A slot is valid when its node is not the sentinel, 1 <= dist <=
    max_weight and its row did not overflow.  Returns (values int32
    [budget]: the valid slots in row-major order, filled up to
    min(total, budget); per-row counts, int8 when C <= 127 else int32;
    total, an int64 [1] tensor).  A CUDA tensor launches the kernel on the
    current stream without synchronizing; a CPU tensor runs
    :func:`compact_rows_plain`."""
    _check_compact_args(rows, over, budget)
    if rows.device.type == "cpu":
        return compact_rows_plain(rows, over, sentinel, max_weight, budget)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    lib = build_kernels()["sssp_compact"]
    S, C = rows.shape
    dev = rows.device
    int8 = C <= 127
    vals = torch.empty((budget,), dtype=torch.int32, device=dev)
    counts = torch.empty((S,), dtype=torch.int8 if int8 else torch.int32, device=dev)
    if S == 0:
        return vals, counts, torch.zeros((1,), dtype=torch.int64, device=dev)
    total = torch.empty((1,), dtype=torch.int64, device=dev)
    state = torch.empty(
        (lib.sssp_compact_state_words(S, C),), dtype=torch.int64, device=dev
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sssp_compact_launch(
            rows.data_ptr(), over.data_ptr(), S, C, int(sentinel),
            int(max_weight), int(budget), vals.data_ptr(), counts.data_ptr(),
            int(int8), state.data_ptr(), total.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"sssp_compact_launch failed: cudaError {err}")
    KERNEL_LAUNCHES["sssp_compact"] += 1
    return vals, counts, total


def compact_rows_plain(rows, over, sentinel: int, max_weight: int, budget: int):
    """Plain torch version of :func:`compact_rows`: the same filter, with a
    cumulative sum for the positions."""
    _check_compact_args(rows, over, budget)
    S, C = rows.shape
    node, dist = rows >> DIST_BITS, rows & DIST_CAP
    valid = (node != sentinel) & (dist >= 1) & (dist <= max_weight)
    valid &= (over == 0)[:, None]
    flat = valid.reshape(-1)
    pos = torch.cumsum(flat.long(), 0) - 1
    keep = flat & (pos < budget)
    vals = torch.zeros((budget,), dtype=torch.int32, device=rows.device)
    vals[pos[keep]] = rows.reshape(-1)[keep]
    counts = valid.sum(1, dtype=torch.int32)
    total = counts.sum(dtype=torch.int64).reshape(1)
    return vals, counts.to(torch.int8 if C <= 127 else torch.int32), total


class DispatchedStage:
    """Handle for a launched search stage (:func:`batched_bounded_sssp_dispatch`):
    the kernel runs on the device while the host works; ``fetch()`` and
    ``fetch_candidates()`` synchronize and copy the results back."""

    def __init__(self, rows: torch.Tensor, dist: torch.Tensor | None,
                 over: torch.Tensor, events: tuple | None = None,
                 compacted: tuple | None = None, budget: int = 0):
        self._rows = rows
        self._dist = dist
        self._over = over
        self._events = events
        self._compacted = compacted
        self._budget = budget
        self.bytes_fetched = 0  # device -> host bytes of the last fetch

    def _fetch_rows(self):
        """(rows [S, C] int32, dist [S, C] int32 or None for packed rows),
        blocking."""
        rows = self._rows.cpu().numpy()
        return rows, None if self._dist is None else self._dist.cpu().numpy()

    def fetch(self):
        """(rows [S, C] int32, dist [S, C] int32 or None for packed rows,
        overflow [S] bool), blocking."""
        rows, dist = self._fetch_rows()
        return rows, dist, self._over.cpu().numpy().astype(bool)

    def fetch_candidates(self, dg, sources, in_mask):
        """(Candidates, overflow [S] bool), blocking, in row-major triple
        order.  A compacted stage whose valid count fits its budget
        downloads only the valid slots and their row counts; otherwise
        packed rows go through the native extraction and unpacked rows
        through the numpy one."""
        compact = None
        with span("search.fetch") as sp:
            over = self._over.cpu().numpy().astype(bool)
            self.bytes_fetched = over.nbytes
            if self._compacted is not None:
                vals, counts, total = self._compacted
                n = int(total.item())
                self.bytes_fetched += total.element_size()
                if n <= self._budget:
                    compact = vals[:n].cpu().numpy(), counts.cpu().numpy()
                    self.bytes_fetched += compact[0].nbytes + compact[1].nbytes
            if compact is None:
                rows, dist = self._fetch_rows()
                self.bytes_fetched += rows.nbytes + (0 if dist is None else dist.nbytes)
            sp.add(bytes=self.bytes_fetched)
        with span("search.extract") as sp:
            if compact is not None:
                cands = _compact_candidates(dg, *compact, sources, in_mask)
            else:
                cands = extract_candidates(dg, rows, dist, sources, ~over, in_mask)
            sp.add(candidates=len(cands))
        return cands, over

    def kernel_seconds(self) -> float | None:
        """Device time of the launch (CUDA events), after a fetch; None on
        the CPU."""
        if self._events is None:
            return None
        start, end = self._events
        end.synchronize()
        return start.elapsed_time(end) / 1e3


def _compact_candidates(dg, vals, counts, sources, in_mask) -> Candidates:
    """Candidates from a compact download: ``vals`` holds the valid packed
    slots row by row, ``counts`` the number per row."""
    rows = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    node = (vals >> DIST_BITS).astype(np.int32)
    dist = (vals & DIST_CAP).astype(np.int64)
    keep = np.asarray(in_mask, dtype=bool)[node]
    u = dg.unmap_nodes(np.asarray(sources, dtype=np.int32)[rows[keep]])
    v = dg.unmap_nodes(node[keep])
    return Candidates(u.astype(np.int64), v.astype(np.int64), dist[keep])


def _check_sources(dg: DeviceGraph, sources: np.ndarray) -> None:
    if len(sources) and (sources.min() < 0 or sources.max() > dg.n_nodes):
        raise ValueError("source id outside [0, n_nodes]")


def batched_bounded_sssp_dispatch(
    dg: DeviceGraph,
    sources: np.ndarray,
    max_weight: int,
    capacity: int,
    device: torch.device | str,
    schedule: str = "pool",
    compact: bool = False,
    budget: int | None = None,
) -> DispatchedStage:
    """Launch one search stage on ``device`` without waiting: uploads the
    sources (the adjacency is uploaded once per graph and layout),
    launches, and returns the handle.

    Packed rows and the packed adjacency are used wherever the graph and
    bound allow (:func:`_can_pack_out`, :func:`_can_pack_adj`), the
    unpacked ones otherwise.  With ``compact`` (packed rows only) the
    valid slots are also compacted on the device, into a ``budget``-sized
    buffer (default: a quarter of the slots, at least 1024);
    ``fetch_candidates`` then downloads only those when they fit."""
    sources = np.ascontiguousarray(sources, dtype=np.int32)
    _check_sources(dg, sources)
    pack_out = _can_pack_out(dg, max_weight)
    if compact and not pack_out:
        raise ValueError("compaction needs packed rows (max_weight < 126)")
    device = torch.device(device)
    if _can_pack_adj(dg, max_weight):
        adj, nw = dg.device_buffers(device), None
    else:
        adj, nw = dg.device_buffers(device, adj_packed=False)
    src = torch.from_numpy(sources).to(device)
    events = None
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
        events[0].record(stream)
    if schedule == "pool" and pack_out and nw is None:
        rows, over = pool_sssp(adj, src, max_weight, capacity)
        dist = None
    else:
        rows, dist, over = wide_sssp(
            adj, src, max_weight, capacity, nw=nw, pack_out=pack_out,
            schedule=schedule,
        )
    compacted = None
    if compact:
        slots = len(sources) * capacity
        budget = min(max(1024, slots // 4) if budget is None else budget, slots)
        compacted = compact_rows(rows, over, dg.sentinel, max_weight, budget)
    if events is not None:
        events[1].record(stream)
    return DispatchedStage(rows, dist, over, events, compacted, budget or 0)


def batched_bounded_sssp(
    dg: DeviceGraph,
    sources: np.ndarray,
    max_weight: int,
    capacity: int = 4,
    return_packed: bool = False,
    schedule: str = "pool",
    *,
    device: torch.device | str,
):
    """All-targets bounded shortest paths from each source.

    Returns (nodes [S, C], dist [S, C], overflow [S]): per source the set
    of reachable nodes with distance <= max_weight (sentinel-padded, dist
    INF), and whether the ball exceeded the capacity.  With
    ``return_packed`` and a packed-row stage the first item is the packed
    row matrix and the second is None.  ``schedule`` is "pool" or
    "batch"; both give the same rows."""
    sources = np.asarray(sources, dtype=np.int32)
    rows, dist, over = batched_bounded_sssp_dispatch(
        dg, sources, max_weight, capacity, device, schedule=schedule
    ).fetch()
    if dist is not None or return_packed:
        return rows, dist, over
    return (*unpack_rows(rows), over)


def unpack_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(nodes, dist) of packed rows, empty slots (sentinel, INF)."""
    dist = rows & DIST_CAP
    np.putmask(dist, dist == DIST_CAP, INF)
    return rows >> DIST_BITS, dist


def extract_candidates(dg, rows, dist, sources, done, in_mask) -> Candidates:
    """Candidates of the ``done`` rows: packed rows (``dist`` None) through
    the native extraction, unpacked ones through numpy."""
    if dist is None:
        return extract_packed_candidates(dg, rows, sources, done, in_mask)
    return extract_unpacked_candidates(dg, rows, dist, sources, done, in_mask)


def extract_unpacked_candidates(
    dg: DeviceGraph,
    nodes: np.ndarray,  # int32 [S, C] device-numbered, sentinel-padded
    dist: np.ndarray,  # int32 [S, C], INF on empty slots
    sources: np.ndarray,  # int32 [S] device-numbered
    done: np.ndarray,  # bool [S]: rows to extract (non-overflowed)
    in_mask: np.ndarray,  # bool/int8 [n_nodes] device-numbered
) -> Candidates:
    """(src, dst, dist) columns from unpacked rows in row-major order:
    the numpy filter (1 <= dist < INF, in_mask) and id translation."""
    dn, dd = nodes[done], dist[done]
    srcs = np.asarray(sources)[done]
    valid = (dn != dg.sentinel) & (dd >= 1) & (dd < INF)
    mask = np.asarray(in_mask, dtype=bool)
    valid &= mask[np.minimum(dn, len(mask) - 1)]
    s_idx, c_idx = np.nonzero(valid)
    return Candidates(
        dg.unmap_nodes(srcs[s_idx]).astype(np.int64),
        dg.unmap_nodes(dn[s_idx, c_idx]).astype(np.int64),
        dd[s_idx, c_idx].astype(np.int64),
    )


def extract_packed_candidates(
    dg: DeviceGraph,
    packed_key: np.ndarray,  # int32 [S, C] (node << DIST_BITS) | dist
    sources: np.ndarray,  # int32 [S] device-numbered
    done: np.ndarray,  # bool [S]: rows to extract (non-overflowed)
    in_mask: np.ndarray,  # bool/int8 [n_nodes] device-numbered
) -> Candidates:
    """Native parallel (src, dst, dist) extraction from the packed kernel
    result (native/extract.cpp): filter (1 <= dist < cap, in_mask) and
    translate ids back to original numbering in one sweep, replacing the
    numpy unpack/nonzero/gather chain."""
    from .. import native

    lib = native.load()
    S, C = packed_key.shape
    packed_key = np.ascontiguousarray(packed_key, dtype=np.int32)
    sources = np.ascontiguousarray(sources, dtype=np.int32)
    done8 = np.ascontiguousarray(done, dtype=np.int8)
    mask8 = np.ascontiguousarray(in_mask, dtype=np.int8)
    to_orig = (
        np.ascontiguousarray(dg.to_orig, dtype=np.int32)
        if dg.to_orig is not None
        else None
    )
    buf_ptr = ctypes.POINTER(ctypes.c_longlong)()
    n = int(
        lib.extract_packed_triples(
            S,
            C,
            native.as_i32_ptr(packed_key),
            native.as_i32_ptr(sources),
            native.as_i8_ptr(done8),
            native.as_i8_ptr(mask8),
            native.as_i32_ptr(to_orig) if to_orig is not None else None,
            DIST_BITS,
            min(os.cpu_count() or 1, 16),
            ctypes.byref(buf_ptr),
        )
    )
    if n < 0:
        raise MemoryError("extract_packed_triples allocation failed")
    return _wrap_native_triples(lib, buf_ptr, n)


def _wrap_native_triples(lib, buf_ptr, n) -> Candidates:
    """Zero-copy Candidates over a native ``[src..., dst..., dist...]``
    triple buffer: the columns are views and ownership rides a weakref
    finalizer on the base array, so ``free_i64_buffer`` fires only after
    the last column view dies (slices keep the base array as their
    ``.base``)."""
    import weakref

    if n <= 0:
        lib.free_i64_buffer(buf_ptr)
        z = np.empty(0, dtype=np.int64)
        return Candidates(z, z.copy(), z.copy())
    flat = np.ctypeslib.as_array(buf_ptr, shape=(3 * n + 1,))
    weakref.finalize(flat, lib.free_i64_buffer, buf_ptr)
    return Candidates(flat[0:n], flat[n : 2 * n], flat[2 * n : 3 * n])


def host_dijkstra_candidates(
    dg: DeviceGraph,
    sources: np.ndarray,
    max_weight: int,
    in_mask: np.ndarray,
    n_threads: int | None = None,
) -> Candidates:
    """Native C++ bounded Dijkstra fan-out: (src, dst, dist) columns.

    The host half of the hybrid search: the device kernel handles the bulk
    of sources; the heavy tail (capacity overflows) and dense tangles run
    here.  Also the whole search when no device is used.
    """
    return _native_dijkstra_candidates(
        dg, sources, max_weight, in_mask, n_threads,
        fn_name="bounded_dijkstra_candidates_auto",
    )


def _native_dijkstra_candidates(
    dg, sources, max_weight, in_mask, n_threads, fn_name: str
) -> Candidates:
    """Shared runner for the growable-buffer native Dijkstra variants:
    triples are collected in thread-local C++ vectors (exact memory, no
    preallocation or overflow retry) and returned as candidate columns."""
    from .. import native

    lib = native.load()
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, max(1, len(sources) // 256))
    n_threads = max(1, n_threads)
    sources = np.ascontiguousarray(sources, dtype=np.int64)
    mask = np.zeros(dg.n_nodes + 1, dtype=np.int8)
    mask[: len(in_mask)] = in_mask
    nbr = np.ascontiguousarray(dg.nbr, dtype=np.int32)
    nw = np.ascontiguousarray(dg.nw, dtype=np.int32)
    buf_ptr = ctypes.POINTER(ctypes.c_longlong)()
    n = int(
        getattr(lib, fn_name)(
            dg.n_nodes,
            dg.deg_pad,
            native.as_i32_ptr(nbr),
            native.as_i32_ptr(nw),
            len(sources),
            native.as_ll_ptr(sources),
            max_weight,
            native.as_i8_ptr(mask),
            n_threads,
            ctypes.byref(buf_ptr),
        )
    )
    if n < 0:
        raise MemoryError(f"{fn_name} allocation failed")
    return _wrap_native_triples(lib, buf_ptr, n)


def reference_dijkstra_candidates(
    dg: DeviceGraph,
    sources: np.ndarray,
    max_weight: int,
    in_mask: np.ndarray,
    n_threads: int | None = None,
) -> Candidates:
    """Independent reference-design baseline: per-source binary heap +
    hashmap distance map (the reference's default StdBinaryHeap +
    HashbrownHashMap pair, upstream src/implementation/mod.rs:62-103).
    Selected by ``host_strategy="heap"``.
    """
    return _native_dijkstra_candidates(
        dg, sources, max_weight, in_mask, n_threads,
        fn_name="reference_dijkstra_candidates",
    )


def sssp_reference_host(
    dg: DeviceGraph, source: int, max_weight: int
) -> dict[int, int]:
    """Host Dijkstra oracle (heapq) for testing the device kernel."""
    import heapq

    dist = {source: 0}
    heap = [(0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist.get(u, INF):
            continue
        for j in range(dg.deg_pad):
            v = int(dg.nbr[u, j])
            if v == dg.n_nodes:
                continue
            nd = d + int(dg.nw[u, j])
            if nd <= max_weight and nd < dist.get(v, INF):
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist
