"""Smoke run of matchtigs_tpu_torch on one NVIDIA GPU.

Drives the port's main paths, greedy and optimal matchtigs, through its
CLI on the repository's flagship dataset (synthetic 10 Mbp pangenome, 7
strains, 1% mutations, repeats, k=31), then pathtigs and eulertigs, the
C ABI, and the CLI from the link-annotated inputs BCALM2 and GGCAT write
(``--bcalm-in``, ``--gfa-in``), after building every kernel from the
sources in the checkout and holding each against its plain PyTorch
version; then greedy matchtigs on the same pangenome at k=63 (deep balls),
on the 60 Mbp pangenome and on a C. elegans-sized one past 2^24 nodes:

- ``dataset``: the flagship made on the card
  (``testing.make_pangenome_store(device=...)``) into this run's own
  cache, held to the JAX generator's sha256 and counts;
- ``kernel_vs_plain`` / ``kernel_main_shape``: the register kernel
  (``csrc/sssp_pool.cu``) on two graphs and on all flagship device sources
  (one device operation, checked; registers and spilled bytes per
  capacity); ``pool_capacity_case``: ``pool_sssp`` at C=16 (the register
  kernel) and 64 (the wide kernel's warp tier) on the sources that
  overflow C=4;
- ``wide_vs_plain``: the wide kernel (``csrc/sssp_wide.cu``, a warp tier
  and a spill tier), both schedules, packed and unpacked, on the sources
  that overflow C=4; ``wide_ball_census``: those sources' ball sizes and
  distance levels, from the C=1024 rows;
- ``compact_vs_full``: the compaction kernel (``csrc/sssp_compact.cu``) on
  the C=4 rows of all device sources, at C=1, 128 and 5000 (rows longer
  than its tile) with budgets below the total (``compact_case``), and the
  compact candidate download against the full one;
- ``cli_device``: the default CLI (one register-kernel launch);
- ``greedy_device_vs_host``: library runs of both engines (the in-path
  stage kernel, one cold call after the upload, beside the warm loop's);
- ``cli_ladder``: the CLI with ``--sssp-overflow-mode ladder`` (the wide
  kernel serves the stages at C >= 256);
- ``cli_matchtigs``: the optimal-matchtigs CLI with its fasta, duplication
  bitvector and matching files (one register-kernel launch), against
  library runs of the device and host engines;
- ``cli_pathtigs_eulertigs``: one CLI run writing pathtigs and eulertigs
  (host-only: no kernel launch), each spelling every k-mer exactly once;
- ``capi_device``: the port's C library (``native/capi_embed.c``, built
  with gcc and loaded into this interpreter with ctypes) over the
  flagship's topology as merge calls, algorithm ids 1-5 (ids 4 and 5 on
  the card: one register-kernel launch each), against
  ``TigGraphBuilder.compute_tigs`` with the host engine;
- ``links_inputs``: the flagship's links (``testing.graph_links`` of its
  overlap graph) written as BCALM2 and as gzipped GFA (set-up);
- ``cli_bcalm_in``: the greedytigs CLI from fasta and from BCALM2 back to
  back (one register-kernel launch each), the BCALM2 fasta equal to the
  host engine's walks on the graph ``build_bigraph_from_links`` makes from
  the links written to the file, that graph equal to the overlap graph up
  to node numbering once the nodes no link can name are split
  (``testing.split_linkless_nodes``), the exact k-mer set, and the
  register kernel on the link-built graph's device sources against its
  plain version, beside the overlap graph's;
- ``cli_gfa_in``: one CLI run from the GFA (k from its header) writing
  greedytigs fasta and GFA, matchtigs and eulertigs (two register-kernel
  launches): the greedytigs fasta equal to ``cli_bcalm_in``'s, its GFA
  read back equal to it, each output spelling the input k-mer set,
  eulertigs each k-mer once, matchtigs no longer than greedytigs;
- ``cli_k131``: the CLI at k=131 on a string-generated input (unpacked
  adjacency and rows);
- ``mesh_sort_vs_plain``: the mesh's radix sort and merge-split kernels
  (``csrc/mesh_sort.cu``) on the flagship's acceptance keys and edge cases
  (sizes around the sort's tile, signed keys, constant digits);
- ``mesh_stage``: the sharded search stage on a 4-shard mesh of the one
  card, both schedules, against the single-device stage;
- ``mesh_accept``: the sharded acceptance sort on that mesh, and the accept
  scan over it against the host accept;
- ``dataset_k63``: the flagship's pangenome at k=63 made on the card
  (two-word keys), held to the JAX generator's sha256 and counts;
- ``cli_device_k63``: the greedytigs CLI on it at first capacity 16 (one
  register-kernel launch), its fasta equal to the host engine's walks and
  spelling the input k-mer set, and the register kernel at C=16 on all its
  device sources against its plain version; ``cli_ladder_k63``: the same
  with ``--sssp-overflow-mode ladder`` (the wide kernel from C=64 up), and
  ``pool_sssp`` at C=64 and 1024 on the sources that overflow C=16 against
  its plain version; ``wide_ball_census_k63``: those sources' balls;
- ``dataset_60m``: the 60 Mbp pangenome of ``bench.py`` made on the card
  (10.2 M nodes), held to the counts of BASELINE.md and to its sha256,
  with its peak device and host memory;
- ``cli_device_60m``: the default greedytigs CLI on it (one register-kernel
  launch), its fasta equal to the host engine's walks and spelling the
  input k-mer set, and the register kernel at that shape against its plain
  version; ``cli_bcalm_in_60m``: the same set written as BCALM2 and the
  greedytigs CLI from it, with ``cli_bcalm_in``'s gates and readings;
  ``cli_matchtigs_60m``: the optimal-matchtigs CLI on it (one
  register-kernel launch), exact k-mer set, no longer than greedy's, with
  its instance sizes and the front's laps;
- ``dataset_celegans``: BASELINE.md:33's config 3 at the length of the C.
  elegans reference assembly (100.3 Mbp) as the same pangenome, made on
  the card once the 60 Mbp phase's memory is freed: about 17.1 M nodes,
  past the 2^24 node ids of the packed rows and adjacency (checked, with
  both packing predicates False), its unitigs spelling each k-mer of the
  set exactly once, the port's own sha256;
- ``celegans_stage``: the default stage there, the wide kernel at C=4 over
  the unpacked adjacency and rows on every device source, against its
  plain version on the card, with its times, bound and ball census, then
  the stage's dispatch (one ``sssp_wide`` launch, no ``sssp_pool``) and
  its download; ``greedy_celegans``: library runs of the device and host
  engines in alternation, equal walks; ``cli_device_celegans``: the
  default greedytigs CLI on it (one ``sssp_wide`` launch), its fasta equal
  to the host engine's walks and spelling the input k-mer set;
- ``matchtigs_celegans_collapse``: the optimal front's candidates there
  from the device engine (one ``sssp_wide`` launch) and the host engine,
  equal as sets, and their collapses into matching edges, the device
  engine's on the route its matching-id count picks (up to 2^26 ids the
  packed route, at 24-bit ids here), the host engine's on the argsort
  route: equal in all
  five columns; ``cli_matchtigs_celegans``: the optimal-matchtigs CLI from
  the same fasta (one ``sssp_wide`` launch), spelling the input k-mer set,
  no longer than greedy, with its instance sizes and the front's laps;
- ``mesh_two_process``, last: two processes of one gloo group, both on the
  card, run greedy matchtigs with ``use_mesh=True`` (this script with
  ``--mesh-worker``); walks equal in both and to the host engine's.  Once
  a child process has used the card, ``torch.profiler`` sees few or none
  of this process's device events, so every profiled phase comes first.

Every CLI phase also prints the CLI's own INFO laps (``load_s``: read and
graph build; ``compute_s``; ``write_s``), taken by a log handler attached
for the run.

Each kernel's ``launches`` in the kernels line is read from path runs
with the counts set to 0 just before each: ``sssp_pool`` from
``cli_device``, ``cli_matchtigs``, ``capi_device``, ``cli_bcalm_in``,
``cli_gfa_in``, ``mesh_stage``, ``mesh_two_process``, ``cli_device_k63``,
``cli_ladder_k63``, ``cli_device_60m``, ``cli_bcalm_in_60m`` and
``cli_matchtigs_60m``, ``sssp_wide`` from
``cli_ladder``, ``cli_k131``, ``mesh_stage`` (batch),
``cli_ladder_k63``, ``greedy_celegans`` (device engine),
``cli_device_celegans``, ``matchtigs_celegans_collapse`` (device engine)
and ``cli_matchtigs_celegans``, ``sssp_compact`` from the compact dispatch
of ``compact_vs_full``, ``mesh_sort`` and ``mesh_merge_split`` from
``mesh_two_process``.  Each kernel's ``bound_ms`` is the larger of its
bytes (inputs read once, outputs written once) over the card's memory
rate and its operations over the card's peak, from this run's inputs.
Beside the event times of ``sssp_pool`` at the main shape and at C=16 and
64, ``sssp_wide`` (packed, C=16, 256 and 1024 in the pool schedule, C=256
in the batch schedule), ``sssp_compact``, ``mesh_sort``,
``mesh_merge_split`` and their library calls,
``*_device_ms`` is the device time of the call's kernels alone
(``torch.profiler``, with a per-kernel breakdown: the wide kernel's two
tiers show as two kernels) and ``host_enqueue_ms`` the host's time to
enqueue one call.

    python3 chip_smoke.py [--genome-length N]

Phases print one JSON line each, with their seconds; any failure exits
non-zero, and so does a worker that fails or a collective that times out.  The last three lines are the kernels, the GPU's name and power
limit, and a JSON status object.  Needs a CUDA device; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import hashlib
import json
import logging
import math
import os
import resource
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
K = 31
N_STRAINS = 7
MUTATION_RATE = 0.01
SEED = 0
FLAGSHIP_LENGTH = 10_000_000
# sha256 over (codes uint8, offsets int64, k-mers uint64) of the flagship as
# the JAX package's numpy generator makes it (matchtigs_tpu.testing), and its
# counts (PERF.md section 4)
FLAGSHIP_SHA256 = "4c25c928c2f744defbac93545830ec5ba7469e269c37ce51271dff0444bb0f80"
FLAGSHIP_COUNTS = dict(unitigs=1_318_008, kmers=25_161_366, nodes=1_724_514,
                       sources=836_785, device_sources=753_819)
# the 60 Mbp pangenome of bench.py:63-69 (7 strains, 1% mutations, repeats,
# k=31, seed 0), its counts in BASELINE.md:156-158, and the sha256 of the
# torch generator's output on the card, whose counts are those (the JAX
# generator's digest at this size was not computed: it needs tens of GiB of
# host memory and about an hour)
SCALE60M_LENGTH = 60_000_000
SCALE60M_COUNTS = dict(unitigs=7_843_250, kmers=150_495_678, nodes=10_238_350,
                       sources=4_966_834)
SCALE60M_SHA256 = "c6b2b3eb29a5f89ca51ddaf5272efe8050a94672ddf8147a4cdf1bf4b2fc84e2"
# BASELINE.md:33's config 3 (C. elegans, k=31, greedy matchtigs) at the
# length of the C. elegans reference assembly WBcel235, as the flagship's
# pangenome (7 strains, 1% mutations, repeats, seed 0): the smallest real
# size whose node ids (about 17.1 M) do not fit the 24 bits of the packed
# rows and adjacency (NODE_ID_LIMIT), so the default stage runs the wide
# kernel over the unpacked (nbr, nw) pair with unpacked rows
CELEGANS_LENGTH = 100_286_401
NODE_ID_LIMIT = 1 << 24
# its counts and the sha256 (as dataset_digest hashes) of the torch
# generator's output on the card (no JAX digest: the JAX generator at this
# size needs tens of GiB of host memory)
CELEGANS_COUNTS = dict(unitigs=13_092_454, kmers=251_006_893, nodes=17_081_052,
                       sources=8_291_886, device_sources=7_474_596)
CELEGANS_SHA256 = "d4a1c4802acc63bbfcdd8053bc5d26856cfa09b63fd8b4021224bf80881860cf"
CELEGANS_GREEDY_PAIRS = 1  # device/host library runs, alternating
# the matching-id count from which the candidate collapse leaves its packed
# value sort (ids of 23 to 26 bits) for the argsort route
ARGSORT_IDS = (1 << 26) + 1
# the deep-ball configuration: the flagship's pangenome at k=63 with the
# device stage at first capacity 16 (BASELINE.md:103-107, :536-540); the
# sha256 and counts of the JAX package's numpy generator at the flagship's
# length (matchtigs_tpu.testing, hashed as dataset_digest hashes; the
# counts are BASELINE.md:103-105's)
K63, K63_CAPACITY = 63, 16
K63_SHA256 = "35e3cf5cfb4cac668a2b5e2a3932c72431a05b4977b4c10022d578d8c3adb141"
K63_COUNTS = dict(unitigs=973_464, kmers=37_673_157, nodes=1_280_624, sources=626_732,
                  device_sources=582_335)
K63_WIDE_CAPACITY = 64  # the ladder's first stage on the wide kernel
K63_CENSUS_CAPACITY = 1024
CAPACITY = 4  # the GreedytigConfig default
N_FLAGSHIP_CHECK = 20_000  # flagship sources held against the plain version
POOL_CAPACITY_CASES = (16, 64)  # pool_sssp capacities timed on the C=4 overflow
WIDE_CAPACITIES = (16, 256, 1024)
# (schedule, capacity) of the packed wide cases that are also profiled
WIDE_PROFILED = (("pool", 16), ("pool", 256), ("pool", 1024), ("batch", 256))
# ball-size bins of the wide_ball_census (nodes, inclusive)
CENSUS_BINS = ((1, 4), (5, 8), (9, 16), (17, 32), (33, 64), (65, 128), (129, 256),
               (257, 1024))
WIDE_UNPACKED_BOUND = 30  # the k=31 bound on the unpacked layouts
DEEP_BOUND, DEEP_CAPACITY = 130, 256  # the k=131 bound on the flagship
MAX_BALL = 1 << 16  # GreedytigConfig.max_capacity
DEVICE_TYPE = "cuda"
ONE_POOL_LAUNCH = {"sssp_pool": 1, "sssp_wide": 0, "sssp_compact": 0, "mesh_sort": 0,
                   "mesh_merge_split": 0}
MESH_SHARDS = 4  # in-process shards of the mesh phases, all on the one card
SORT_EDGE_SIZES = (0, 1, 2049)  # empty, one key, and an odd size past 2048
COMPACT_LONG_ROW = 5000  # slots per row above the compaction's 4096-slot tile
WORKER_TIMEOUT_S = 420  # both mesh workers, load and graph build included
COLLECTIVE_TIMEOUT_S = 300
# NVIDIA H100 SXM data sheet: HBM3 rate, and the peak rate outside the
# tensor cores (float32; the kernels' integer work runs on the same cores)
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def kernel_ms(fn, reps: int = 5) -> float:
    """Mean device milliseconds of ``fn`` (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 5) -> tuple[float, dict, list]:
    """Device time of one call of ``fn`` from ``torch.profiler``, after a
    warm-up: (milliseconds, {kernel name: [milliseconds, launches]},
    [milliseconds of each launch, in launch order]), summed over the
    kernels and memsets it runs on the card.  Each of ``reps`` calls is
    profiled alone; a session that lost device events (fewer than the most
    any session saw) is left out, and the time is the median of the rest.
    Sessions that saw no device event at all are repeated, up to
    ``4 * reps`` in all; if none saw one, the time is ``busy_events_ms``
    instead, under the one breakdown key ``BUSY_EVENTS``.  Unlike
    ``kernel_ms`` it leaves out the gaps between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    sessions = []
    for _ in range(4 * reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3, e.name)
                        for e in prof.events() if e.device_type == DeviceType.CUDA)
        if events:
            sessions.append(events)
        if len(sessions) == reps:
            break
    if not sessions:
        ms = busy_events_ms(fn, reps)
        return ms, {BUSY_EVENTS: [ms, 1.0]}, []
    full = max(len(x) for x in sessions)
    complete = [x for x in sessions if len(x) == full]

    def short(name: str) -> str:
        name = name.replace("(anonymous namespace)::", "")
        return (name.split("(")[0].strip() or name)[:60]

    by_name: dict[str, list] = {}
    for x in complete:
        for _, ms, name in x:
            entry = by_name.setdefault(short(name), [0.0, 0])
            entry[0] += ms / len(complete)
            entry[1] += 1 / len(complete)
    totals = sorted(sum(ms for _, ms, _ in x) for x in complete)
    order = [sum(x[i][1] for x in complete) / len(complete) for i in range(full)]
    return totals[len(totals) // 2], by_name, order


def device_ops(fn) -> int:
    """Device operations (kernels, memsets, copies) one call of ``fn``
    enqueues: the nodes of a CUDA graph captured around the call, read
    through libcuda.  Unlike the profiler's count it does not rest on CUPTI
    delivering the call's events, which it sometimes does not."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    fn()
    torch.cuda.synchronize()
    graph, cu_graph, nodes = torch.cuda.CUDAGraph(), ctypes.c_void_p(), ctypes.c_size_t()
    status, capture_id = ctypes.c_int(), ctypes.c_uint64()
    deps, n_deps = ctypes.c_void_p(), ctypes.c_size_t()
    with torch.cuda.graph(graph):
        fn()
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = libcuda.cuStreamGetCaptureInfo_v2(
            stream, ctypes.byref(status), ctypes.byref(capture_id), ctypes.byref(cu_graph),
            ctypes.byref(deps), ctypes.byref(n_deps))
        rc = rc or libcuda.cuGraphGetNodes(cu_graph, None, ctypes.byref(nodes))
    del graph
    check(rc == 0, f"reading the captured graph failed: CUresult {rc}")
    return nodes.value


BUSY_EVENTS = "(no profiler events; CUDA events behind a fill)"


def busy_events_ms(fn, reps: int = 5) -> float:
    """Median device milliseconds of one call of ``fn`` from CUDA events
    recorded right behind a 1 GiB fill on the same stream: the card is still
    filling while the host enqueues the call, so the events bracket the
    call's kernels run back to back, not the host's enqueue."""
    pad = torch.empty(1 << 27, dtype=torch.int64, device=torch.cuda.current_device())
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    times = []
    for _ in range(reps):
        pad.fill_(0)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del pad
    return sorted(times)[len(times) // 2]


def host_ms(fn, reps: int = 20) -> float:
    """Mean host milliseconds to enqueue one call of ``fn`` (no synchronize
    inside the timed loop), after a warm-up: where it is near the event
    time, the event time measures the launch rate, not the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return ms


def roofline(bytes_moved: int, ops: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / CORE_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def search_bound(adj, src, rows, over, deg: int, nw=None, dist=None) -> tuple[float, str]:
    """Bound of a search launch: the adjacency (packed, or the unpacked
    ``(adj, nw)`` pair: two int32 words per slot), sources, rows (with
    ``dist`` for unpacked rows) and flags once; one relaxation per member
    slot and adjacency slot of the balls this run found (a ball that
    overflowed: C + 1 members)."""
    from matchtigs_tpu_torch.ops.sssp import DIST_BITS

    sentinel = adj.shape[0] - 1
    nodes = rows if dist is not None else rows >> DIST_BITS
    members = int((nodes != sentinel)[over == 0].sum())
    members += int((over != 0).sum()) * (rows.shape[1] + 1)
    moved = sum(t.numel() * t.element_size() for t in (adj, nw, src, rows, dist, over)
                if t is not None)
    return roofline(moved, members * deg)


def sort_bound(n_in: int, n_out: int) -> tuple[float, str]:
    """Bound of a key sort or merge: int64 keys read once and written once;
    n log2 n comparisons."""
    return roofline(8 * (n_in + n_out), n_in * max(1, math.ceil(math.log2(max(2, n_in)))))


def ball_census(rows, over, sentinel: int, dist=None) -> dict:
    """Ball sizes and distinct distance levels of the sources behind rows
    sorted by (dist, node), packed or (with ``dist``) unpacked: per bin of
    CENSUS_BINS the sources, their share and their mean levels; balls above
    the capacity count as ``over_capacity``."""
    from matchtigs_tpu_torch.ops.sssp import DIST_BITS, DIST_CAP

    done = over == 0
    if dist is None:
        node, dist = rows[done] >> DIST_BITS, rows[done] & DIST_CAP
    else:
        node, dist = rows[done], dist[done]
    valid = node != sentinel
    size = valid.sum(1)
    levels = valid[:, 0].long() + (valid[:, 1:] & (dist[:, 1:] != dist[:, :-1])).sum(1)
    total = int(over.numel())
    bins = []
    for lo, hi in CENSUS_BINS:
        inside = (size >= lo) & (size <= hi)
        n = int(inside.sum())
        bins.append(dict(nodes=f"{lo}-{hi}", sources=n, share=n / max(1, total),
                         mean_levels=float(levels[inside].float().mean()) if n else None))
    return dict(sources=total, capacity=rows.shape[1], bins=bins,
                over_capacity=int((~done).sum()),
                share_at_most_64=int((size <= 64).sum()) / max(1, total))


def key_mismatches(got: torch.Tensor, want: torch.Tensor) -> tuple[int, int]:
    """(mismatching positions, largest absolute difference among them)."""
    bad = got != want
    idx = torch.nonzero(bad).flatten()[:1000]
    diffs = [abs(a - b) for a, b in zip(got[idx].tolist(), want[idx].tolist())]
    return int(bad.sum()), max(diffs, default=0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def plain_ms(fn):
    """(result, host milliseconds) of a plain version run to completion."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def row_mismatches(got, want) -> dict:
    """Flag and row mismatches of (rows, dist, over) against the plain
    version's, and the largest absolute difference on non-overflowed rows."""
    rows, dist, over = got
    prows, pdist, pover = want
    done = over == 0
    diff = (rows[done].long() - prows[done].long()).abs()
    bad = (rows[done] != prows[done]).any(1)
    if pdist is not None:
        ddiff = (dist[done].long() - pdist[done].long()).abs()
        diff = torch.cat([diff.flatten(), ddiff.flatten()])
        bad |= (dist[done] != pdist[done]).any(1)
    return dict(
        flag_mismatch=int((over != pover).sum()),
        row_mismatch=int(bad.sum()),
        max_abs_err=int(diff.max()) if diff.numel() else 0,
        overflow=int(over.sum()),
    )


def compare(sssp, dg, sources: np.ndarray, max_weight: int, capacity: int,
            device) -> dict:
    """The register kernel on ``device`` against the plain version on a CPU
    copy: mismatching overflow flags and non-overflowed rows (both must be
    0)."""
    t0 = time.monotonic()
    adj = dg.device_buffers(device)
    src = torch.from_numpy(np.ascontiguousarray(sources, np.int32))
    src_dev = src.to(device)
    key, over = sssp.pool_sssp(adj, src_dev, max_weight, capacity)
    torch.cuda.synchronize()
    ms = kernel_ms(lambda: sssp.pool_sssp(adj, src_dev, max_weight, capacity))
    t1 = time.perf_counter()
    want = sssp.pool_sssp_plain(dg.device_buffers("cpu"), src, max_weight, capacity)
    plain_cpu_ms = 1e3 * (time.perf_counter() - t1)
    return dict(
        seconds=time.monotonic() - t0, sources=len(sources), capacity=capacity,
        kernel_ms=ms,
        plain_cpu_ms=plain_cpu_ms,
        **row_mismatches((key.cpu(), None, over.cpu()), want),
    )


def dataset_digest(store, kmers: np.ndarray) -> str:
    """sha256 over a dataset's codes (uint8), base offsets (int64) and
    k-mers (uint64, or for k > 31 the 16 big-endian bytes of each two-word
    key), in that order."""
    h = hashlib.sha256()
    two_words = kmers.dtype == np.dtype("V16")
    for a, dtype in ((store.codes, np.uint8), (store.offsets, np.int64),
                     (kmers, kmers.dtype if two_words else np.uint64)):
        h.update(np.ascontiguousarray(a, dtype=dtype))
    return h.hexdigest()


def peak_rss_gib() -> float:
    """This process's peak resident memory so far (GiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def pool_reading(sssp, adj, src, max_weight: int, deg: int,
                 capacity: int = CAPACITY) -> tuple:
    """``pool_sssp`` at ``capacity`` on ``src`` (the register kernel at C in
    ``sssp.CAPACITIES``, else the wide kernel): (rows, flags, fields), the
    fields being its event, device and host-enqueue times, the device
    operations one call enqueues (``device_ops``), the plain version's time
    on the card and the mismatches against it, the overflow share and the
    bound."""
    def run():
        return sssp.pool_sssp(adj, src, max_weight, capacity)
    fields = dict(sources=len(src), capacity=capacity, kernel_ms=kernel_ms(run))
    key, over = run()
    want, fields["plain_on_gpu_ms"] = plain_ms(
        lambda: sssp.pool_sssp_plain(adj, src, max_weight, capacity))
    fields["bound_ms"], fields["bound_by"] = search_bound(adj, src, key, over, deg)
    device, breakdown, _ = device_ms(run)
    fields.update(kernel_device_ms=device, kernel_device_breakdown_ms=breakdown,
                  kernel_device_ops=device_ops(run), host_enqueue_ms=host_ms(run),
                  overflow_frac=float(over.float().mean()),
                  **row_mismatches((key, None, over), want))
    return key, over, fields


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SystemExit(message)


def spelled_kmer_set(store, k: int, device) -> np.ndarray:
    """Sorted unique canonical packed k-mers (k <= 63) of every sequence in
    ``store``, made on ``device`` (the host takes tens of seconds for the
    flagship's outputs), as numpy keys (uint64, or void16 above k = 31)."""
    from matchtigs_tpu_torch import testing

    spelled = testing.spelled_kmers_torch(store, k, device)
    return testing.kmers_to_numpy(testing.sorted_unique_kmers(spelled, k))


class LogCapture(logging.Handler):
    """Records of the named loggers, kept while a ``with`` block runs at INFO
    level and not passed on to the root's handlers.  Loggers below them
    that inherit their level keep the level they had, so they log (and
    compute) no more than before."""

    def __init__(self, *names: str):
        super().__init__(logging.INFO)
        self.loggers, self.records = [logging.getLogger(n) for n in names], []

    def emit(self, record) -> None:
        self.records.append(record)

    def __enter__(self):
        names = [lg.name for lg in self.loggers]
        below = [lg for name, lg in list(logging.Logger.manager.loggerDict.items())
                 if isinstance(lg, logging.Logger) and lg.level == logging.NOTSET
                 and name not in names and any(name.startswith(n + ".") for n in names)]
        self.saved = [(lg, lg.level, lg.propagate) for lg in below + self.loggers]
        for lg in below:
            lg.setLevel(lg.getEffectiveLevel())
        for lg in self.loggers:
            lg.setLevel(logging.INFO)
            lg.propagate = False
            lg.addHandler(self)
        return self

    def __exit__(self, *exc) -> None:
        for lg in self.loggers:
            lg.removeHandler(self)
        for lg, level, propagate in self.saved:
            lg.setLevel(level)
            lg.propagate = propagate

    def args(self, msg: str) -> list:
        """The arguments of every record whose format string is ``msg``."""
        return [r.args for r in self.records if r.msg == msg]


def load_capi(path: Path) -> ctypes.CDLL:
    """The port's C library with its five entry points typed."""
    lib = ctypes.CDLL(str(path))
    size, sizep = ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)
    lib.matchtigs_initialise.argtypes, lib.matchtigs_initialise.restype = [], None
    lib.matchtigs_initialise_graph.argtypes = [size]
    lib.matchtigs_initialise_graph.restype = ctypes.c_void_p
    lib.matchtigs_merge_nodes.argtypes = [ctypes.c_void_p, size, ctypes.c_int, size,
                                          ctypes.c_int]
    lib.matchtigs_merge_nodes.restype = None
    lib.matchtigs_build_graph.argtypes = [ctypes.c_void_p, sizep]
    lib.matchtigs_build_graph.restype = None
    lib.matchtigs_compute_tigs.argtypes = [
        ctypes.c_void_p, size, size, size, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), sizep, sizep,
    ]
    lib.matchtigs_compute_tigs.restype = size
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-length", type=int, default=FLAGSHIP_LENGTH)
    ap.add_argument("--mesh-worker", nargs=4, metavar=("RANK", "WORLD", "PORT", "OUT"),
                    help="run one process of the mesh_two_process phase")
    ap.add_argument("--data-dir", help="the mesh worker's dataset cache")
    args = ap.parse_args(argv)
    if args.mesh_worker:
        return mesh_worker(*args.mesh_worker, genome_length=args.genome_length,
                           data_dir=args.data_dir)
    # a fresh cache per run: the flagship is generated (and timed) here, and
    # the mesh workers load what this run wrote
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as data_dir:
        return smoke(args, Path(data_dir))


def smoke(args, data_dir: Path) -> int:
    """Every phase of the module docstring, in order (0 on success; a
    failed check exits)."""
    t_start = time.monotonic()

    # 1. Device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke needs one")
    device = torch.device(DEVICE_TYPE, 0)
    torch.cuda.set_device(device)
    gpu = gpu_line()
    phase("device", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count())

    # 2. Build
    from matchtigs_tpu_torch import native, testing
    from matchtigs_tpu_torch.algos.matchtigs import MatchtigConfig, compute_matchtigs
    from matchtigs_tpu_torch.capi import TigGraphBuilder
    from matchtigs_tpu_torch.algos.greedytigs import (
        GreedytigConfig, SearchStats, compute_greedytigs,
    )
    from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs
    from matchtigs_tpu_torch.io.readers import read_fasta
    from matchtigs_tpu_torch.io.writers import spell_walks_flat, write_walks_fasta
    from matchtigs_tpu_torch.algos.greedytigs import collect_candidates
    from matchtigs_tpu_torch.ops import mesh_sort, sssp
    from matchtigs_tpu_torch.ops.device_graph import build_device_graph
    from matchtigs_tpu_torch.ops.matching import (
        greedy_accept, greedy_accept_sorted_keys, pack_accept_keys,
    )
    from matchtigs_tpu_torch.parallel import mesh as mesh_mod

    t0 = time.monotonic()
    sssp.build_kernels()
    t_nvcc = time.monotonic() - t0
    t0 = time.monotonic()
    native.load()
    phase("build", nvcc_s=t_nvcc, gxx_s=time.monotonic() - t0,
          kernels=sorted(sssp.build_kernels()))

    # the flagship dataset, generated on the card (cached for the mesh
    # workers in this run's data_dir)
    t0 = time.monotonic()
    store, kmers, g, dg, (out_nodes, in_mask, mult), pending, data = make_dataset(
        args.genome_length, device, data_dir)
    k = K
    checked = args.genome_length == FLAGSHIP_LENGTH
    phase("dataset", seconds=time.monotonic() - t0, **data, checked=checked)
    if checked:
        counts = {c: data[c] for c in FLAGSHIP_COUNTS}
        check(data["sha256"] == FLAGSHIP_SHA256 and counts == FLAGSHIP_COUNTS,
              f"flagship differs from the JAX generator's: {data['sha256']} {counts}")

    # 3. Register kernel vs plain version
    t0 = time.monotonic()
    small_store, _, small_k = testing.make_unitig_store(
        genome_length=40000, k=13, seed=7
    )
    small_dg = build_device_graph(build_bigraph_from_unitigs(small_store, small_k))
    checks = []
    for name, cdg, srcs, kk in (
        ("unitig-40k-k13", small_dg,
         np.arange(small_dg.n_nodes + 1, dtype=np.int32), small_k),
        ("flagship-first-20k", dg, pending[:N_FLAGSHIP_CHECK], k),
    ):
        for cap in (4, 16):
            r = compare(sssp, cdg, srcs, kk - 1, cap, device)
            phase("kernel_vs_plain", graph=name, **r)
            checks.append(r)
            check(not (r["flag_mismatch"] or r["row_mismatch"]),
                  f"kernel disagrees with its plain version: {r}")
    # at the main path's shape: all device sources of the flagship, C=4;
    # the plain version runs on the card too
    adj = dg.device_buffers(device)
    src = torch.from_numpy(pending).to(device)
    rows4, over4, pool = pool_reading(sssp, adj, src, k - 1, dg.deg_pad)
    checks.append(pool)
    phase("kernel_main_shape", seconds=time.monotonic() - t0, **pool,
          registers_and_spilled_bytes={c: sssp.pool_kernel_attributes(c) for c in sssp.CAPACITIES},
          sources_per_s=len(pending) / (pool["kernel_ms"] / 1e3))
    check(not (pool["flag_mismatch"] or pool["row_mismatch"]),
          "kernel disagrees with its plain version at the main shape")
    check(pool["kernel_device_ops"] == 1,
          f"the main-shape call ran {pool['kernel_device_ops']} device operations: "
          f"{pool['kernel_device_breakdown_ms']}")
    over_sources = src[over4.bool()].contiguous()  # the sources overflowing C=4

    # pool_sssp's larger capacities on the sources that overflow C=4 (C=64
    # runs on the wide kernel), against the plain version on the card
    for cap in POOL_CAPACITY_CASES:
        t1 = time.monotonic()

        def run_cap():
            return sssp.pool_sssp(adj, over_sources, k - 1, cap)
        got = run_cap()
        want, cap_plain_ms = plain_ms(
            lambda: sssp.pool_sssp_plain(adj, over_sources, k - 1, cap))
        r = row_mismatches((got[0], None, got[1]), want)
        cap_device, cap_kernels, _ = device_ms(run_cap)
        phase("pool_capacity_case", capacity=cap, sources=len(over_sources),
              kernel_ms=kernel_ms(run_cap), kernel_device_ms=cap_device,
              kernel_device_breakdown_ms=cap_kernels, host_enqueue_ms=host_ms(run_cap),
              plain_on_gpu_ms=cap_plain_ms,
              bound_ms=search_bound(adj, over_sources, *got, dg.deg_pad)[0],
              seconds=time.monotonic() - t1, **r)
        checks.append(r)
        check(not (r["flag_mismatch"] or r["row_mismatch"]),
              f"kernel disagrees with its plain version at C={cap}: {r}")
        del got, want

    # 4. Wide kernel vs plain version on the card: the C=4 overflow sources
    t0 = time.monotonic()
    nbr, nw = dg.device_buffers(device, adj_packed=False)
    wide = []
    cases = [("packed", adj, None, k - 1, cap, over_sources) for cap in WIDE_CAPACITIES]
    cases += [("unpacked", nbr, nw, WIDE_UNPACKED_BOUND, cap, over_sources)
              for cap in WIDE_CAPACITIES]
    cases.append(("unpacked", nbr, nw, DEEP_BOUND, DEEP_CAPACITY,
                  src[:N_FLAGSHIP_CHECK].contiguous()))
    for layout, a, w, mw, cap, s in cases:
        want, p_ms = plain_ms(lambda: sssp.pool_sssp_plain(
            a, s, mw, cap, nw=w, pack_out=w is None))
        for schedule in sssp.SCHEDULES:
            def run():
                return sssp.wide_sssp(a, s, mw, cap, nw=w, pack_out=w is None,
                                      schedule=schedule)
            got = run()
            torch.cuda.synchronize()
            r = dict(layout=layout, schedule=schedule, max_weight=mw,
                     capacity=cap, sources=len(s), kernel_ms=kernel_ms(run, reps=3),
                     plain_on_gpu_ms=p_ms, **row_mismatches(got, want))
            if w is None and (schedule, cap) in WIDE_PROFILED:
                r["kernel_device_ms"], r["kernel_device_breakdown_ms"], _ = device_ms(run)
                r["host_enqueue_ms"] = host_ms(run, reps=5)
                if (schedule, cap) == ("pool", 1024):
                    census_rows, census_over = got[0], got[2]
            phase("wide_vs_plain", **r)
            wide.append(r)
            check(not (r["flag_mismatch"] or r["row_mismatch"]),
                  f"wide kernel disagrees with its plain version: {r}")
        del want, got
    wide_main = next(r for r in wide if r["layout"] == "packed"
                     and r["schedule"] == "pool" and r["capacity"] == 256)
    wide_bound = search_bound(adj, over_sources, *sssp.wide_sssp(
        adj, over_sources, k - 1, 256)[::2], dg.deg_pad)
    phase("wide_vs_plain_done", seconds=time.monotonic() - t0, cases=len(wide))
    phase("wide_ball_census", **ball_census(census_rows, census_over, dg.sentinel))
    del census_rows, census_over

    # 5. Compaction: the kernel against its plain version on the C=4 rows of
    # all device sources, then the compact download against the full one
    t0 = time.monotonic()
    budget = rows4.numel() // 2  # half the slots: the valid ones fit
    args4 = (rows4, over4, dg.sentinel, k - 1, budget)
    vals, counts, total = sssp.compact_rows(*args4)
    compact_ms = kernel_ms(lambda: sssp.compact_rows(*args4))
    (pvals, pcounts, ptotal), compact_plain_ms = plain_ms(
        lambda: sssp.compact_rows_plain(*args4)
    )
    n_valid = min(int(ptotal), budget)
    compact_err = int((vals[:n_valid].long() - pvals[:n_valid].long()).abs().max())
    # the library call: masked_select over the same rows with the mask given
    node4, dist4 = rows4 >> sssp.DIST_BITS, rows4 & sssp.DIST_CAP
    valid4 = ((node4 != dg.sentinel) & (dist4 >= 1) & (dist4 <= k - 1)
              & (over4 == 0)[:, None])
    compact_library_ms = kernel_ms(lambda: torch.masked_select(rows4, valid4))
    check(torch.equal(torch.masked_select(rows4, valid4), pvals[:n_valid]),
          "masked_select disagrees with the compaction")
    # device time alone: at these sizes the event times above are mostly
    # the launch rate
    compact_device_ms, compact_kernels, _ = device_ms(lambda: sssp.compact_rows(*args4))
    compact_library_device_ms, _, _ = device_ms(lambda: torch.masked_select(rows4, valid4))
    compact_host_ms = host_ms(lambda: sssp.compact_rows(*args4))
    compact_bound = roofline(
        sum(t.numel() * t.element_size() for t in (rows4, over4, counts, total))
        + 4 * n_valid, 0,
    )
    del node4, dist4, valid4
    check(int(total) == int(ptotal) and torch.equal(counts, pcounts)
          and compact_err == 0, "compaction kernel disagrees with its plain version")
    # more row widths, each with a budget below its total: C = 1 (int8
    # counts), 128 (int32 counts) and COMPACT_LONG_ROW (rows longer than a
    # tile, walked in pieces; on the first sources that overflow C=4)
    for cap, s_cap in ((1, src), (128, src), (COMPACT_LONG_ROW, over_sources[:N_FLAGSHIP_CHECK])):
        crows, _, cover = sssp.wide_sssp(adj, s_cap.contiguous(), k - 1, cap)
        _, _, ctotal = sssp.compact_rows_plain(crows, cover, dg.sentinel, k - 1, 0)
        cbudget = int(ctotal) // 2
        got = sssp.compact_rows(crows, cover, dg.sentinel, k - 1, cbudget)
        want = sssp.compact_rows_plain(crows, cover, dg.sentinel, k - 1, cbudget)
        err = int((got[0].long() - want[0].long()).abs().max()) if cbudget else 0
        same = (int(got[2]) == int(want[2]) and got[1].dtype == want[1].dtype
                and torch.equal(got[1], want[1]) and err == 0)
        phase("compact_case", capacity=cap, sources=len(s_cap), valid_slots=int(ctotal),
              budget=cbudget, counts_dtype=str(got[1].dtype), max_abs_err=err, equal=same)
        check(same, f"compaction kernel disagrees with its plain version at C={cap}")
        compact_err = max(compact_err, err)
        del crows, cover, got, want
    sssp.reset_kernel_launches()
    t_fetch = time.monotonic()
    full = sssp.batched_bounded_sssp_dispatch(dg, pending, k - 1, CAPACITY, device)
    ftri, fover = full.fetch_candidates(dg, pending, in_mask)
    full_s = time.monotonic() - t_fetch
    t_fetch = time.monotonic()
    comp = sssp.batched_bounded_sssp_dispatch(
        dg, pending, k - 1, CAPACITY, device, compact=True, budget=budget
    )
    ctri, cover = comp.fetch_candidates(dg, pending, in_mask)
    compact_s = time.monotonic() - t_fetch
    torch.cuda.synchronize()
    compact_launches = sssp.KERNEL_LAUNCHES["sssp_compact"]
    same = np.array_equal(cover, fover) and all(
        np.array_equal(getattr(ctri, c), getattr(ftri, c)) for c in ("u", "v", "d")
    )
    phase("compact_vs_full", seconds=time.monotonic() - t0, sources=len(pending),
          capacity=CAPACITY, valid_slots=int(total), budget=budget,
          kernel_ms=compact_ms, plain_on_gpu_ms=compact_plain_ms,
          library_ms=compact_library_ms, kernel_device_ms=compact_device_ms,
          kernel_device_breakdown_ms=compact_kernels,
          library_device_ms=compact_library_device_ms, host_enqueue_ms=compact_host_ms,
          bound_ms=compact_bound[0],
          max_abs_err=compact_err, candidates=len(ctri), columns_equal=same,
          bytes_full=full.bytes_fetched, bytes_compact=comp.bytes_fetched,
          full_stage_s=full_s, compact_stage_s=compact_s,
          compact_launches=compact_launches)
    check(same and compact_launches == 1 and comp.bytes_fetched < full.bytes_fetched,
          "the compact download differs from the full one")
    del rows4, over4, vals, pvals, full, comp, ftri, ctri

    # 6. Main path: the default CLI on the card, then the host engine
    logging.getLogger("matchtigs_tpu_torch").setLevel(logging.WARNING)
    want_kmers = np.unique(kmers.astype(np.uint64))

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        fa_in = Path(tmp) / "unitigs.fa.gz"
        testing.write_fasta(fa_in, store)
        rc, launches, cli_s, out_store, laps = run_cli(fa_in, k)
        check(rc == 0 and launches == ONE_POOL_LAUNCH,
              f"CLI rc {rc}, kernel launches {launches}")
        cli_tigs, cli_len = len(out_store), int(out_store.offsets[-1])
        got = spelled_kmer_set(out_store, k, device)
        check(np.array_equal(got, want_kmers),
              f"CLI output spells {len(got)} k-mers, input has {len(want_kmers)}")
        phase("cli_device", seconds=time.monotonic() - t0, cli_s=cli_s, **laps,
              kernel_launches=launches["sssp_pool"],
              launches=launches, tigs=cli_tigs, cumulative_length=cli_len,
              kmer_set_equal=True)
        pool_launches = launches["sssp_pool"]

        t0 = time.monotonic()
        runs = {}
        for engine in ("device", "host"):
            gg = g.copy()
            stats = SearchStats()
            t_run = time.monotonic()
            tigs = compute_greedytigs(gg, GreedytigConfig(k=k, engine=engine), stats)
            torch.cuda.synchronize()
            seconds = time.monotonic() - t_run
            _, off = spell_walks_flat(gg, tigs, store, k)
            runs[engine] = (tigs, seconds, stats, len(tigs), int(off[-1]))
        d_tigs, d_s, d_stats, d_n, d_len = runs["device"]
        h_tigs, h_s, _, h_n, h_len = runs["host"]
        stage_kernel_s = d_stats.stage_kernel_times[0]
        phase("greedy_device_vs_host", seconds=time.monotonic() - t0,
              device_s=d_s, host_s=h_s,
              device_stage_s=d_stats.stage_times[0], stage_kernel_s=stage_kernel_s,
              warm_kernel_ms=pool["kernel_ms"], warm_kernel_device_ms=pool["kernel_device_ms"],
              stage_sources=d_stats.stage_sources[0],
              stage_sources_per_s=d_stats.stage_sources[0] / stage_kernel_s,
              stage_overflow_frac=d_stats.stage_overflow_frac[0],
              host_routed=d_stats.host_routed, device_tigs=d_n, host_tigs=h_n,
              device_len=d_len, host_len=h_len)
        check((d_n, d_len) == (h_n, h_len) and (cli_tigs, cli_len) == (h_n, h_len),
              "tig count or cumulative length differs from the host engine")
        check(np.array_equal(d_tigs.flat, h_tigs.flat)
              and np.array_equal(d_tigs.offsets, h_tigs.offsets),
              "device-engine walks differ from the host engine's")
        del runs, d_tigs, h_tigs

        # 7. The ladder: the largest ball first (a ball above the last
        # capacity makes the ladder raise, as in the JAX package), then the
        # stages of a library run, then the CLI
        t0 = time.monotonic()
        ones = np.ones(dg.n_nodes + 1, dtype=np.int8)
        balls = sssp.host_dijkstra_candidates(
            dg, over_sources.cpu().numpy(), k - 1, ones
        )
        max_ball = int(np.bincount(balls.u).max()) + 1 if len(balls) else 1
        del balls
        check(max_ball <= MAX_BALL,
              f"largest flagship ball {max_ball} exceeds the ladder's {MAX_BALL}")
        stats = SearchStats()
        compute_greedytigs(g.copy(), GreedytigConfig(k=k, overflow_mode="ladder"), stats)
        capacities = [CAPACITY * 4 ** i for i in range(len(stats.stage_sources))]
        rc, launches, ladder_s, out_store, laps = run_cli(
            fa_in, k, "--sssp-overflow-mode", "ladder"
        )
        check(rc == 0, f"ladder CLI rc {rc}")
        n_tigs, n_len = len(out_store), int(out_store.offsets[-1])
        got = spelled_kmer_set(out_store, k, device)
        phase("cli_ladder", seconds=time.monotonic() - t0, cli_s=ladder_s, **laps,
              max_ball=max_ball, stage_capacities=capacities,
              stage_sources=stats.stage_sources,
              stage_kernel_ms=[1e3 * s for s in stats.stage_kernel_times],
              launches=launches, tigs=n_tigs, cumulative_length=n_len,
              kmer_set_equal=bool(np.array_equal(got, want_kmers)))
        check((n_tigs, n_len) == (h_n, h_len), "ladder tigs differ from the host engine")
        check(np.array_equal(got, want_kmers), "ladder CLI output misses k-mers")
        check(sum(launches.values()) >= len(capacities) >= 2,
              f"ladder launches {launches} for {len(capacities)} stages")
        wide_launches = launches["sssp_wide"]

        # 8. Optimal matchtigs: the CLI with every matchtigs output, then
        # library runs of the host and device engines
        t0 = time.monotonic()
        bv_out, prefix = Path(tmp) / "matchtigs.bv", Path(tmp) / "instance"
        with LogCapture("matchtigs_tpu_torch.algos.matchtigs") as log:
            rc, launches, mt_s, out_store, cli_laps = run_cli(
                fa_in, k, "--matchtigs-duplication-bitvector-out", str(bv_out),
                "--matching-file-prefix", str(prefix), out_flag="--matchtigs-fa-out")
        check(rc == 0 and launches == ONE_POOL_LAUNCH,
              f"matchtigs CLI rc {rc}, kernel launches {launches}")
        mt_fasta = (Path(tmp) / "out.fa").read_bytes()
        mt_tigs, mt_len = len(out_store), int(out_store.offsets[-1])
        got = spelled_kmer_set(out_store, k, device)
        inst = matching_instance(log)
        instance = [f.open().readline().split() for f in (
            Path(f"{prefix}.matching"), Path(f"{prefix}.matching.solution"))]
        bv_lines = bv_out.read_bytes().split(b"\n")[:-1]
        pool_launches += launches["sssp_pool"]
        mt_runs = {}
        for engine in ("host", "device"):
            gg = g.copy()
            t_run = time.monotonic()
            tigs = compute_matchtigs(gg, MatchtigConfig(k=k, engine=engine))
            torch.cuda.synchronize()
            mt_runs[engine] = (tigs, time.monotonic() - t_run, gg)
        h_mt, h_mt_s, h_g = mt_runs["host"]
        _, h_off = spell_walks_flat(h_g, h_mt, store, k)
        write_walks_fasta(h_g, h_mt, store, k, Path(tmp) / "host.fa")
        same_fasta = (Path(tmp) / "host.fa").read_bytes() == mt_fasta
        d_mt, d_mt_s, _ = mt_runs["device"]
        same_walks = (np.array_equal(d_mt.flat, h_mt.flat)
                      and np.array_equal(d_mt.offsets, h_mt.offsets))
        phase("cli_matchtigs", seconds=time.monotonic() - t0, cli_s=mt_s, **cli_laps,
              **inst, matching_s=inst["laps_s"]["Matching"], launches=launches,
              tigs=mt_tigs, cumulative_length=mt_len,
              greedy_tigs=cli_tigs, greedy_cumulative_length=cli_len,
              saving_over_greedy=cli_len - mt_len,
              host_tigs=len(h_mt), host_len=int(h_off[-1]), library_host_s=h_mt_s,
              library_device_s=d_mt_s, fasta_equal_host=same_fasta,
              walks_equal_host=same_walks, kmer_set_equal=bool(np.array_equal(got, want_kmers)),
              instance_header=instance[0], solution_header=instance[1],
              bitvector_lines=len(bv_lines))
        check(np.array_equal(got, want_kmers),
              f"matchtigs CLI output spells {len(got)} k-mers, input has {len(want_kmers)}")
        check(mt_len <= cli_len, f"matchtigs {mt_len} longer than greedytigs {cli_len}")
        check((mt_tigs, mt_len) == (len(h_mt), int(h_off[-1])) and same_fasta and same_walks,
              "matchtigs differ from the host engine's")
        check(instance == [[str(inst["matching_ids"]), str(inst["matching_edges"])],
                           [str(inst["matching_ids"]), str(inst["matched_pairs"])]]
              and len(bv_lines) == mt_tigs
              and sum(line.count(b"1") for line in bv_lines) == len(want_kmers),
              "matching files or duplication bitvector disagree with the run")
        del mt_runs, h_mt, d_mt, h_g, out_store

        # 9. Pathtigs and eulertigs: one CLI run, host-only
        t0 = time.monotonic()
        outs = {algo: Path(tmp) / f"{algo}.fa" for algo in ("pathtigs", "eulertigs")}
        rc, launches, pe_s, _, laps = run_cli(
            fa_in, k, *(a for algo, path in outs.items() for a in (f"--{algo}-fa-out", str(path))),
            out_flag=None)
        check(rc == 0 and not any(launches.values()),
              f"pathtigs/eulertigs CLI rc {rc}, kernel launches {launches}")
        pe = {}
        for algo, path in outs.items():
            out_store = read_fasta(path)[0]
            spelled = testing.spelled_kmers_torch(out_store, k, device)
            unique = testing.kmers_to_numpy(testing.sorted_unique_kmers(spelled, k))
            pe[algo] = dict(tigs=len(out_store), cumulative_length=int(out_store.offsets[-1]),
                            kmers=len(spelled),
                            each_kmer_once=len(spelled) == len(unique)
                            and bool(np.array_equal(unique, want_kmers)))
        phase("cli_pathtigs_eulertigs", seconds=time.monotonic() - t0, cli_s=pe_s, **laps,
              launches=launches, **pe)
        check(all(r["each_kmer_once"] for r in pe.values()),
              f"pathtigs/eulertigs do not spell every k-mer exactly once: {pe}")
        check(pe["eulertigs"]["cumulative_length"] <= pe["pathtigs"]["cumulative_length"],
              "eulertigs longer than pathtigs")

        # 10. The C ABI: the port's C library over the flagship's topology,
        # every algorithm id, against TigGraphBuilder with the host engine
        t0 = time.monotonic()
        lib_path = Path(tmp) / "libmatchtigs_tpu_torch.so"
        native.build_capi(lib_path)
        gcc_s = time.monotonic() - t0
        lib = load_capi(lib_path)
        lib.matchtigs_initialise()
        merges = testing.capi_merges(g)
        rows = list(zip(*(c.tolist() for c in merges)))
        weights = np.ascontiguousarray(store.lengths + 1 - k, dtype=np.uint64)
        n_uni = len(store)
        t = time.monotonic()
        ref = TigGraphBuilder(n_uni)
        for row in rows:
            ref.merge_nodes(*row)
        ref_graph = ref.build_graph(weights)
        ref_build_s = time.monotonic() - t
        threads = os.cpu_count() or 1
        capi = []
        for algo in (1, 2, 3, 4, 5):
            ref.graph = ref_graph.copy()
            t = time.monotonic()
            want = ref.compute_tigs(algo, k, threads, engine="host")
            ref_s = time.monotonic() - t
            t = time.monotonic()
            h = lib.matchtigs_initialise_graph(n_uni)
            check(h is not None, "matchtigs_initialise_graph failed")
            for a, sa, b, sb in rows:
                lib.matchtigs_merge_nodes(h, a, sa, b, sb)
            lib.matchtigs_build_graph(h, weights.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)))
            build_s = time.monotonic() - t
            cap = 2 * len(want[0]) + 64  # the library writes without a bound
            edges = np.zeros(cap, dtype=np.int64)
            inserts = np.zeros(cap, dtype=np.uint64)
            limits = np.zeros(cap, dtype=np.uint64)
            sssp.reset_kernel_launches()
            t = time.monotonic()
            n_tigs = lib.matchtigs_compute_tigs(
                h, algo, threads, k, b"", b"",
                edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                inserts.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
                limits.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)))
            torch.cuda.synchronize()
            compute_s = time.monotonic() - t
            launches = dict(sssp.KERNEL_LAUNCHES)
            total = int(limits[n_tigs - 1]) if n_tigs else 0
            equal = (n_tigs == len(want[2]) and total == len(want[0])
                     and np.array_equal(edges[:total], want[0])
                     and np.array_equal(inserts[:total], want[1].astype(np.uint64))
                     and np.array_equal(limits[:n_tigs], want[2].astype(np.uint64)))
            r = dict(algo=algo, tigs=int(n_tigs), edges=total, build_s=build_s,
                     compute_s=compute_s, reference_s=ref_s, launches=launches,
                     equal_host=bool(equal))
            phase("capi_case", **r)
            capi.append(r)
            check(equal and n_tigs > 0, f"C ABI id {algo} differs from compute_tigs: {r}")
            check(launches == (ONE_POOL_LAUNCH if algo in (4, 5)
                               else dict.fromkeys(ONE_POOL_LAUNCH, 0)),
                  f"C ABI id {algo} kernel launches {launches}")
            pool_launches += launches["sssp_pool"]
        phase("capi_device", seconds=time.monotonic() - t0, gcc_s=gcc_s,
              genome_length=args.genome_length, unitigs=n_uni, merges=len(rows),
              reference_build_s=ref_build_s,
              launches={c["algo"]: c["launches"]["sssp_pool"] for c in capi})
        del ref, ref_graph, rows, merges

        # 10b. The link inputs: the flagship written as BCALM2 and GFA, and
        # the CLI from each
        pool_launches += link_inputs(store, g, k, want_kmers, fa_in, device, checks,
                                     overlap=pool, greedy=(cli_tigs, cli_len))

    # 11. k=131 on a string-generated input: the unpacked layouts
    t0 = time.monotonic()
    kstore, kset, kk = testing.make_unitig_store_strings(
        genome_length=20000, k=131, seed=131, n_sequences=3
    )
    kg = build_bigraph_from_unitigs(kstore, kk)
    hg = kg.copy()
    host = compute_greedytigs(hg, GreedytigConfig(k=kk, engine="host"))
    _, hoff = spell_walks_flat(hg, host, kstore, kk)
    with tempfile.TemporaryDirectory() as tmp:
        fa_in = Path(tmp) / "unitigs.fa.gz"
        testing.write_fasta(fa_in, kstore)
        rc, launches, k131_s, out_store, laps = run_cli(fa_in, kk)
    check(rc == 0, f"k=131 CLI rc {rc}")
    seqs = [out_store.get_ascii(i).decode() for i in range(len(out_store))]
    rc_table = str.maketrans("ACGT", "TGCA")
    spelled = {min(s[j:j + kk], s[j:j + kk][::-1].translate(rc_table))
               for s in seqs for j in range(len(s) - kk + 1)}
    phase("cli_k131", seconds=time.monotonic() - t0, cli_s=k131_s, **laps,
          unitigs=len(kstore), launches=launches, tigs=len(out_store),
          cumulative_length=int(out_store.offsets[-1]), host_tigs=len(host),
          host_len=int(hoff[-1]), kmer_set_equal=spelled == kset)
    check((len(out_store), int(out_store.offsets[-1])) == (len(host), int(hoff[-1])),
          "k=131 tigs differ from the host engine")
    check(spelled == kset and launches["sssp_wide"] >= 1,
          f"k=131 CLI: k-mer set equal {spelled == kset}, launches {launches}")
    wide_launches += launches["sssp_wide"]

    # 12. The mesh's sort and merge-split kernel against their plain
    # versions: the flagship's acceptance keys, then edge cases
    t0 = time.monotonic()
    chunks = collect_candidates(g, out_nodes, in_mask, k, GreedytigConfig(k=k),
                                return_chunks=True)
    keys = pack_accept_keys(chunks)
    check(keys is not None, "flagship candidates exceed the packed accept keys")
    rng = np.random.default_rng(SEED)
    # the blocks of a two-shard sort (mesh_two_process): the keys padded
    # with KEY_PAD to 2 * half, as sharded_accept_key_sort pads them
    half = -(-len(keys) // 2)
    padded = np.full(2 * half, mesh_mod.KEY_PAD, dtype=np.int64)
    padded[: len(keys)] = keys
    sort_cases = [("flagship", keys), ("two-shard-block", padded[half:])]
    sort_cases += [(f"n={n}", rng.choice(keys, n)) for n in SORT_EDGE_SIZES]
    sort_cases += [(f"n={n}", rng.choice(keys, n))
                   for n in (mesh_sort.TILE - 1, mesh_sort.TILE, mesh_sort.TILE + 1)]
    sort_cases += [("all-duplicates", np.full(100_000, keys[len(keys) // 2])),
                   ("all-padding", np.full(3 * mesh_sort.TILE + 5, mesh_mod.KEY_PAD))]
    # signed keys (the sign bit's digit) and digits constant in every key
    # (the skipped passes)
    signed = rng.integers(-(1 << 63), 1 << 63, 1_000_003, dtype=np.int64)
    sort_cases += [("signed", signed),
                   ("negative", signed[:300_000] | np.int64(-(1 << 63))),
                   ("top-byte-only", (signed >> 56 << 56) | 0x0123456789AB),
                   ("constant-middle", (signed >> 56 << 56) | (signed & 0xFF))]
    sort_err = sort_bad = 0
    for name, case in sort_cases:
        t = torch.from_numpy(np.ascontiguousarray(case, dtype=np.int64)).to(device)
        bad, err = key_mismatches(mesh_sort.sort_keys(t), mesh_sort.sort_keys_plain(t))
        phase("mesh_sort_case", case=name, keys=len(case), mismatches=bad, max_abs_err=err)
        sort_bad, sort_err = sort_bad + bad, max(sort_err, err)
    flag_keys = torch.from_numpy(keys).to(device)
    sort_ms = kernel_ms(lambda: mesh_sort.sort_keys(flag_keys))
    sort_library_ms = kernel_ms(lambda: torch.sort(flag_keys))
    sort_device, sort_kernels, sort_passes = device_ms(lambda: mesh_sort.sort_keys(flag_keys))
    sort_library_device, _, _ = device_ms(lambda: torch.sort(flag_keys))
    sort_host = host_ms(lambda: mesh_sort.sort_keys(flag_keys))
    block_keys = torch.from_numpy(padded[half:]).to(device)
    block_sort_ms = kernel_ms(lambda: mesh_sort.sort_keys(block_keys))
    block_sort_device, _, block_passes = device_ms(lambda: mesh_sort.sort_keys(block_keys))
    block_library_device, _, _ = device_ms(lambda: torch.sort(block_keys))
    del block_keys
    _, sort_plain_ms = plain_ms(lambda: mesh_sort.sort_keys_plain(flag_keys))
    sort_roof = sort_bound(len(keys), len(keys))
    # merge-split: the flagship keys in two sorted halves, the second padded
    a, b = (mesh_sort.sort_keys(torch.from_numpy(x).to(device))
            for x in (padded[:half], padded[half:]))
    merge_bad = merge_err = 0
    for keep_high in (False, True):
        bad, err = key_mismatches(mesh_sort.merge_split(a, b, keep_high),
                                  mesh_sort.merge_split_plain(a, b, keep_high))
        merge_bad, merge_err = merge_bad + bad, max(merge_err, err)
    for L in SORT_EDGE_SIZES[1:]:
        ea, eb = (torch.sort(torch.from_numpy(rng.choice(keys, L)).to(device)).values
                  for _ in range(2))
        bad, err = key_mismatches(mesh_sort.merge_split(ea, eb, True),
                                  mesh_sort.merge_split_plain(ea, eb, True))
        merge_bad, merge_err = merge_bad + bad, max(merge_err, err)
    merge_device, merge_kernels, _ = device_ms(lambda: mesh_sort.merge_split(a, b, True))
    merge_ms = kernel_ms(lambda: mesh_sort.merge_split(a, b, True))
    merge_host = host_ms(lambda: mesh_sort.merge_split(a, b, True))
    ab = torch.cat([a, b])
    merge_library_device, merge_library_kernels, _ = device_ms(lambda: torch.sort(ab))
    merge_library_ms = kernel_ms(lambda: torch.sort(ab))
    _, merge_plain_ms = plain_ms(lambda: mesh_sort.merge_split_plain(a, b, True))
    # L keys in (the split's search finds where the kept half starts; only
    # those keys are read), L out, L comparisons
    merge_bound = roofline(8 * 2 * half, half)
    del flag_keys, a, b, ab
    phase("mesh_sort_vs_plain", seconds=time.monotonic() - t0, keys=len(keys),
          sort_mismatches=sort_bad, merge_split_mismatches=merge_bad,
          sort_ms=sort_ms, sort_plain_on_gpu_ms=sort_plain_ms,
          sort_library_ms=sort_library_ms, sort_bound_ms=sort_roof[0],
          sort_device_ms=sort_device, sort_library_device_ms=sort_library_device,
          sort_device_breakdown_ms=sort_kernels, sort_launch_device_ms=sort_passes,
          sort_host_enqueue_ms=sort_host,
          block_keys=len(padded) - half, block_sort_ms=block_sort_ms,
          block_sort_device_ms=block_sort_device, block_launch_device_ms=block_passes,
          block_sort_library_device_ms=block_library_device,
          merge_split_ms=merge_ms, merge_split_plain_on_gpu_ms=merge_plain_ms,
          merge_split_library_ms=merge_library_ms, merge_split_bound_ms=merge_bound[0],
          merge_split_device_ms=merge_device, merge_split_device_breakdown_ms=merge_kernels,
          merge_split_host_enqueue_ms=merge_host,
          merge_split_library_device_ms=merge_library_device,
          merge_split_library_device_breakdown_ms=merge_library_kernels)
    check(sort_bad == 0 and merge_bad == 0,
          "the mesh sort kernel disagrees with its plain version")

    # 13. The sharded search stage (K6) on 4 shards of the one card, both
    # schedules: the shards run one after another on the card's stream
    t0 = time.monotonic()
    shards = mesh_mod.make_mesh([device] * MESH_SHARDS)
    stage_launches = {}
    S = len(pending)
    L = -(-S // MESH_SHARDS)
    for schedule in sssp.SCHEDULES:
        sssp.reset_kernel_launches()
        t = time.monotonic()
        stage = mesh_mod.sharded_bounded_sssp_dispatch(
            dg, pending, k - 1, CAPACITY, shards, schedule=schedule
        )
        rows, _, m_over, srcs = stage.fetch()
        mesh_s = time.monotonic() - t
        stage_launches[schedule] = dict(sssp.KERNEL_LAUNCHES)
        t = time.monotonic()
        one_rows, _, one_over = sssp.batched_bounded_sssp(
            dg, pending, k - 1, CAPACITY, return_packed=True, schedule=schedule,
            device=device,
        )
        one_s = time.monotonic() - t
        real = srcs != dg.n_nodes
        striped = all(np.array_equal(srcs[d * L:(d + 1) * L][real[d * L:(d + 1) * L]],
                                     pending[d::MESH_SHARDS]) for d in range(MESH_SHARDS))
        # rows back in the order of the sources: shard d's row j is source j * 4 + d
        by_source = rows.reshape(MESH_SHARDS, L, -1).transpose(1, 0, 2).reshape(L * MESH_SHARDS, -1)[:S]
        over_by_source = m_over.reshape(MESH_SHARDS, L).T.reshape(-1)[:S]
        flag_bad = int((over_by_source != one_over).sum())
        row_bad = int((by_source[~one_over] != one_rows[~one_over]).any(1).sum())
        launched = stage_launches[schedule]["sssp_pool" if schedule == "pool" else "sssp_wide"]
        phase("mesh_stage", schedule=schedule, shards=MESH_SHARDS, sources=S,
              padding_rows=int((~real).sum()), striped=striped, flag_mismatch=flag_bad,
              row_mismatch=row_bad, overflow=int(one_over.sum()), mesh_stage_s=mesh_s,
              kernel_ms_summed=1e3 * stage.kernel_seconds(),
              one_device_stage_s=one_s, launches=stage_launches[schedule])
        check(striped and flag_bad == 0 and row_bad == 0 and launched == MESH_SHARDS,
              f"the {schedule} mesh stage differs from the single-device stage")
        del stage, rows, one_rows
    phase("mesh_stage_done", seconds=time.monotonic() - t0)

    # 14. The sharded acceptance sort (K7) on the same mesh, and the accept
    # scan over it against the host accept
    t0 = time.monotonic()
    sssp.reset_kernel_launches()
    sorted_keys = mesh_mod.sharded_accept_key_sort(keys, shards)
    accept_launches = dict(sssp.KERNEL_LAUNCHES)
    sort_equal = np.array_equal(sorted_keys, np.sort(keys))
    m_mesh, m_host = mult.copy(), mult.copy()
    acc_mesh = greedy_accept_sorted_keys(g, sorted_keys, m_mesh)
    acc_host = greedy_accept(g, chunks, m_host)  # consumes the chunks
    accept_equal = np.array_equal(acc_mesh, acc_host) and np.array_equal(m_mesh, m_host)
    phase("mesh_accept", seconds=time.monotonic() - t0, keys=len(keys),
          shards=MESH_SHARDS, sort_equal=sort_equal, accepted=len(acc_mesh),
          accept_equal=accept_equal, launches=accept_launches)
    check(sort_equal and accept_equal, "the mesh accept differs from the host accept")
    del chunks, sorted_keys, acc_mesh, acc_host

    # 15. Deep balls: the flagship's pangenome at k=63, generated on the
    # card, and the greedytigs CLI on it at first capacity 16, then with the
    # ladder
    del g, dg, store, kmers, want_kmers, adj, src, over_sources, nbr, nw, shards, keys, padded
    torch.cuda.empty_cache()
    k63_launches = deep_balls(args, device, checks, wide)
    pool_launches += k63_launches["sssp_pool"]
    wide_launches += k63_launches["sssp_wide"]
    torch.cuda.empty_cache()

    # 16. The 60 Mbp pangenome, generated on the card, then the default
    # greedytigs CLI from fasta and from BCALM2 and the optimal-matchtigs
    # CLI on it
    pool_launches += scale60m(args, device, checks)

    # 16b. The C. elegans-sized pangenome (past 2^24 nodes), generated on
    # the card once the 60 Mbp phase's memory is freed: the wide kernel's
    # stage over the unpacked layouts, library greedy runs and the CLI
    celegans_launches = celegans_scale(args, device, wide)
    pool_launches += celegans_launches["sssp_pool"]
    wide_launches += celegans_launches["sssp_wide"]

    # 17. Two processes of one gloo group, both on the card, on the
    # flagship cached above.  Last: once a child process has used the card,
    # the profiler sees few or none of this process's device events.
    t0 = time.monotonic()
    workers = run_mesh_workers(args.genome_length, data_dir)
    w_launches = [json.loads(str(w["launches"])) for w in workers]
    same = all(np.array_equal(w[c], workers[0][c]) for w in workers
               for c in ("flat", "offsets"))
    same_host = (np.array_equal(workers[0]["flat"], workers[0]["host_flat"])
                 and np.array_equal(workers[0]["offsets"], workers[0]["host_offsets"]))
    phase("mesh_two_process", seconds=time.monotonic() - t0, processes=len(workers),
          genome_length=args.genome_length, tigs=len(workers[0]["offsets"]),
          walks_equal_across_ranks=same, walks_equal_host=same_host,
          greedy_s=[float(w["seconds"]) for w in workers], launches=w_launches)
    check(same and same_host, "two-process walks differ across ranks or from the host engine")
    check(all(w["mesh_sort"] > 0 and w["mesh_merge_split"] > 0 and w["sssp_pool"] > 0
              for w in w_launches), f"two-process launches {w_launches}")

    phase("total", seconds=time.monotonic() - t_start)
    print(json.dumps({"kernels": [
        {
            "name": "sssp_pool",
            "route": "cuda",
            "source": "matchtigs_tpu_torch/csrc/sssp_pool.cu",
            "replaces": "matchtigs_tpu/ops/sssp.py:299",
            "launches": pool_launches + sum(
                launches["sssp_pool"] for launches in (stage_launches["pool"], *w_launches)),
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": pool["kernel_ms"],
            "plain_ms": pool["plain_on_gpu_ms"],
            "bound_ms": pool["bound_ms"],
            "bound_by": pool["bound_by"],
            "library_ms": None,
        },
        {
            "name": "sssp_wide",
            "route": "cuda",
            "source": "matchtigs_tpu_torch/csrc/sssp_wide.cu",
            "replaces": "matchtigs_tpu/ops/sssp.py:133",
            "launches": wide_launches + stage_launches["batch"]["sssp_wide"],
            "max_abs_err": max(r["max_abs_err"] for r in wide),
            "ms": wide_main["kernel_ms"],
            "plain_ms": wide_main["plain_on_gpu_ms"],
            "bound_ms": wide_bound[0],
            "bound_by": wide_bound[1],
            "library_ms": None,
        },
        {
            "name": "sssp_compact",
            "route": "cuda",
            "source": "matchtigs_tpu_torch/csrc/sssp_compact.cu",
            "replaces": "matchtigs_tpu/ops/sssp.py:448",
            "launches": compact_launches,
            "max_abs_err": compact_err,
            "ms": compact_ms,
            "plain_ms": compact_plain_ms,
            "bound_ms": compact_bound[0],
            "bound_by": compact_bound[1],
            "library_ms": compact_library_ms,
        },
        {
            "name": "mesh_sort",
            "route": "cuda",
            "source": "matchtigs_tpu_torch/csrc/mesh_sort.cu",
            "replaces": "matchtigs_tpu/parallel/mesh.py:413",
            "launches": sum(w["mesh_sort"] for w in w_launches),
            "max_abs_err": sort_err,
            "ms": sort_ms,
            "plain_ms": sort_plain_ms,
            "bound_ms": sort_roof[0],
            "bound_by": sort_roof[1],
            "library_ms": sort_library_ms,
        },
        {
            "name": "mesh_merge_split",
            "route": "cuda",
            "source": "matchtigs_tpu_torch/csrc/mesh_sort.cu",
            "replaces": "matchtigs_tpu/parallel/mesh.py:445",
            "launches": sum(w["mesh_merge_split"] for w in w_launches),
            "max_abs_err": merge_err,
            "ms": merge_ms,
            "plain_ms": merge_plain_ms,
            "bound_ms": merge_bound[0],
            "bound_by": merge_bound[1],
            "library_ms": merge_library_ms,
        },
    ]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def make_dataset(genome_length: int, device, cache_dir: Path | None = None, k: int = K):
    """This script's pangenome at ``genome_length`` and ``k``, made on
    ``device``, its graph and its source split: (store, k-mers, graph,
    device graph, (out_nodes, in_mask, mult), device sources, fields), the
    fields being the generation seconds, peak device memory, sha256, graph
    build seconds, counts and the process's peak host memory."""
    from matchtigs_tpu_torch import testing
    from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs

    t = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    store, kmers, k = testing.make_pangenome_store(
        genome_length=genome_length, k=k, n_strains=N_STRAINS,
        mutation_rate=MUTATION_RATE, seed=SEED, with_repeats=True, device=device,
        cache_dir=None if cache_dir is None else str(cache_dir),
    )
    fields = dict(genome_length=genome_length, generation_s=time.monotonic() - t,
                  peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
                  sha256=dataset_digest(store, kmers))
    t = time.monotonic()
    g = build_bigraph_from_unitigs(store, k)
    fields["graph_s"] = time.monotonic() - t
    dg, unbalanced, pending, host_routed = device_sources(g)
    fields.update(unitigs=len(store), bases=int(store.offsets[-1]), kmers=len(kmers),
                  nodes=g.n_nodes, sources=len(unbalanced[0]), device_sources=len(pending),
                  host_routed=host_routed, peak_host_rss_gib=peak_rss_gib())
    return store, kmers, g, dg, unbalanced, pending, fields


def device_sources(g):
    """(device graph, (out_nodes, in_mask, mult), device sources,
    host-routed count) of ``g``, split as the greedy stage splits them."""
    from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig, split_device_sources
    from matchtigs_tpu_torch.ops.device_graph import build_device_graph
    from matchtigs_tpu_torch.ops.matching import unbalanced_nodes

    unbalanced = unbalanced_nodes(g)
    dg = build_device_graph(g)
    pending, hard = split_device_sources(
        dg, unbalanced[0], GreedytigConfig.host_route_threshold)
    return dg, unbalanced, pending, 0 if hard is None else len(hard)


def deep_balls(args, device, checks: list, wide: list) -> dict:
    """The phases ``dataset_k63``, ``cli_device_k63`` and ``cli_ladder_k63``
    (with ``wide_ball_census_k63``): the flagship's pangenome at k=63 made
    on the card, the greedytigs CLI on it at first capacity 16 and then
    with the ladder, each held to the host engine's fasta and to the input
    k-mer set; ``pool_sssp`` at C=16 on all device sources and at C=64 and
    1024 on those that overflow C=16, each held to its plain version
    (appended to ``checks`` and ``wide``).  Returns the CLI runs' launches
    per kernel."""
    from matchtigs_tpu_torch.algos.greedytigs import (
        GreedytigConfig, SearchStats, compute_greedytigs,
    )
    from matchtigs_tpu_torch import testing
    from matchtigs_tpu_torch.io.writers import write_walks_fasta
    from matchtigs_tpu_torch.ops import sssp

    t0 = time.monotonic()
    store, kmers, g, dg, _, pending, data = make_dataset(args.genome_length, device, k=K63)
    k = K63
    checked = args.genome_length == FLAGSHIP_LENGTH
    phase("dataset_k63", seconds=time.monotonic() - t0, k=k, **data, checked=checked)
    if checked:
        counts = {c: data[c] for c in K63_COUNTS}
        check(data["sha256"] == K63_SHA256 and counts == K63_COUNTS,
              f"the k=63 dataset differs from the JAX generator's: {data['sha256']} {counts}")

    launched = dict.fromkeys(ONE_POOL_LAUNCH, 0)
    first_capacity = ("--sssp-initial-capacity", str(K63_CAPACITY))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        fa_in, fa_out, host_out = (Path(tmp) / f for f in ("unitigs.fa.gz", "out.fa", "host.fa"))
        t = time.monotonic()
        testing.write_fasta(fa_in, store)
        write_s = time.monotonic() - t
        rc, launches, cli_s, out_store, laps = run_cli(fa_in, k, *first_capacity)
        check(rc == 0 and launches == ONE_POOL_LAUNCH,
              f"k=63 CLI rc {rc}, kernel launches {launches}")
        tigs, length = len(out_store), int(out_store.offsets[-1])
        kmer_equal = bool(np.array_equal(spelled_kmer_set(out_store, k, device), kmers))
        cli_fasta = fa_out.read_bytes()
        del out_store
        t = time.monotonic()
        hg = g.copy()
        host = compute_greedytigs(hg, GreedytigConfig(k=k, engine="host"))
        host_s = time.monotonic() - t
        write_walks_fasta(hg, host, store, k, host_out)
        host_fasta = host_out.read_bytes()
        fasta_equal = host_fasta == cli_fasta
        del hg, host, cli_fasta
        launched = {name: n + launches[name] for name, n in launched.items()}

        # the register kernel at C=16 on every device source (the CLI's
        # launch), then the first sources against the plain version on the
        # host
        adj = dg.device_buffers(device)
        src = torch.from_numpy(pending).to(device)
        _, over16, pool = pool_reading(sssp, adj, src, k - 1, dg.deg_pad, K63_CAPACITY)
        first = compare(sssp, dg, pending[:N_FLAGSHIP_CHECK], k - 1, K63_CAPACITY, device)
        checks += [pool, first]
        phase("cli_device_k63", seconds=time.monotonic() - t0, write_fasta_s=write_s,
              cli_s=cli_s, **laps, launches=launches, tigs=tigs, cumulative_length=length,
              host_engine_s=host_s, fasta_equal_host=fasta_equal, kmer_set_equal=kmer_equal,
              registers_and_spilled_bytes=sssp.pool_kernel_attributes(K63_CAPACITY),
              first_sources_vs_plain_on_host=first, peak_host_rss_gib=peak_rss_gib(), **pool)
        check(fasta_equal and kmer_equal,
              f"k=63 CLI: fasta equal to the host engine's {fasta_equal}, "
              f"k-mer set equal {kmer_equal}")
        check(not any(r["flag_mismatch"] or r["row_mismatch"] for r in (pool, first)),
              "the register kernel disagrees with its plain version at k=63")
        check(pool["kernel_device_ops"] == 1,
              f"the k=63 C=16 call ran {pool['kernel_device_ops']} device operations")
        over_sources = src[over16.bool()].contiguous()
        del src, over16

        # the ladder: the CLI, then a library run for its stages
        t0 = time.monotonic()
        rc, launches, ladder_s, out_store, laps = run_cli(
            fa_in, k, *first_capacity, "--sssp-overflow-mode", "ladder")
        check(rc == 0, f"k=63 ladder CLI rc {rc}")
        ladder_tigs, ladder_len = len(out_store), int(out_store.offsets[-1])
        ladder_kmers = bool(np.array_equal(spelled_kmer_set(out_store, k, device), kmers))
        ladder_fasta = fa_out.read_bytes() == host_fasta
        del out_store, host_fasta
        launched = {name: n + launches[name] for name, n in launched.items()}
        stats = SearchStats()
        compute_greedytigs(g.copy(), GreedytigConfig(
            k=k, initial_capacity=K63_CAPACITY, overflow_mode="ladder"), stats)
        capacities = [K63_CAPACITY * 4 ** i for i in range(len(stats.stage_sources))]
        # the wide kernel at the ladder's first wide stage, and at C=1024
        # for the census, on the sources that overflow C=16
        readings = []
        for cap in (K63_WIDE_CAPACITY, K63_CENSUS_CAPACITY):
            rows, over, r = pool_reading(sssp, adj, over_sources, k - 1, dg.deg_pad, cap)
            readings.append(r)
        wide += readings
        phase("cli_ladder_k63", seconds=time.monotonic() - t0, cli_s=ladder_s, **laps,
              launches=launches, stage_capacities=capacities,
              stage_sources=stats.stage_sources,
              stage_kernel_ms=[1e3 * x for x in stats.stage_kernel_times],
              tigs=ladder_tigs, cumulative_length=ladder_len, fasta_equal_host=ladder_fasta,
              kmer_set_equal=ladder_kmers, wide=readings)
        phase("wide_ball_census_k63", **ball_census(rows, over, dg.sentinel))
        check(ladder_fasta and ladder_kmers,
              f"k=63 ladder CLI: fasta equal to the host engine's {ladder_fasta}, "
              f"k-mer set equal {ladder_kmers}")
        check(len(capacities) >= 2 and launches == dict(
            ONE_POOL_LAUNCH, sssp_wide=len(capacities) - 1),
              f"k=63 ladder launches {launches} for the stages {capacities}")
        check(not any(r["flag_mismatch"] or r["row_mismatch"] for r in readings),
              "the wide kernel disagrees with its plain version at k=63")
    return launched


def link_inputs(store, g, k: int, want_kmers: np.ndarray, fa_in: Path, device,
                checks: list, overlap: dict, greedy: tuple) -> int:
    """The phases ``links_inputs``, ``cli_bcalm_in`` and ``cli_gfa_in`` on
    the flagship (``store``, its overlap graph ``g``, the gzipped fasta
    ``fa_in``): its links written as BCALM2 and as gzipped GFA beside
    ``fa_in``, the greedytigs CLI from fasta and from BCALM2 back to back,
    then one CLI run from GFA writing greedytigs fasta and GFA, matchtigs
    and eulertigs, each held to its gates; ``overlap`` is the overlap
    graph's ``pool_reading`` and ``greedy`` the fasta CLI's (tigs, length)
    from ``cli_device``.  ``sssp_pool``'s reading on the link-built graph
    is appended to ``checks``.  Returns the CLI runs' ``sssp_pool``
    launches."""
    from matchtigs_tpu_torch import testing
    from matchtigs_tpu_torch.io.readers import read_fasta, read_gfa

    tmp = fa_in.parent
    t0 = time.monotonic()
    t = time.monotonic()
    links = testing.graph_links(g)
    links_s = time.monotonic() - t
    bcalm_in, gfa_in = tmp / "unitigs.bcalm.fa", tmp / "unitigs.gfa.gz"
    t = time.monotonic()
    testing.write_bcalm2(bcalm_in, store, links)
    bcalm_s = time.monotonic() - t
    t = time.monotonic()
    testing.write_gfa(gfa_in, store, links, k)
    gfa_s = time.monotonic() - t
    phase("links_inputs", seconds=time.monotonic() - t0, unitigs=len(store),
          links=len(links), links_per_unitig=len(links) / len(store), graph_links_s=links_s,
          write_bcalm2_s=bcalm_s, write_gfa_s=gfa_s, fasta_gz_bytes=fa_in.stat().st_size,
          bcalm2_bytes=bcalm_in.stat().st_size, gfa_gz_bytes=gfa_in.stat().st_size)

    # the fasta and the BCALM2 CLI back to back, then the gates on the
    # BCALM2 run
    t0 = time.monotonic()
    runs = {}
    for flag, path in (("--fa-in", fa_in), ("--bcalm-in", bcalm_in)):
        rc, launches, cli_s, out_store, laps = run_cli(path, k, in_flag=flag)
        check(rc == 0 and launches == ONE_POOL_LAUNCH,
              f"{flag} CLI rc {rc}, kernel launches {launches}")
        runs[flag] = dict(cli_s=cli_s, **laps, tigs=len(out_store),
                          cumulative_length=int(out_store.offsets[-1]))
    cli_fasta = (tmp / "out.fa").read_bytes()
    bcalm_digest = hashlib.sha256(cli_fasta).hexdigest()
    kmer_equal = bool(np.array_equal(spelled_kmer_set(out_store, k, device), want_kmers))
    del out_store
    link = link_graph_reading(store, links, k, g, cli_fasta, tmp, device, checks)
    del cli_fasta, links
    bcalm = runs["--bcalm-in"]
    phase("cli_bcalm_in", seconds=time.monotonic() - t0, fa_in=runs["--fa-in"], bcalm_in=bcalm,
          launches=launches, kmer_set_equal=kmer_equal, **link,
          overlap_kernel_device_ms=overlap["kernel_device_ms"],
          overlap_bound_ms=overlap["bound_ms"], overlap_sources=overlap["sources"],
          cli_device_tigs=greedy[0], cli_device_cumulative_length=greedy[1],
          tigs_minus_cli_device=bcalm["tigs"] - greedy[0],
          length_minus_cli_device=bcalm["cumulative_length"] - greedy[1])
    check(kmer_equal and link["same_graph_up_to_node_ids"] and link["fasta_equal_host"],
          f"BCALM2 CLI: k-mer set equal {kmer_equal}, {link}")
    check(not (link["pool"]["flag_mismatch"] or link["pool"]["row_mismatch"]),
          "the register kernel disagrees with its plain version on the link-built graph")
    launched = 2

    # one GFA run (k from its header) writing four outputs
    t0 = time.monotonic()
    outs = {name: tmp / f"gfa_in.{name}" for name in
            ("greedytigs-fa", "greedytigs-gfa", "matchtigs-fa", "eulertigs-fa")}
    rc, launches, cli_s, _, laps = run_cli(
        gfa_in, None, *(a for name, path in outs.items() for a in (f"--{name}-out", str(path))),
        in_flag="--gfa-in", out_flag=None)
    check(rc == 0 and launches == dict(ONE_POOL_LAUNCH, sssp_pool=2),
          f"GFA CLI rc {rc}, kernel launches {launches}")
    launched += launches["sssp_pool"]
    greedy_equal = hashlib.sha256(outs["greedytigs-fa"].read_bytes()).hexdigest() == bcalm_digest
    written = {}
    for name in ("greedytigs-fa", "matchtigs-fa", "eulertigs-fa"):
        out_store = read_fasta(outs[name])[0]
        spelled = testing.spelled_kmers_torch(out_store, k, device)
        unique = testing.kmers_to_numpy(testing.sorted_unique_kmers(spelled, k))
        written[name] = dict(tigs=len(out_store), cumulative_length=int(out_store.offsets[-1]),
                             kmers=len(spelled),
                             kmer_set_equal=bool(np.array_equal(unique, want_kmers)))
        if name == "greedytigs-fa":
            gfa_store = read_gfa(outs["greedytigs-gfa"])[0]
            gfa_equal = (np.array_equal(gfa_store.offsets, out_store.offsets)
                         and np.array_equal(gfa_store.packed, out_store.packed))
        del out_store, spelled, unique
    euler_once = written["eulertigs-fa"]["kmers"] == len(want_kmers)
    shorter = (written["matchtigs-fa"]["cumulative_length"]
               <= written["greedytigs-fa"]["cumulative_length"])
    phase("cli_gfa_in", seconds=time.monotonic() - t0, cli_s=cli_s, **laps, launches=launches,
          outputs=written, greedy_fasta_equal_bcalm_in=greedy_equal,
          greedy_gfa_equal_fasta=gfa_equal, eulertigs_each_kmer_once=euler_once,
          matchtigs_no_longer=shorter)
    check(greedy_equal and gfa_equal and euler_once and shorter
          and all(w["kmer_set_equal"] for w in written.values()),
          f"GFA CLI outputs: greedy fasta equal to BCALM2's {greedy_equal}, GFA equal to "
          f"its fasta {gfa_equal}, eulertigs once {euler_once}, matchtigs no longer "
          f"{shorter}, {written}")
    for path in (bcalm_in, gfa_in, *outs.values()):
        path.unlink()
    return launched


def link_graph_reading(store, links, k: int, g, cli_fasta: bytes, tmp: Path, device,
                       checks: list) -> dict:
    """The graph ``build_bigraph_from_links`` makes from ``links`` (those
    written to the file the CLI read): whether it is ``g`` up to node
    numbering once the nodes no link names are split
    (``testing.split_linkless_nodes``; how many more nodes that makes, and
    whether it is ``g`` itself), whether the host engine's walks on it
    write ``cli_fasta``, and ``pool_reading`` of ``sssp_pool`` on its
    device sources (appended to ``checks``)."""
    from matchtigs_tpu_torch import testing
    from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig, compute_greedytigs
    from matchtigs_tpu_torch.graph.build import build_bigraph_from_links
    from matchtigs_tpu_torch.io.writers import write_walks_fasta
    from matchtigs_tpu_torch.ops import sssp

    t = time.monotonic()
    gl = build_bigraph_from_links(store, links, k)
    build_s = time.monotonic() - t
    split = testing.split_linkless_nodes(g)
    same = testing.same_graph_up_to_node_ids(split, gl)
    split_nodes = split.n_nodes - g.n_nodes
    same_unsplit = testing.same_graph_up_to_node_ids(g, gl)
    del split
    t = time.monotonic()
    hg = gl.copy()
    host = compute_greedytigs(hg, GreedytigConfig(k=k, engine="host"))
    host_s = time.monotonic() - t
    host_out = tmp / "host.fa"
    write_walks_fasta(hg, host, store, k, host_out)
    fasta_equal = host_out.read_bytes() == cli_fasta
    host_out.unlink()
    del hg, host
    dg, _, pending, host_routed = device_sources(gl)
    _, _, pool = pool_reading(sssp, dg.device_buffers(device),
                              torch.from_numpy(pending).to(device), k - 1, dg.deg_pad)
    checks.append(pool)
    return dict(link_build_s=build_s, same_graph_up_to_node_ids=same,
                linkless_split_nodes=split_nodes, same_graph_unsplit=same_unsplit,
                host_engine_s=host_s, fasta_equal_host=fasta_equal, nodes=gl.n_nodes,
                device_sources=len(pending), host_routed=host_routed, pool=pool,
                peak_host_rss_gib=peak_rss_gib())


def scale60m(args, device, checks: list) -> int:
    """The phases ``dataset_60m``, ``cli_device_60m``, ``cli_bcalm_in_60m``
    and ``cli_matchtigs_60m``: the 60 Mbp pangenome (six times
    ``--genome-length``) made on the card, the CLI runs on it (from fasta,
    then from the same set as BCALM2) held to the host engine and to the
    input k-mer set, and the register kernel at its shape, on the overlap
    graph and on the link-built graph, held to its plain version (appended
    to ``checks``).  Returns the CLI runs' ``sssp_pool`` launches."""
    from matchtigs_tpu_torch import testing
    from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig, compute_greedytigs
    from matchtigs_tpu_torch.io.writers import write_walks_fasta
    from matchtigs_tpu_torch.ops import sssp

    t0 = time.monotonic()
    genome_length = SCALE60M_LENGTH * args.genome_length // FLAGSHIP_LENGTH
    store, kmers, g, dg, _, pending, data = make_dataset(genome_length, device)
    k = K
    checked = genome_length == SCALE60M_LENGTH
    phase("dataset_60m", seconds=time.monotonic() - t0, **data, checked=checked)
    if checked:
        counts = {c: data[c] for c in SCALE60M_COUNTS}
        check(counts == SCALE60M_COUNTS and data["sha256"] == SCALE60M_SHA256,
              f"the 60 Mbp dataset differs: {data['sha256']} {counts} against "
              f"{SCALE60M_COUNTS}")

    t0 = time.monotonic()
    launched = 0
    with tempfile.TemporaryDirectory() as tmp:
        fa_in, fa_out = Path(tmp) / "unitigs.fa.gz", Path(tmp) / "out.fa"
        t = time.monotonic()
        testing.write_fasta(fa_in, store)
        write_s = time.monotonic() - t
        rc, launches, cli_s, out_store, laps = run_cli(fa_in, k)
        check(rc == 0 and launches == ONE_POOL_LAUNCH,
              f"60M CLI rc {rc}, kernel launches {launches}")
        launched += launches["sssp_pool"]
        tigs, length = len(out_store), int(out_store.offsets[-1])
        kmer_equal = bool(np.array_equal(spelled_kmer_set(out_store, k, device), kmers))
        del out_store
        cli_fasta = fa_out.read_bytes()
        t = time.monotonic()
        hg = g.copy()
        host = compute_greedytigs(hg, GreedytigConfig(k=k, engine="host"))
        host_s = time.monotonic() - t
        write_walks_fasta(hg, host, store, k, Path(tmp) / "host.fa")
        fasta_equal = (Path(tmp) / "host.fa").read_bytes() == cli_fasta
        del hg, host, cli_fasta

        # the register kernel at this shape, against its plain version
        _, _, pool = pool_reading(sssp, dg.device_buffers(device),
                                  torch.from_numpy(pending).to(device), k - 1, dg.deg_pad)
        checks.append(pool)
        phase("cli_device_60m", seconds=time.monotonic() - t0, write_fasta_s=write_s,
              cli_s=cli_s, **laps, launches=launches, tigs=tigs, cumulative_length=length,
              baseline_md_tigs=1_033_578, host_engine_s=host_s,
              fasta_equal_host=fasta_equal, kmer_set_equal=kmer_equal,
              peak_host_rss_gib=peak_rss_gib(), **pool)
        check(fasta_equal and kmer_equal,
              f"60M CLI: fasta equal to the host engine's {fasta_equal}, "
              f"k-mer set equal {kmer_equal}")
        check(not (pool["flag_mismatch"] or pool["row_mismatch"]),
              "kernel disagrees with its plain version at the 60M shape")
        fa_cli = dict(cli_s=cli_s, **laps, tigs=tigs, cumulative_length=length)
        overlap = {f: pool[f] for f in ("kernel_device_ms", "bound_ms", "sources")}
        del pool

        # the same set as BCALM2, and the greedytigs CLI from it
        t0 = time.monotonic()
        bcalm_in = Path(tmp) / "unitigs.bcalm.fa"
        t = time.monotonic()
        links = testing.graph_links(g)
        n_links, links_s = len(links), time.monotonic() - t
        t = time.monotonic()
        testing.write_bcalm2(bcalm_in, store, links)
        bcalm_s = time.monotonic() - t
        rc, launches, cli_s, out_store, laps = run_cli(bcalm_in, k, in_flag="--bcalm-in")
        check(rc == 0 and launches == ONE_POOL_LAUNCH,
              f"60M BCALM2 CLI rc {rc}, kernel launches {launches}")
        launched += launches["sssp_pool"]
        bcalm_cli = dict(cli_s=cli_s, **laps, tigs=len(out_store),
                         cumulative_length=int(out_store.offsets[-1]))
        kmer_equal = bool(np.array_equal(spelled_kmer_set(out_store, k, device), kmers))
        del out_store
        link = link_graph_reading(store, links, k, g, fa_out.read_bytes(), Path(tmp), device,
                                  checks)
        del links
        phase("cli_bcalm_in_60m", seconds=time.monotonic() - t0, links=n_links,
              graph_links_s=links_s, write_bcalm2_s=bcalm_s,
              bcalm2_bytes=bcalm_in.stat().st_size, bcalm_in=bcalm_cli, fa_in=fa_cli,
              launches=launches, kmer_set_equal=kmer_equal, **link,
              overlap_kernel_device_ms=overlap["kernel_device_ms"],
              overlap_bound_ms=overlap["bound_ms"], overlap_sources=overlap["sources"])
        check(kmer_equal and link["same_graph_up_to_node_ids"] and link["fasta_equal_host"],
              f"60M BCALM2 CLI: k-mer set equal {kmer_equal}, {link}")
        check(not (link["pool"]["flag_mismatch"] or link["pool"]["row_mismatch"]),
              "kernel disagrees with its plain version on the 60M link-built graph")
        bcalm_in.unlink()
        del link

        t0 = time.monotonic()
        with LogCapture("matchtigs_tpu_torch.algos.matchtigs") as log:
            rc, launches, mt_s, out_store, laps = run_cli(fa_in, k,
                                                          out_flag="--matchtigs-fa-out")
        check(rc == 0 and launches == ONE_POOL_LAUNCH,
              f"60M matchtigs CLI rc {rc}, kernel launches {launches}")
        launched += launches["sssp_pool"]
        mt_tigs, mt_len = len(out_store), int(out_store.offsets[-1])
        mt_equal = bool(np.array_equal(spelled_kmer_set(out_store, k, device), kmers))
        phase("cli_matchtigs_60m", seconds=time.monotonic() - t0, cli_s=mt_s, **laps,
              **matching_instance(log), launches=launches, tigs=mt_tigs,
              cumulative_length=mt_len,
              greedy_tigs=tigs, greedy_cumulative_length=length,
              kmer_set_equal=mt_equal, peak_host_rss_gib=peak_rss_gib())
        check(mt_equal and mt_len <= length,
              f"60M matchtigs: k-mer set equal {mt_equal}, length {mt_len} "
              f"against greedy's {length}")
    return launched


def celegans_scale(args, device, checks: list) -> dict:
    """The phases ``dataset_celegans``, ``celegans_stage``,
    ``greedy_celegans``, ``cli_device_celegans``,
    ``matchtigs_celegans_collapse`` and ``cli_matchtigs_celegans``: the C.
    elegans-sized pangenome (``CELEGANS_LENGTH`` scaled as
    ``--genome-length`` scales the flagship) made on the card after the 60
    Mbp phase's memory is freed;
    at the full length its node ids pass ``NODE_ID_LIMIT``, so the default
    stage leaves ``sssp_pool`` for ``sssp_wide`` over the unpacked
    adjacency and rows.  The wide kernel on every device source at C=4,
    pool schedule, held to its plain version on the card (appended to
    ``checks``) and read (events, profiler device time per tier, device
    operations, bound, ball census), then the stage's dispatch and
    download; library greedy runs of both engines in alternation, and the
    greedytigs CLI, held to the host engine's walks and to the input k-mer
    set; then optimal matchtigs: the front's candidates and collapses
    (``celegans_collapse``) and its CLI from the same fasta, held to the
    input k-mer set and to greedy's length.  Returns the path runs'
    launches per kernel (the CLIs' and the device-engine library runs')."""
    from matchtigs_tpu_torch import testing
    from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig, compute_greedytigs
    from matchtigs_tpu_torch.io.writers import spell_walks_flat, write_walks_fasta
    from matchtigs_tpu_torch.ops import sssp

    t_group = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    genome_length = CELEGANS_LENGTH * args.genome_length // FLAGSHIP_LENGTH
    store, kmers, g, dg, (_, in_mask, _), pending, data = make_dataset(genome_length, device)
    k = K
    full = genome_length == CELEGANS_LENGTH
    packs = dict(can_pack_out=sssp._can_pack_out(dg, k - 1),
                 can_pack_adj=sssp._can_pack_adj(dg, k - 1))
    # the stage this graph takes: the register kernel where both layouts
    # pack, else the wide kernel
    stage_launches = dict.fromkeys(ONE_POOL_LAUNCH, 0)
    stage_launches["sssp_pool" if all(packs.values()) else "sssp_wide"] = 1
    t = time.monotonic()
    spelled = testing.spelled_kmers_torch(store, k, device)
    n_spelled = len(spelled)
    unique = testing.kmers_to_numpy(testing.sorted_unique_kmers(spelled, k))
    del spelled
    once = n_spelled == len(kmers) and bool(np.array_equal(unique, kmers))
    del unique
    data["port_sha256"] = data.pop("sha256")  # the port's output; no JAX digest at this size
    phase("dataset_celegans", seconds=time.monotonic() - t0, **data, **packs,
          node_id_limit=NODE_ID_LIMIT, past_node_id_limit=g.n_nodes + 1 >= NODE_ID_LIMIT,
          spelled_kmers=n_spelled, each_kmer_once=once, kmer_check_s=time.monotonic() - t,
          checked=full)
    check(once, f"the unitigs spell {n_spelled} k-mers, the set has {len(kmers)}")
    if full:
        check(g.n_nodes + 1 >= NODE_ID_LIMIT and not any(packs.values()),
              f"the C. elegans-sized graph has {g.n_nodes} nodes and packs {packs}: "
              "it does not leave the packed layouts")
        counts = {c: data[c] for c in CELEGANS_COUNTS}
        check(counts == CELEGANS_COUNTS and data["port_sha256"] == CELEGANS_SHA256,
              f"the C. elegans-sized dataset differs: {data['port_sha256']} {counts}")

    # the wide kernel at the stage's shape (every device source, C=4, pool
    # schedule, unpacked adjacency and rows) against its plain version on
    # the card, then the stage itself: dispatch, download and extraction
    t0 = time.monotonic()
    nbr, nw = dg.device_buffers(device, adj_packed=False)
    src = torch.from_numpy(pending).to(device)

    def run():
        return sssp.wide_sssp(nbr, src, k - 1, CAPACITY, nw=nw, pack_out=False)
    got = run()
    want, p_ms = plain_ms(lambda: sssp.pool_sssp_plain(nbr, src, k - 1, CAPACITY, nw=nw,
                                                       pack_out=False))
    reading = dict(layout="unpacked", schedule="pool", capacity=CAPACITY, sources=len(src),
                   kernel_ms=kernel_ms(run), plain_on_gpu_ms=p_ms, **row_mismatches(got, want))
    del want
    reading["bound_ms"], reading["bound_by"] = search_bound(
        nbr, src, got[0], got[2], dg.deg_pad, nw=nw, dist=got[1])
    census = ball_census(got[0], got[2], dg.sentinel, dist=got[1])
    device_time, breakdown, _ = device_ms(run)
    reading.update(kernel_device_ms=device_time, kernel_device_breakdown_ms=breakdown,
                   kernel_device_ops=device_ops(run), host_enqueue_ms=host_ms(run),
                   overflow_frac=float(got[2].float().mean()))
    over_kernel = got[2].cpu().numpy().astype(bool)
    del got
    checks.append(reading)
    sssp.reset_kernel_launches()
    t = time.monotonic()
    stage = sssp.batched_bounded_sssp_dispatch(dg, pending, k - 1, CAPACITY, device)
    tri, over = stage.fetch_candidates(dg, pending, in_mask)
    stage_s = time.monotonic() - t
    launches = dict(sssp.KERNEL_LAUNCHES)
    phase("celegans_stage", seconds=time.monotonic() - t0, **reading, census=census,
          adjacency_bytes=nbr.numel() * nbr.element_size() * 2,
          stage_launches=launches, stage_s=stage_s, stage_kernel_s=stage.kernel_seconds(),
          bytes_fetched=stage.bytes_fetched, candidates=len(tri),
          stage_overflow_equal=bool(np.array_equal(over, over_kernel)))
    check(not (reading["flag_mismatch"] or reading["row_mismatch"]),
          f"the wide kernel disagrees with its plain version at the C. elegans shape: {reading}")
    check(launches == stage_launches and np.array_equal(over, over_kernel),
          f"the C. elegans stage launched {launches}, expected {stage_launches}")
    del stage, tri, over, over_kernel, src, nbr, nw

    # library runs of both engines in alternation; only scalars stay
    # between runs (the first host run's fasta digest for the CLI's gate)
    t0 = time.monotonic()
    launched = dict.fromkeys(ONE_POOL_LAUNCH, 0)
    runs = []
    host_fasta = None
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(CELEGANS_GREEDY_PAIRS):
            for engine in ("device", "host"):
                gg = g.copy()
                sssp.reset_kernel_launches()
                t = time.monotonic()
                tigs = compute_greedytigs(gg, GreedytigConfig(k=k, engine=engine))
                torch.cuda.synchronize()
                seconds = time.monotonic() - t
                walks = hashlib.sha256(tigs.flat.tobytes())
                walks.update(tigs.offsets.tobytes())
                _, off = spell_walks_flat(gg, tigs, store, k)
                runs.append(dict(engine=engine, seconds=seconds, tigs=len(tigs),
                                 cumulative_length=int(off[-1]),
                                 walks_sha256=walks.hexdigest(),
                                 launches=dict(sssp.KERNEL_LAUNCHES)))
                if engine == "device":
                    launched = {n: c + sssp.KERNEL_LAUNCHES[n] for n, c in launched.items()}
                elif host_fasta is None:
                    path = Path(tmp) / "host.fa"
                    write_walks_fasta(gg, tigs, store, k, path)
                    host_fasta = hashlib.sha256(path.read_bytes()).hexdigest()
                del gg, tigs, off
    results = {(r["tigs"], r["cumulative_length"], r["walks_sha256"]) for r in runs}
    device_runs = [r for r in runs if r["engine"] == "device"]
    phase("greedy_celegans", seconds=time.monotonic() - t0, runs=runs,
          device_s=[r["seconds"] for r in device_runs],
          host_s=[r["seconds"] for r in runs if r["engine"] == "host"],
          walks_equal=len(results) == 1, peak_host_rss_gib=peak_rss_gib())
    check(len(results) == 1, f"C. elegans library runs differ: {runs}")
    check(all(r["launches"] == stage_launches for r in device_runs),
          f"C. elegans device-engine launches {[r['launches'] for r in device_runs]}, "
          f"expected {stage_launches}")
    (tigs, length, _), = results

    # the greedytigs CLI from the gzipped fasta; the optimal front's phases
    # after it reuse the fasta, the graph and the k-mer set
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        fa_in, fa_out = Path(tmp) / "unitigs.fa.gz", Path(tmp) / "out.fa"
        t = time.monotonic()
        testing.write_fasta(fa_in, store)
        write_s = time.monotonic() - t
        del store, dg
        gc.collect()
        rc, launches, cli_s, out_store, laps = run_cli(fa_in, k)
        check(rc == 0 and launches == stage_launches,
              f"C. elegans CLI rc {rc}, kernel launches {launches}, expected {stage_launches}")
        launched = {n: c + launches[n] for n, c in launched.items()}
        cli_tigs, cli_len = len(out_store), int(out_store.offsets[-1])
        kmer_equal = bool(np.array_equal(spelled_kmer_set(out_store, k, device), kmers))
        del out_store
        fasta_equal = hashlib.sha256(fa_out.read_bytes()).hexdigest() == host_fasta
        phase("cli_device_celegans", seconds=time.monotonic() - t0, write_fasta_s=write_s,
              cli_s=cli_s, **laps, launches=launches, tigs=cli_tigs, cumulative_length=cli_len,
              library_tigs=tigs, library_cumulative_length=length,
              fasta_equal_host=fasta_equal, kmer_set_equal=kmer_equal,
              peak_host_rss_gib=peak_rss_gib())
        check(fasta_equal and kmer_equal and (cli_tigs, cli_len) == (tigs, length),
              f"C. elegans CLI: fasta equal to the host engine's {fasta_equal}, k-mer set "
              f"equal {kmer_equal}, tigs {cli_tigs} / {cli_len} against {tigs} / {length}")

        launches = celegans_collapse(g, k, stage_launches)
        launched = {n: c + launches[n] for n, c in launched.items()}
        del g
        gc.collect()

        # the optimal-matchtigs CLI from the same fasta
        t0 = time.monotonic()
        with LogCapture("matchtigs_tpu_torch.algos.matchtigs") as log:
            rc, launches, mt_s, out_store, cli_laps = run_cli(
                fa_in, k, out_flag="--matchtigs-fa-out")
        check(rc == 0 and launches == stage_launches,
              f"C. elegans matchtigs CLI rc {rc}, kernel launches {launches}, "
              f"expected {stage_launches}")
        launched = {n: c + launches[n] for n, c in launched.items()}
        mt_tigs, mt_len = len(out_store), int(out_store.offsets[-1])
        kmer_equal = bool(np.array_equal(spelled_kmer_set(out_store, k, device), kmers))
        del out_store
    phase("cli_matchtigs_celegans", seconds=time.monotonic() - t0, cli_s=mt_s, **cli_laps,
          **matching_instance(log), launches=launches, tigs=mt_tigs, cumulative_length=mt_len,
          greedy_tigs=tigs, greedy_cumulative_length=length,
          saving_over_greedy=length - mt_len, kmer_set_equal=kmer_equal,
          peak_host_rss_gib=peak_rss_gib())
    check(kmer_equal and mt_len <= length,
          f"C. elegans matchtigs: k-mer set equal {kmer_equal}, length {mt_len} against "
          f"greedy's {length}")
    phase("celegans_scale_done", seconds=time.monotonic() - t_group, launches=launched)
    return launched


def celegans_collapse(g, k: int, stage_launches: dict) -> dict:
    """The phase ``matchtigs_celegans_collapse``: the optimal front's
    candidates from the device engine (one stage launch) and from the host
    engine, equal as sets; then the device-order candidates collapsed on
    the route their id count picks (the packed route and its id width),
    and the host-order ones on the argsort route (forced below 2^26 + 1
    ids by passing ``ARGSORT_IDS``, which keeps the pair keys' order), all
    five columns equal.  Returns the device engine's launches per
    kernel."""
    from matchtigs_tpu_torch.algos import matchtigs as mt
    from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig, collect_candidates
    from matchtigs_tpu_torch.ops import sssp
    from matchtigs_tpu_torch.ops.matching import unbalanced_nodes

    t0 = time.monotonic()
    out_nodes, in_mask, _ = unbalanced_nodes(g)
    cands, candidate_s = {}, {}
    for engine in ("device", "host"):
        sssp.reset_kernel_launches()
        t = time.monotonic()
        cands[engine] = collect_candidates(g, out_nodes, in_mask, k,
                                           GreedytigConfig(k=k, engine=engine))
        torch.cuda.synchronize()
        candidate_s[engine] = time.monotonic() - t
        if engine == "device":
            launches = dict(sssp.KERNEL_LAUNCHES)
    same_set = np.array_equal(*(candidate_keys(c, g.n_nodes) for c in cands.values()))
    ids_start, ids_count, n_ids, _, _ = mt._matching_node_ids(g, g.imbalances())
    n_candidates = len(cands["device"])  # the collapse empties the candidates

    packed_calls = [0]
    id_bits = {}
    packed = mt._collapse_candidates_packed

    def counted(*a):
        packed_calls[0] += 1
        id_bits[engine] = a[4]
        return packed(*a)
    collapsed, collapse_s, routes = {}, {}, {}
    mt._collapse_candidates_packed = counted
    try:
        for engine, ids in (("device", n_ids), ("host", max(n_ids, ARGSORT_IDS))):
            packed_calls[0] = 0
            t = time.monotonic()
            collapsed[engine] = mt._collapse_candidates(g, cands[engine], ids_start,
                                                        ids_count, ids)
            collapse_s[engine] = time.monotonic() - t
            routes[engine] = "packed" if packed_calls[0] else "argsort"
    finally:
        mt._collapse_candidates_packed = packed
    same_columns = all(np.array_equal(a, b)
                       for a, b in zip(collapsed["device"], collapsed["host"]))
    phase("matchtigs_celegans_collapse", seconds=time.monotonic() - t0, n_ids=n_ids,
          past_packed_id_limit=n_ids >= ARGSORT_IDS, routes=routes, id_bits=id_bits,
          candidates=n_candidates, candidate_s=candidate_s,
          rows=len(collapsed["device"][0]), collapse_s=collapse_s, launches=launches,
          candidate_sets_equal=bool(same_set), columns_equal=same_columns,
          peak_host_rss_gib=peak_rss_gib())
    check(launches == stage_launches,
          f"C. elegans candidates launched {launches}, expected {stage_launches}")
    check(same_set, "C. elegans candidates differ between the device and host engines")
    device_route = "packed" if n_ids < ARGSORT_IDS else "argsort"
    check(routes == dict(device=device_route, host="argsort") and same_columns,
          f"C. elegans collapses differ across engines and routes {routes}")
    return launches


def candidate_keys(cands, n_nodes: int) -> np.ndarray:
    """The candidates' (u, v, d) triples as sorted int64 keys, one per
    triple (``d`` below 128, ``n_nodes`` below 2^28)."""
    check(int(cands.d.max(initial=0)) < 128 and n_nodes < 1 << 28,
          f"candidate keys do not fit: {n_nodes} nodes")
    keys = (cands.u * n_nodes + cands.v) << 7
    keys |= cands.d
    keys.sort()
    return keys


def matching_instance(log) -> dict:
    """The optimal front's instance sizes and laps, from the INFO records
    of ``matchtigs_tpu_torch.algos.matchtigs`` taken over one run."""
    (n_ids,), (n_edges,), (matched,), (candidates,) = (log.args(msg)[0] for msg in (
        "Matching instance has %d expanded nodes", "Collapsed to %d matching edges",
        "Matched %d id pairs", "Found %d candidate shortest paths"))
    return dict(candidates=candidates, matching_ids=n_ids, matching_edges=n_edges,
                matched_pairs=matched, laps_s={a[0]: a[1] for a in log.args("%s: %.2fs")})


def run_cli(path, kk, *options, out_flag="--greedytigs-fa-out", in_flag="--fa-in"):
    """(rc, launches, seconds, out store, laps) of one CLI run on the input
    ``path`` given by ``in_flag`` (``-k kk`` unless ``kk`` is None) that
    writes the fasta of ``out_flag`` to out.fa beside ``path`` (no store
    when ``out_flag`` is None: ``options`` name the outputs).  ``laps`` are
    the CLI's own INFO laps, taken by a handler attached for the run:
    ``load_s`` (read and graph build), ``compute_s`` and ``write_s`` summed
    over the algorithms run (each one's under ``per_algorithm_s`` where
    there are several), and for GFA input how its names were resolved."""
    from matchtigs_tpu_torch.cli import main as cli_main
    from matchtigs_tpu_torch.io.readers import read_fasta
    from matchtigs_tpu_torch.ops import sssp

    fa_out = Path(path).with_name("out.fa")
    argv = [in_flag, str(path), *(["-k", str(kk)] if kk is not None else []),
            *([out_flag, str(fa_out)] if out_flag else []), "--log-level", "Warning",
            *options]
    sssp.reset_kernel_launches()
    t = time.monotonic()
    with LogCapture("matchtigs_tpu_torch", "matchtigs_tpu_torch.io.readers") as log:
        rc = cli_main(argv)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t
    launches = dict(sssp.KERNEL_LAUNCHES)
    laps = {}
    if rc == 0:
        (laps["load_s"],), = log.args("Loading took %.1f seconds")
        per = {a: dict(compute_s=c, write_s=w) for a, c, w in
               log.args("Computing %s took %.1fs and writing took %.1fs")}
        laps.update(compute_s=sum(x["compute_s"] for x in per.values()),
                    write_s=sum(x["write_s"] for x in per.values()))
        if len(per) > 1:
            laps["per_algorithm_s"] = per
        names = log.args("GFA names of %d segments and %d links resolved %s")
        if names:
            laps["gfa_names"] = names[0][2]
    out = read_fasta(fa_out)[0] if rc == 0 and out_flag else None
    return rc, launches, seconds, out, laps


def run_mesh_workers(genome_length: int, data_dir: Path) -> list[dict]:
    """Start this script's ``--mesh-worker`` twice (one gloo group, both on
    the card) and return each rank's results.  Both share one deadline,
    WORKER_TIMEOUT_S from the start; a worker that fails or outlasts it
    fails the run, and both are stopped.  Their output goes to files, so a
    worker never blocks on a full pipe."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"rank{r}.npz" for r in range(2)]
        logs = [Path(tmp) / f"rank{r}.log" for r in range(2)]
        procs = []
        try:
            for r in range(2):
                with open(logs[r], "wb") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
                         str(r), "2", str(port), str(outs[r]), "--genome-length",
                         str(genome_length), "--data-dir", str(data_dir)],
                        stdout=log, stderr=subprocess.STDOUT,
                    ))
            deadline = time.monotonic() + WORKER_TIMEOUT_S
            # wait for both, or stop at the first failure
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            tail = logs[r].read_text(errors="replace")[-4000:]
            check(p.returncode == 0, f"mesh worker {r} failed ({p.returncode}):\n{tail}")
        return [dict(np.load(o)) for o in outs]


def mesh_worker(rank: str, world: str, port: str, out: str, genome_length: int,
                data_dir: str) -> int:
    """One process of ``mesh_two_process``: join the group, load the
    flagship cached in ``data_dir``, run greedy matchtigs over the mesh of every visible card (one
    shard per process here), and save the walks and the kernel launches;
    rank 0 also saves the host engine's walks."""
    from matchtigs_tpu_torch import testing
    from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig, compute_greedytigs
    from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs
    from matchtigs_tpu_torch.ops import sssp
    from matchtigs_tpu_torch.parallel.mesh import initialize_distributed

    if not torch.cuda.is_available():
        raise SystemExit("mesh worker: no CUDA device")
    initialize_distributed(f"localhost:{port}", int(world), int(rank),
                           timeout_s=COLLECTIVE_TIMEOUT_S)
    store, _, k = testing.make_pangenome_store(
        genome_length=genome_length, k=K, n_strains=N_STRAINS,
        mutation_rate=MUTATION_RATE, seed=SEED, cache_dir=data_dir,
        with_repeats=True,
    )
    g = build_bigraph_from_unitigs(store, k)
    empty = np.empty(0, dtype=np.int64)
    host = compute_greedytigs(g.copy(), GreedytigConfig(k=k, engine="host")) if rank == "0" else None
    sssp.reset_kernel_launches()
    t = time.monotonic()
    tigs = compute_greedytigs(g, GreedytigConfig(k=k, use_mesh=True))
    torch.cuda.synchronize()
    seconds = time.monotonic() - t
    np.savez(out, flat=tigs.flat, offsets=tigs.offsets, seconds=seconds,
             launches=json.dumps(sssp.KERNEL_LAUNCHES),
             host_flat=empty if host is None else host.flat,
             host_offsets=empty if host is None else host.offsets)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
