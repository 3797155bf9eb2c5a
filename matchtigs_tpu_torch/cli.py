# Ported from matchtigs_tpu/cli.py: the greedytigs flags and the shared input flags.
"""Command line interface.

Mirrors the reference CLI's flag surface (upstream src/bin.rs:56-218) for
greedy matchtigs, with the same orchestration: load -> compute (on a
fresh graph copy) -> write, with timing and memory logging
(upstream src/bin.rs:850-1218).  The pathtigs, eulertigs and matchtigs
outputs are not ported yet and are refused.

Run as ``python -m matchtigs_tpu_torch.cli``.
"""

from __future__ import annotations

import argparse
import logging
import resource
import sys
import time

from .algos.greedytigs import GreedytigConfig, compute_greedytigs
from .graph.build import build_bigraph_from_links, build_bigraph_from_unitigs
from .io.readers import load_unitigs
from .io.writers import (
    write_duplication_bitvector,
    write_walks_fasta,
    write_walks_gfa,
)

logger = logging.getLogger("matchtigs_tpu_torch")

# Output flags of the algorithms that are not ported yet (ROADMAP.md).
_NOT_PORTED = [
    f"--{algo}-{out}"
    for algo in ("pathtigs", "eulertigs", "matchtigs")
    for out in ("gfa-out", "fa-out")
] + [
    "--matchtigs-duplication-bitvector-out",
    "--matching-dense-limit",
    "--matching-file-prefix",
]


def _positive_int(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return value


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="matchtigs-tpu-torch",
        description="Greedy matchtigs (PyTorch + CUDA): small plain text "
        "representation of kmer sets.",
    )
    p.add_argument("--gfa-in", help="GFA file containing the input unitigs (.gz ok)")
    p.add_argument("--fa-in", help="Fasta file containing the input unitigs (.gz ok)")
    p.add_argument(
        "--bcalm-in", help="BCALM2 fasta file containing the input unitigs (.gz ok)"
    )
    p.add_argument("--greedytigs-gfa-out", help="Compute greedytigs, write GFA (.gz ok)")
    p.add_argument("--greedytigs-fa-out", help="Compute greedytigs, write fasta (.gz ok)")
    p.add_argument(
        "--greedytigs-duplication-bitvector-out",
        help="ASCII bitvector: 0 per duplicated kmer in the greedytigs",
    )
    for flag in _NOT_PORTED:
        p.add_argument(flag, help=argparse.SUPPRESS)
    p.add_argument("-k", type=int, help="kmer size (required for fasta/bcalm input)")
    p.add_argument(
        "-t",
        "--threads",
        type=int,
        default=None,
        help="host threads for the native Dijkstra (default: all cores)",
    )
    # The SSSP knobs default to None and are filled from GreedytigConfig
    # at dispatch time, so the CLI never shadows the dataclass defaults.
    p.add_argument(
        "--sssp-initial-capacity",
        type=_positive_int,
        default=None,
        help="per-source working-set capacity of the first device search "
        f"stage, any C >= 1 (default: {GreedytigConfig.initial_capacity})",
    )
    p.add_argument(
        "--sssp-batch-size",
        type=int,
        default=None,
        help="accepted for compatibility with matchtigs_tpu.cli; the port's "
        "search has no batch size (ignored)",
    )
    p.add_argument(
        "--sssp-overflow-mode",
        choices=("host", "ladder"),
        default="host",
        help="finish capacity-overflow sources on the host (native Dijkstra) "
        "or retry on device with 4x capacity per stage",
    )
    p.add_argument(
        "--host-route-threshold",
        type=int,
        default=1,
        help="route sources whose min incident edge weight is <= this to the "
        "host Dijkstra, run while the device searches (-1 disables the split)",
    )
    p.add_argument(
        "--use-mesh",
        choices=("auto", "true", "false"),
        default="auto",
        help="shard the search and the acceptance sort over a mesh of "
        "devices (parallel/mesh.py): auto when --device gives more than "
        "one (every visible card under cuda), true even with one",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="device of the search stage: cuda (the card; every visible "
        "card under --use-mesh), cuda:N, or cpu (the kernels' plain "
        "versions; for tests)",
    )
    p.add_argument(
        "--debug-print-graph",
        action="store_true",
        help="print the de Bruijn graph constructed from the input unitigs",
    )
    p.add_argument("--debug-print-walks", action="store_true")
    p.add_argument(
        "--debug-spell-prefix",
        help="write per-edge spell annotations to <prefix>.<algo>.spell "
        "alongside each fasta/GFA output (the reference writers' debug "
        "channel, src/bin.rs:608-818)",
    )
    p.add_argument("--log-level", default="Info")
    # Reference-CLI compatibility: accepted, mapped or ignored with a note.
    p.add_argument("--blossom5-command", help=argparse.SUPPRESS)
    p.add_argument(
        "--dijkstra-node-weight-array-type",
        choices=("EpochNodeWeightArray", "HashbrownHashMap"),
        help="host Dijkstra distance-structure strategy "
        "(reference flag, src/implementation/mod.rs:62-83): "
        "EpochNodeWeightArray selects the dense epoch-array Dial engine "
        "(framework default), HashbrownHashMap the binary-heap + hashmap "
        "engine (the reference's default semantics)",
    )
    p.add_argument(
        "--dijkstra-heap-type",
        choices=("StdBinaryHeap",),
        help="heap strategy (reference flag; StdBinaryHeap is the only "
        "value the reference defines, src/implementation/mod.rs:86-103)",
    )
    p.add_argument("--dijkstra-performance-data-type", help=argparse.SUPPRESS)
    p.add_argument(
        "--dijkstra-staged-parallelism-divisor", type=float, help=argparse.SUPPRESS
    )
    p.add_argument(
        "--dijkstra-resource-limit-factor", type=int, help=argparse.SUPPRESS
    )
    p.add_argument(
        "--compression-level",
        type=int,
        default=6,
        choices=range(10),
        help="gzip level for .gz outputs",
    )
    return p


def _sssp_overrides(opts) -> dict:
    """SSSP knobs the user set explicitly; unset flags fall through to
    the dataclass defaults instead of shadowing them."""
    out = {}
    if opts.sssp_initial_capacity is not None:
        out["initial_capacity"] = opts.sssp_initial_capacity
    return out


def _want_counters(opts) -> bool:
    """--dijkstra-performance-data-type <anything but none> enables the
    per-source search counters (the reference's opt-in performance data,
    upstream src/bin.rs:160-165, greedytigs/mod.rs:646-673)."""
    v = opts.dijkstra_performance_data_type
    return bool(v) and v.lower() not in ("none", "off")


def _host_strategy(opts) -> str:
    """Map the reference's Dijkstra strategy flags to a host engine
    (reference dispatch: upstream src/implementation/mod.rs:62-126,
    greedytigs/mod.rs:92-198).  Unset -> the framework's own default."""
    v = opts.dijkstra_node_weight_array_type
    if v is None:
        return "dial"
    strategy = "heap" if v == "HashbrownHashMap" else "dial"
    logger.info(
        "Dijkstra strategy: %s + %s -> host engine %r",
        opts.dijkstra_heap_type or "StdBinaryHeap",
        v,
        strategy,
    )
    return strategy


def _log_mem(label: str) -> None:
    """Per-phase memory snapshot at info level — the analog of the
    reference's log_memory_usage after every phase
    (upstream src/bin.rs:842-848, called at 872, 921, 998)."""
    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    current_kb = None
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    current_kb = int(line.split()[1])
                    break
    except OSError:
        pass
    if current_kb is not None:
        logger.info(
            "%s memory usage: %.1f MiB physical (peak %.1f MiB)",
            label,
            current_kb / 1024,
            peak_kb / 1024,
        )
    else:
        logger.info("%s peak memory usage: %.1f MiB", label, peak_kb / 1024)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    opts = parser.parse_args(argv)
    for flag in _NOT_PORTED:
        if getattr(opts, flag[2:].replace("-", "_")) is not None:
            parser.error(
                f"{flag} is not yet ported to matchtigs_tpu_torch "
                "(see ROADMAP.md); use matchtigs_tpu.cli"
            )
    logging.basicConfig(
        level=getattr(logging, opts.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s",
    )
    logger.info("matchtigs-tpu-torch starting")
    from .utils.malloc_tuning import tune_malloc

    tune_malloc()

    load_start = time.monotonic()
    store, k, gfa_header, links = load_unitigs(
        gfa_in=opts.gfa_in, fa_in=opts.fa_in, bcalm_in=opts.bcalm_in, k=opts.k
    )
    if links:
        logger.info("Building graph from %d explicit topology links", len(links))
        graph = build_bigraph_from_links(store, links, k)
    else:
        graph = build_bigraph_from_unitigs(store, k)
    logger.info("Loading took %.1f seconds", time.monotonic() - load_start)
    logger.info("k = %d", k)
    logger.info(
        "Graph has %d nodes and %d edges", graph.n_nodes, graph.n_edges
    )
    _log_mem("After load")

    # Pre-fault the working-set arena in one bulk syscall: the candidate
    # columns and sort keys of the greedy search scale with the candidate
    # count (~3.3 per edge at k=31, 24 B + 8 B key each, x2 for scratch),
    # and lazy first-touch faults are slow on oversubscribed virtualized
    # hosts.  The target is capped by available memory so the prewarm never
    # thrashes a host the real working set would have fit on.
    wants_search = any(
        getattr(opts, f"greedytigs_{out}") is not None
        for out in ("fa_out", "gfa_out", "duplication_bitvector_out")
    )
    if wants_search:
        from .utils.malloc_tuning import available_memory_bytes, prewarm_heap

        prewarm = min(224 * graph.n_edges, 12 << 30)
        avail = available_memory_bytes()
        if avail is not None:
            prewarm = min(prewarm, avail // 2)
        if prewarm > (64 << 20) and prewarm_heap(prewarm):
            logger.info("Prewarmed %.1f GiB of heap arena", prewarm / 2**30)

    if opts.sssp_batch_size is not None:
        logger.info(
            "--sssp-batch-size %d is accepted for compatibility and ignored: "
            "the port's device search has no batch size",
            opts.sssp_batch_size,
        )
    if opts.blossom5_command:
        logger.info(
            "--blossom5-command is accepted for compatibility; greedy "
            "matchtigs run no matching solver"
        )
    if opts.dijkstra_staged_parallelism_divisor or opts.dijkstra_resource_limit_factor:
        logger.info(
            "Staged-parallelism flags map to the device working-set "
            "capacity (--sssp-initial-capacity); searches that exceed it "
            "finish on the host Dijkstra or climb the capacity ladder "
            "(--sssp-overflow-mode)"
        )

    if opts.debug_print_graph:
        logger.info("Printing graph to stdout, because --debug-print-graph was set")
        for e in range(graph.n_edges):
            print(
                f"{e} ({int(graph.srcs()[e])} -> {int(graph.dsts()[e])}) "
                f"{store.get_ascii(int(graph.handles()[e]), bool(graph.forwards()[e])).decode()}"
            )

    fa_out = opts.greedytigs_fa_out
    gfa_out = opts.greedytigs_gfa_out
    bv_out = opts.greedytigs_duplication_bitvector_out
    if not (fa_out or gfa_out or bv_out):
        logger.warning("No outputs requested; nothing to do")
        return 0

    logger.info("Computing greedytigs")
    g = graph.copy()
    t0 = time.monotonic()
    tigs = compute_greedytigs(
        g,
        GreedytigConfig(
            k=k,
            **_sssp_overrides(opts),
            host_threads=opts.threads,
            overflow_mode=opts.sssp_overflow_mode,
            host_route_threshold=opts.host_route_threshold,
            use_mesh={"auto": "auto", "true": True, "false": False}[
                opts.use_mesh
            ],
            device=opts.device,
            performance_counters=_want_counters(opts),
            host_strategy=_host_strategy(opts),
        ),
    )
    compute_time = time.monotonic() - t0

    t0 = time.monotonic()
    debug_path = (
        f"{opts.debug_spell_prefix}.greedytigs.spell"
        if opts.debug_spell_prefix
        else None
    )
    if fa_out:
        logger.info("Writing greedytigs as fasta to %s", fa_out)
        write_walks_fasta(
            g, tigs, store, k, fa_out, opts.compression_level,
            debug_path=debug_path,
        )
        debug_path = None  # one debug file per algorithm
    if gfa_out:
        logger.info("Writing greedytigs as gfa to %s", gfa_out)
        write_walks_gfa(
            g, tigs, store, k, gfa_header, gfa_out, opts.compression_level,
            debug_path=debug_path,
        )
    if bv_out:
        logger.info("Writing greedytigs duplication bitvector to %s", bv_out)
        write_duplication_bitvector(g, tigs, bv_out, opts.compression_level)
    if opts.debug_print_walks:
        for walk in tigs:
            print(", ".join(str(int(e)) for e in walk))
    write_time = time.monotonic() - t0
    _log_mem("After greedytigs")

    logger.info(
        "Computing greedytigs took %.1fs and writing took %.1fs",
        compute_time, write_time,
    )
    _log_mem("Final")
    logger.info("Done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
