"""One run of one cell: set-up, the measured window, the check.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration, whose
file gives the generator's parameters and the limits of the guarantee it
states, and a traffic mix (``mixes/<name>.json``), which gives the CLI's
algorithm and flags.  The cell's own limits on the output's cost, set
from readings at its size, are ``limits/<cell>.json``.  A per-layer
metric is ``metrics/<name>.json``, read by the module of its ``kind``
(``metrics/<kind>.py``).  Everything is found by name, so a new
configuration, mix, cell or metric of an existing kind is new files and
a new entry, and no edit.

The window runs the program's CLI entry, in process, on whole calls back
to back: another call starts only while less than ``seconds`` have passed
since the first one started.
"""

from __future__ import annotations

import gc
import importlib
import json
import resource
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import torch

from . import generator, reference
from .trace import Span, Trace, busy_intervals, device_events

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "matchtigs_tpu")
GIB = 1 << 30
# the configuration's keys that the generator takes
GENERATOR_KEYS = ("genome_length", "k", "n_strains", "mutation_rate", "with_repeats")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list  # (name, metric entry, spec)
    limits: dict  # each number compared, with its limit


def load_cell(workload: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its
    configuration, mix and metric specs."""
    bm = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bm["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    entry = next(c for c in bm["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((bench / "mixes" / f"{w['traffic']}.json").read_text())
    # the guarantee's limits, and the cell's own, set from readings at its size
    cell_limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    limits = {**config["limits"], **cell_limits["limits"]}

    e2e = [m for m in bm["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = []
    for m in bm["per_layer"]:
        # without a list of cells, a metric is read wherever what it moves is
        if workload in m.get("workloads", [workload] if m["moves"] in reported else []):
            spec = json.loads((bench / "metrics" / f"{m['name']}.json").read_text())
            per_layer.append((m["name"], m, spec))
    return Cell(workload, int(w["chips"]), config, mix, e2e, per_layer, limits)


def reader(kind: str):
    return importlib.import_module(f"{__package__}.metrics.{kind}")


# ------------------------------------------------------------ host memory


def max_rss() -> int:
    """The process's resident high-water mark (``ru_maxrss``), in bytes:
    every transient counts.  The card's machine refuses to reset it
    (``/proc/self/clear_refs``), so the mark at the window's close is the
    window's peak wherever the window raised it, and set-up's otherwise."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


# ------------------------------------------------------------------ runs


def cli_argv(mix: dict, fa_in: Path, k: int, out: Path, device: str) -> list:
    return ["--fa-in", str(fa_in), "-k", str(k), mix["out_flag"], str(out),
            "--device", device, *mix.get("cli_flags", [])]


def make_input(cell: Cell, seed: int, device: str, tmp: Path,
               genome_length: int | None = None) -> dict:
    """Generate the cell's pangenome (the configuration's ``genome_seed``)
    on ``device``, put its unitigs in the order and orientations that
    ``seed`` draws, and write them and the warm-up's first unitigs as fasta
    under ``tmp``; nothing of it stays in memory.  Every seed gives the
    same k-mer set and the same sizes, so seeds do not change the work."""
    g = {key: cell.config[key] for key in GENERATOR_KEYS}
    if genome_length is not None:
        g["genome_length"] = genome_length
    codes, offsets, kmers = generator.make_pangenome(
        seed=cell.config["genome_seed"], device=device, **g)
    n_kmers = len(kmers)
    del kmers  # on the device: only its count is kept
    codes, offsets = generator.shuffle_unitigs(codes, offsets, seed % (1 << 63), device)
    fa_in = tmp / "unitigs.fa"
    generator.write_fasta(fa_in, codes, offsets)
    n_warm = min(int(cell.mix["warmup_unitigs"]), len(offsets) - 1)
    warm_in = tmp / "warmup.fa"
    generator.write_fasta(warm_in, codes[: offsets[n_warm]], offsets[: n_warm + 1])
    info = dict(fa_in=fa_in, warm_in=warm_in, k=g["k"], unitigs=len(offsets) - 1,
                kmers=n_kmers)
    del codes, offsets
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return info


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def run_calls(cell: Cell, data: dict, tmp: Path, device: str, seconds: float,
              trace: Trace | None = None) -> dict:
    """The measured window: whole CLI calls back to back."""
    from matchtigs_tpu_torch import cli

    calls, failed, outputs = [], 0, []
    first = None
    while first is None or time.monotonic() - first < seconds:
        out = tmp / f"out.{len(calls)}.fa"
        argv = cli_argv(cell.mix, data["fa_in"], data["k"], out, device)
        t0 = time.monotonic()
        first = t0 if first is None else first
        if trace is not None:
            trace.call_index = len(calls)
        try:
            rc = cli.main(argv)
        except Exception:  # a failed call counts; the window goes on
            traceback.print_exc()
            rc = -1
        _sync(device)
        t1 = time.monotonic()
        calls.append(dict(start=t0, end=t1, rc=rc))
        if rc == 0:
            outputs.append(out)
            if trace is not None:
                trace.calls.append((t0, t1))
        else:
            failed += 1
    return dict(calls=calls, failed=failed, outputs=outputs)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             genome_length: int | None = None, t_start: float | None = None) -> dict:
    """One run: set-up (timed from ``t_start``), the window, the check.
    Returns the result line's object."""
    from matchtigs_tpu_torch import cli

    t_start = time.monotonic() if t_start is None else t_start
    if device != "cpu":
        torch.cuda.init()
    tmp = Path(tempfile.mkdtemp(prefix="port_bench."))
    try:
        data = make_input(cell, seed, device, tmp, genome_length)
        # warm-up: loads the kernels (building them in a fresh checkout),
        # the native library and the card's context
        warm = cli.main(cli_argv(cell.mix, data["warm_in"], data["k"], tmp / "warmup.out.fa",
                                 device))
        if warm != 0:
            raise RuntimeError(f"the warm-up call returned {warm}")
        _sync(device)
        setup_s = time.monotonic() - t_start

        trace = Trace(unitigs=data["unitigs"]) if traced else None
        if traced:
            for name, _, spec in cell.per_layer:
                reader(spec["kind"]).install(name, spec, trace)
            for label, (module, attr) in cell.mix.get("label_spans", {}).items():
                trace.span(module, attr, label)
        gc.collect()
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        setup_peak_host = max_rss()
        prof = _profiler(device) if traced else None
        if prof is not None:
            prof.start()
        window0 = time.monotonic()
        try:
            window = run_calls(cell, data, tmp, device, seconds, trace)
        finally:
            _sync(device)
            window1 = time.monotonic()
            if prof is not None:
                prof.stop()
            if trace is not None:
                trace.restore()
        peak_host = max_rss()
        if peak_host <= setup_peak_host:
            print("port_bench: the window did not raise the host peak; "
                  "peak_host_gib is set-up's", file=sys.stderr)
        peak_device = torch.cuda.max_memory_allocated() if device != "cpu" else 0

        done = [c for c in window["calls"] if c["rc"] == 0]
        e2e = dict(peak_host_gib=peak_host / GIB, setup_s=setup_s)
        result = dict(correct=False, attempted=len(window["calls"]), failed=window["failed"])
        if traced:
            trace.window = (window0, window1)
            if prof is not None:
                trace.device_events = device_events(prof, window0)
            metrics = {}
            for name, entry, spec in cell.per_layer:
                value = reader(spec["kind"]).read(name, spec, trace)
                if value is None:
                    print(f"port_bench: no reading of {name}", file=sys.stderr)
                else:
                    metrics[name] = dict(value=value, unit=entry["unit"])
            result["metrics"] = metrics
        else:
            result["metrics"] = {m["name"]: dict(value=e2e[m["name"]], unit=m["unit"])
                                 for m in cell.end_to_end}
        result["device"] = _device(device, cell.chips, peak_device)
        if traced:
            busy = busy_intervals(trace.device_events, window0, window1)
            result["device"].update(busy_s=sum(t - s for s, t in busy),
                                    window_s=window1 - window0)
            result["breakdown"] = breakdown(trace, busy)
        result["calls_s"] = [c["end"] - c["start"] for c in window["calls"]]
        result["setup_peak_host_gib"] = setup_peak_host / GIB
        del trace, prof
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()

        checks = check(cell, data, window["outputs"], device)
        worst = checks.pop("worst")
        result.update(checks)
        result["correct"] = bool(
            done and window["failed"] == 0
            and all(v["value"] <= v["limit"] for v in worst.values()))
        result["checks"] = worst  # last: each number compared beside its limit
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check(cell: Cell, data: dict, outputs: list, device: str) -> dict:
    """Every output of the window against the reference: the worst of
    each number compared, beside its limit."""
    dev = "cpu" if device == "cpu" else torch.device("cuda", torch.cuda.current_device())
    want = reference.input_kmers(data["fa_in"], data["k"], dev)
    lim = cell.limits
    worst = {name: dict(value=0, limit=limit) for name, limit in lim.items()}
    worst["input_malformed_records"] = dict(value=want["malformed"], limit=0)
    seen = []
    for out in outputs:
        got = reference.check_output(want, out, data["k"], dev)
        seen.append(dict(tigs=got["tigs"], characters=got["characters"]))
        for name in lim:
            worst[name]["value"] = max(worst[name]["value"], got[name])
    del want
    return dict(worst=worst, outputs=seen, unitigs=data["unitigs"], kmers=data["kmers"])


def _profiler(device: str):
    if device == "cpu":
        return None
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def _device(device: str, chips: int, peak: int) -> dict:
    if device == "cpu":
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=peak)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
                memory_peak_bytes=int(peak))


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return (name.split("(")[0].strip() or name)[:80]


def breakdown(trace: Trace, busy: list) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle stretches, an idle gap being cut where the host enters or leaves
    a span and each piece named by the innermost span it lies in."""
    by_op: dict = {}
    for e in trace.device_events:
        by_op[_short(e.name)] = by_op.get(_short(e.name), 0.0) + e.seconds
    ops = sorted(by_op.items(), key=lambda x: -x[1])[:10]
    lo, hi = trace.window
    edges = [lo] + [x for s, t in busy for x in (s, t)] + [hi]
    spans = trace.spans + [Span("cli call", s, t, i) for i, (s, t) in enumerate(trace.calls)]
    cuts = sorted({x for s in spans for x in (s.start, s.end)})
    pieces = []
    for a, b in zip(edges[::2], edges[1::2]):
        inner = [a] + [c for c in cuts if a < c < b] + [b]
        pieces += [(x, y) for x, y in zip(inner, inner[1:]) if y > x]

    def label(a: float, b: float) -> str:
        mid = (a + b) / 2
        inner = [s for s in spans if s.start <= mid <= s.end]
        if not inner:
            return "harness, between calls"
        s = min(inner, key=lambda s: s.end - s.start)
        return f"{s.name} (call {s.call})"

    idle = sorted(((label(a, b), b - a) for a, b in pieces), key=lambda x: -x[1])[:10]
    return dict(device_ops=[list(x) for x in ops], idle_gaps=[list(x) for x in idle])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def print_result(result: dict) -> None:
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)

