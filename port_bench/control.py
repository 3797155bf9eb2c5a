"""Readings that the check's limits are set from, on the card.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the cell's input made from the seed, one
CLI call of the timed path at the cell's own size, and the check of its
output (the sound reading); then the check of the same output with the
control planted (one base altered) and with half of its tigs left out;
the check of the input's unitigs as the output (a state returned
unchanged); one CLI call each with a fault of the search stage planted in
the program (no candidates found; half of the sources searched); and one
CLI call of the program's eulertigs on the same input, which joins
nothing across the graph's Euler breaks.  Prints one JSON line per seed
and, last, each number's lower reading (the largest of the sound runs)
and upper readings (the smallest of each fault).  The benchmark's own
runs do not run this.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


# the faults planted in the output file (reference.FAULTS), in the program
# (PROGRAM_FAULTS), and the other readings
OUTPUT_FAULTS = ("alter_base", "drop_half")
PROGRAM_FAULTS = ("no_candidates", "half_sources")
UPPER = (*OUTPUT_FAULTS, "unchanged", *PROGRAM_FAULTS, "eulertigs")


@contextmanager
def planted(fault: str):
    """The program with a fault of its search stage, while the block runs:
    ``no_candidates`` finds no shortest path between the unbalanced nodes,
    ``half_sources`` searches from every other source only.  The rest of
    the call (accept, balance, Euler, write) runs as it is."""
    from matchtigs_tpu_torch.algos import greedytigs
    from matchtigs_tpu_torch.ops.candidates import Candidates

    real = greedytigs.collect_candidates

    def no_candidates(g, out_nodes, *args, return_chunks=False, **kwargs):
        return [] if return_chunks else Candidates.empty()

    def half_sources(g, out_nodes, *args, **kwargs):
        return real(g, np.asarray(out_nodes)[::2], *args, **kwargs)

    greedytigs.collect_candidates = dict(no_candidates=no_candidates,
                                         half_sources=half_sources)[fault]
    try:
        yield
    finally:
        greedytigs.collect_candidates = real


def _one_call(cell, data, tmp, device, mix=None) -> tuple:
    from port_bench import harness

    cell = cell if mix is None else harness.Cell(**{**vars(cell), "mix": mix})
    window = harness.run_calls(cell, data, tmp, device, 0.0)
    if window["failed"]:
        raise RuntimeError("the CLI call failed")
    return window["outputs"][0], window["calls"][0]["end"] - window["calls"][0]["start"]


def readings(cell, seeds, device: str, genome_length=None) -> list:
    import torch

    from matchtigs_tpu_torch import cli
    from port_bench import harness, reference

    dev = "cpu" if device == "cpu" else torch.device("cuda", torch.cuda.current_device())
    lines, warm = [], False
    for seed in seeds:
        tmp = Path(tempfile.mkdtemp(prefix="port_bench.control."))
        try:
            data = harness.make_input(cell, seed, device, tmp, genome_length)
            if not warm:
                cli.main(harness.cli_argv(cell.mix, data["warm_in"], data["k"],
                                          tmp / "warmup.out.fa", device))
                warm = True
            out, call_s = _one_call(cell, data, tmp, device)
            want = reference.input_kmers(data["fa_in"], data["k"], dev)
            line = dict(seed=seed, call_s=call_s)
            line["sound"] = reference.check_output(want, out, data["k"], dev)
            for fault in OUTPUT_FAULTS:
                bad = tmp / f"{fault}.fa"
                reference.damage(out, bad, fault, seed)
                line[fault] = reference.check_output(want, bad, data["k"], dev)
                bad.unlink()
            out.unlink()
            line["unchanged"] = reference.check_output(want, data["fa_in"], data["k"], dev)
            for fault in PROGRAM_FAULTS:
                with planted(fault):
                    out, line[f"{fault}_call_s"] = _one_call(cell, data, tmp, device)
                line[fault] = reference.check_output(want, out, data["k"], dev)
                out.unlink()
            euler = {**cell.mix, "out_flag": "--eulertigs-fa-out"}
            out, line["eulertigs_call_s"] = _one_call(cell, data, tmp, device, euler)
            line["eulertigs"] = reference.check_output(want, out, data["k"], dev)
            out.unlink()
            del want
            print(json.dumps(line), flush=True)
            lines.append(line)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return lines


def summary(cell, lines: list) -> dict:
    out = {}
    for name, limit in cell.limits.items():
        lower = max(x["sound"][name] for x in lines)
        upper = {f: min(x[f][name] for x in lines) for f in UPPER}
        out[name] = dict(lower=lower, upper=upper, limit=limit)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    from port_bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device", file=sys.stderr)
        return 2
    t = time.monotonic()
    lines = readings(cell, args.seeds, "cuda")
    print(json.dumps(dict(workload=args.workload, seconds=time.monotonic() - t,
                          device=torch.cuda.get_device_name(0),
                          readings=summary(cell, lines))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
