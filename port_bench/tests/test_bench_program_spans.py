"""The ``program_span`` metrics on a tiny traced run on the CPU (the CLI's
``--device cpu`` path, as ``test_bench_harness.py`` drives it): each reads
a value, the program's leaf spans cover its calls, and they, not the
harness's wrappers, name the idle gaps."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import harness
from port_bench.metrics import program_span
from port_bench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
CELL = "pangenome60m_k31.greedy_fasta"
# large enough that the calls' fixed costs (log lines between spans) stay
# under a few per cent of them
SIZE = 100_000
# the program_span metrics of the greedy cells (the optimal cell's are
# test_bench_optimal.py's)
NEW = sorted(m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
             if CELL in m.get("workloads", [])
             and json.loads((ROOT / "port_bench" / "metrics" / f"{m['name']}.json")
                            .read_text())["kind"] == "program_span")
WRAPPERS = ("compute", "load_s", "write_s", "cli call")


@pytest.fixture(scope="module")
def traced():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(harness.load_cell(CELL), 2**31 + 5, 0.0, True, device="cpu",
                                genome_length=SIZE)
    finally:
        torch.set_num_threads(n)


def test_the_cells_read_the_new_metrics():
    assert len(NEW) == 10
    for cell in ("pangenome60m_k31.greedy_fasta", "pangenome100m_k31.greedy_fasta"):
        assert set(NEW) <= {n for n, _, _ in harness.load_cell(cell).per_layer}


@pytest.mark.parametrize("name", NEW)
def test_every_new_metric_reads_a_value(traced, name):
    assert traced["correct"]
    value = traced["metrics"][name]["value"]
    assert value >= 0 and (value > 0 or name == "untraced_share")


def test_the_leaf_spans_cover_the_calls(traced):
    assert traced["metrics"]["untraced_share"]["value"] <= 5.0


def test_the_inner_spans_add_up_to_the_wrappers(traced):
    """The program's spans lie inside the functions the harness wraps."""
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    assert m["parse_s"] + m["graph_build_s"] == pytest.approx(m["load_s"], rel=0.05)
    assert m["spell_s"] + m["records_s"] == pytest.approx(m["write_s"], rel=0.05)


def test_idle_gaps_are_named_by_leaf_spans(traced):
    gaps = traced["breakdown"]["idle_gaps"]
    assert gaps
    for label, seconds in gaps[:5]:
        assert not label.startswith(WRAPPERS), (label, seconds)


def test_a_traced_run_with_the_tracer_loads_neither_jax_nor_the_jax_package():
    """A whole traced run in a fresh process, as ``test_bench_harness.py``
    makes one, now with the program's spans: every per-layer metric the
    cell lists reads, and no module of ``jax`` or ``matchtigs_tpu`` is
    loaded."""
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from port_bench import harness\n"
        "r = harness.run_cell(harness.load_cell(%r), 3, 0.0, True, device='cpu', "
        "genome_length=20000)\n"
        "print(json.dumps(dict(correct=r['correct'], metrics=sorted(r['metrics']), "
        "forbidden=harness.forbidden_modules(), "
        "port='matchtigs_tpu_torch' in sys.modules)))\n" % (str(ROOT), CELL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == dict(correct=True, forbidden=[], port=True,
                       metrics=sorted(["cli_unitigs_per_s", "device_stage_s", "join_s",
                                       "load_s", "write_s", *NEW]))


def test_the_run_turns_the_tracer_off_again(traced):
    from matchtigs_tpu_torch.utils import tracing

    assert tracing.sink is tracing.discard


def test_a_program_without_the_tracer_gives_no_reading(monkeypatch):
    monkeypatch.setattr(program_span, "TRACER", "matchtigs_tpu_torch.utils.no_tracer")
    trace = Trace(unitigs=1)
    for name in NEW:
        program_span.install(name, {}, trace)
    trace.calls.append((0.0, 1.0))
    for spec in ({"spans": ["load.read"]}, {"untraced": True},
                 {"share": {"of": [["a", "b"]], "over": [["a", "c"]]}}):
        assert program_span.read("x", spec, trace) is None
    trace.restore()


def _record(name, start, end, id_, parent):
    return program_span.Record(name, start, end, id_, parent, 1, {}, 0)


def test_untraced_share_counts_what_no_leaf_covers():
    records = [_record("cli", 0.0, 10.0, 1, 0), _record("a", 1.0, 4.0, 2, 1),
               _record("b", 3.0, 6.0, 3, 1), _record("c", 8.0, 12.0, 4, 1)]
    # leaves a, b, c cover 1-6 and 8-10 of the call 0-10
    assert program_span.untraced_share(records, [(0.0, 10.0)]) == pytest.approx(30.0)
    assert program_span.untraced_share(records, []) is None
