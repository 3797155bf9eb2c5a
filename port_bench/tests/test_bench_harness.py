"""The harness driven on the CPU at a tiny size (the CLI's ``--device
cpu`` path, fed by the frozen generator): what it loads, that it is
driven by data, and that a broken timed path comes out not correct."""

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELL = "pangenome60m_k31.greedy_fasta"
TINY = 20_000
# The cost limits at the tiny size, set as the cells' are, from readings
# (genome seed 0, every seed alike): sound 0.05534 tigs and 0.35367
# characters a unitig's; half of the sources searched 0.07941 and 0.37055;
# no candidates, and the program's eulertigs, 0.28063 and 0.47045.
TINY_LIMITS = {"tig_ratio": 0.065, "char_ratio": 0.36}


def tiny(cell):
    """The cell with its cost limits at the tiny size."""
    return dataclasses.replace(cell, limits={**cell.limits, **TINY_LIMITS})


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(cell, traced=False, seed=7):
    return harness.run_cell(tiny(cell), seed, 0.0, traced, device="cpu", genome_length=TINY)


def test_a_traced_run_loads_neither_jax_nor_the_jax_package():
    """A whole traced run in a fresh process, then its modules' top-level
    names compared whole (``matchtigs_tpu_torch`` is not
    ``matchtigs_tpu``)."""
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from port_bench import harness\n"
        "r = harness.run_cell(harness.load_cell(%r), 3, 0.0, True, device='cpu', "
        "genome_length=%d)\n"
        "print(json.dumps(dict(correct=r['correct'], metrics=sorted(r['metrics']), "
        "forbidden=harness.forbidden_modules(), "
        "port='matchtigs_tpu_torch' in sys.modules)))\n" % (str(ROOT), CELL, TINY))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == dict(correct=True, forbidden=[], port=True,
                       metrics=["cli_unitigs_per_s", "device_stage_s", "extract_s",
                                "graph_build_s", "host_routed_s", "host_searched_share",
                                "join_s", "load_s", "overflow_tail_s", "parse_s",
                                "records_s", "search_prep_s", "spell_s", "untraced_share",
                                "write_s"])


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "matchtigs_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_extra.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "matchtigs_tpu.cli", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax", "matchtigs_tpu"]


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference, port_bench.metrics.roofline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'matchtigs_tpu_torch', 'matchtigs_tpu', 'jax'}))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_a_new_mix_and_log_lap_metric_are_data(tmp_path):
    """A cell, a mix and a per-layer metric of an existing kind added as
    files and entries in a copy, with no file edited: the harness finds
    and reads them.  The new cell is a greedy one, so it is added to the
    list of cells of ``join_s``, which the optimal front does not log."""
    bench = tmp_path / "port_bench"
    for sub in ("configs", "mixes", "metrics", "limits"):
        (bench / sub).mkdir(parents=True)
        for f in (ROOT / "port_bench" / sub).glob("*.json"):
            shutil.copy(f, bench / sub / f.name)
    mix = json.loads((bench / "mixes" / "greedy_fasta.json").read_text())
    mix.update(name="greedy_fasta_c16", cli_flags=["--sssp-initial-capacity", "16"])
    (bench / "mixes" / "greedy_fasta_c16.json").write_text(json.dumps(mix))
    (bench / "limits" / "pangenome60m_k31.greedy_fasta_c16.json").write_text(
        json.dumps(dict(limits=TINY_LIMITS)))
    (bench / "metrics" / "accept_s.json").write_text(json.dumps(dict(
        kind="log_lap", logger="matchtigs_tpu_torch.algos.greedytigs",
        laps=[dict(msg="Accepted %d paths as cheap dummy edges in %.2fs", arg=1)])))
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bm["configs"]:
        c["file"] = str(tmp_path / c["file"])
    bm["workloads"].append(dict(name="pangenome60m_k31.greedy_fasta_c16",
                                config="pangenome60m_k31", traffic="greedy_fasta_c16",
                                chips=1, why="capacity 16"))
    next(m for m in bm["per_layer"] if m["name"] == "join_s")["workloads"].append(
        "pangenome60m_k31.greedy_fasta_c16")
    bm["per_layer"].append(dict(name="accept_s", unit="s", better="lower",
                                source="program_span", layer="greedy accept",
                                moves="peak_host_gib",
                                workloads=["pangenome60m_k31.greedy_fasta_c16"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    for c in bm["configs"]:
        Path(c["file"]).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / "port_bench" / "configs" / Path(c["file"]).name, c["file"])

    cell = harness.load_cell("pangenome60m_k31.greedy_fasta_c16", root=tmp_path, bench=bench)
    assert cell.mix["cli_flags"] == ["--sssp-initial-capacity", "16"]
    assert cell.limits["tig_ratio"] == TINY_LIMITS["tig_ratio"]
    assert [n for n, _, _ in cell.per_layer] == [
        "cli_unitigs_per_s", "load_s", "write_s", "device_stage_s", "join_s",
        "device_idle_share", "accept_s"]
    result = run(cell, traced=True)
    assert result["correct"]
    assert result["metrics"]["accept_s"]["value"] > 0
    assert result["metrics"]["cli_unitigs_per_s"]["value"] > 0
    # the cells already there do not read it
    old = harness.load_cell(CELL, root=tmp_path, bench=bench)
    assert "accept_s" not in [n for n, _, _ in old.per_layer]


def test_an_untraced_run_reports_the_end_to_end_metrics():
    result = run(harness.load_cell(CELL))
    assert result["correct"] and result["failed"] == 0 and result["attempted"] == 1
    assert sorted(result["metrics"]) == ["peak_host_gib", "setup_s"]
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
    for name in ("tig_ratio", "char_ratio"):
        assert result["checks"][name]["value"] < result["checks"][name]["limit"]


def _unitigs_as_walks(g, config):
    """A compute step that returns its state unchanged: every unitig a tig
    of its own."""
    return [np.array([e]) for e in range(0, g.n_edges, 2)]


def _half(real):
    def compute(g, config):
        walks = list(real(g, config))
        return walks[::2]
    return compute


def _altering(real):
    def write(g, walks, store, k, path, *args, **kwargs):
        real(g, walks, store, k, path, *args, **kwargs)
        data = bytearray(Path(path).read_bytes())
        at = data.index(b"\n") + 1 + 5  # a base of the first tig
        data[at] = ord("A") if data[at] != ord("A") else ord("C")
        Path(path).write_bytes(bytes(data))
    return write


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered",
                                   "no_candidates", "half_sources"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    """The run with the timed path broken underneath (the chip's look
    skipped): each fault a one-chip greedy cell can have makes ``correct``
    false: the walks returned unchanged or half of them, a base altered in
    the writer, and the search stage finding nothing or searching half of
    its sources.  (The exchange between chips does not exist on one
    chip.)"""
    from matchtigs_tpu_torch import cli

    cell = harness.load_cell(CELL)
    assert run(cell)["correct"]
    if fault == "state_unchanged":
        monkeypatch.setattr(cli, "compute_greedytigs", _unitigs_as_walks)
    elif fault == "half_left_out":
        monkeypatch.setattr(cli, "compute_greedytigs", _half(cli.compute_greedytigs))
    elif fault == "answer_altered":
        monkeypatch.setattr(cli, "write_walks_fasta", _altering(cli.write_walks_fasta))
    if fault in control.PROGRAM_FAULTS:
        with control.planted(fault):
            result = run(cell)
    else:
        result = run(cell)
    assert result["failed"] == 0 and not result["correct"]


def test_control_readings_on_the_cpu():
    """The control script's readings at a tiny size: the sound output
    passes every limit; the control and each fault fail one."""
    cell = tiny(harness.load_cell("pangenome100m_k31.greedy_fasta"))
    lines = control.readings(cell, [5, 2**31 + 11], "cpu", genome_length=TINY)
    for line in lines:
        assert all(line["sound"][n] <= v for n, v in cell.limits.items()), line
        for fault in control.UPPER:
            assert any(line[fault][n] > v for n, v in cell.limits.items()), (fault, line)
        # the planted search fault that finds nothing is the program's eulertigs
        assert line["no_candidates"]["tigs"] == line["eulertigs"]["tigs"]
    s = control.summary(cell, lines)
    assert s["foreign_kmers"]["upper"]["alter_base"] > 0
    assert s["tig_ratio"]["upper"]["unchanged"] == 1.0
    assert s["char_ratio"]["upper"]["half_sources"] > s["char_ratio"]["lower"]
