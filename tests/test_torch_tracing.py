"""The port's tracer (``matchtigs_tpu_torch/utils/tracing.py``) through
``cli.main`` on a small pangenome, greedy and optimal: the span tree, its
coverage of the call, the INFO lap lines the spans log, and that tracing
off changes nothing and keeps nothing."""

import contextlib
import logging
import os
import threading
import tracemalloc
from pathlib import Path

import pytest
import torch

from matchtigs_tpu_torch import cli, testing
from matchtigs_tpu_torch.utils import tracing

ALGOS = ["greedytigs", "matchtigs"]
GREEDY_LOGGER = "matchtigs_tpu_torch.algos.greedytigs"
# the greedy front's lap lines that the benchmark's log_lap metrics read
GREEDY_LAPS = {
    "search.stage": "Device stage: %d sources at capacity %d in %.2fs (kernel %s)",
    "join.accept": "Accepted %d paths as cheap dummy edges in %.2fs",
    "join.balance": "Balancing took %.2fs",
    "join.euler_break": "Found %d greedytigs (euler+break %.2fs, total %.2fs)",
}
# the optimal front's "<label>: <seconds>s" laps, by span
MATCHTIGS_LAPS = {
    "matchtigs.candidates": "Candidate phase", "matchtigs.collapse": "Candidate collapse",
    "matchtigs.components": "WCC decomposition", "matchtigs.match": "Matching",
    "matchtigs.apply": "Apply matching", "join.balance": "Balance",
    "join.euler_break": "Euler + break",
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unitigs(tmp_path_factory):
    store, _, k = testing.make_pangenome_store(
        genome_length=60_000, k=31, n_strains=4, seed=3, with_repeats=True)
    path = tmp_path_factory.mktemp("tracing") / "unitigs.fa"
    testing.write_fasta(path, store)
    return path, k


def run(unitigs, algo, out, monkeypatch=None, log_level="Warning"):
    """One CLI call; with ``monkeypatch``, tracing on and the finished
    spans returned."""
    path, k = unitigs
    spans = []
    if monkeypatch is not None:
        monkeypatch.setattr(tracing, "sink", spans.append)
    rc = cli.main(["--fa-in", str(path), "-k", str(k), f"--{algo}-fa-out", str(out),
                   "--device", "cpu", "--log-level", log_level])
    if monkeypatch is not None:
        monkeypatch.setattr(tracing, "sink", tracing.discard)
    assert rc == 0
    return spans


def leaf_coverage(spans, root) -> float:
    parents = {s.parent for s in spans}
    covered, end = 0.0, None
    for s in sorted((s for s in spans if s.id not in parents), key=lambda s: s.start):
        if end is None or s.start > end:
            covered += s.seconds
            end = s.end
        elif s.end > end:
            covered += s.end - end
            end = s.end
    return covered / root.seconds


@pytest.mark.parametrize("algo", ALGOS)
def test_one_root_per_call_and_every_span_inside_its_parent(unitigs, tmp_path, monkeypatch,
                                                             algo):
    spans = run(unitigs, algo, tmp_path / "a.fa", monkeypatch)
    spans += run(unitigs, algo, tmp_path / "b.fa", monkeypatch)
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s.parent == 0]
    assert [r.name for r in roots] == ["cli", "cli"]
    for s in spans:
        assert s.root in {r.id for r in roots}
        assert s.start <= s.end
        if s.parent:
            parent = by_id[s.parent]
            assert parent.root == s.root
            assert parent.start <= s.start and s.end <= parent.end, (s.name, parent.name)
    names = {s.name for s in spans}
    assert {"load.read", "load.build", "compute", "write.spell", "write.records",
            "search.scan", "search.dispatch", "search.fetch", "search.extract",
            "join.balance", "join.euler_break"} <= names
    assert roots[0].counters["unitigs"] > 0
    stage = next(s for s in spans if s.name == "search.stage")
    assert {by_id[s.parent].name for s in spans if s.name in
            ("search.dispatch", "search.fetch", "search.extract")} == {"search.stage"}
    assert by_id[stage.parent].name == ("compute" if algo == "greedytigs"
                                        else "matchtigs.candidates")


@pytest.mark.parametrize("algo", ALGOS)
def test_leaf_spans_cover_the_call(unitigs, tmp_path, monkeypatch, algo):
    spans = run(unitigs, algo, tmp_path / "out.fa", monkeypatch)
    root = next(s for s in spans if s.parent == 0)
    assert leaf_coverage(spans, root) >= 0.95


@pytest.mark.parametrize("algo", ALGOS)
def test_lap_lines_are_logged_with_their_spans_seconds(unitigs, tmp_path, monkeypatch,
                                                       caplog, algo):
    """Each lap line keeps its format string, and its seconds are its
    span's, exactly (so equal at the printed precision)."""
    with caplog.at_level(logging.INFO, logger="matchtigs_tpu_torch"):
        spans = run(unitigs, algo, tmp_path / "out.fa", monkeypatch, log_level="Info")
    named = {s.name: s for s in spans}
    if algo == "greedytigs":
        laps = {msg: r for r in caplog.records for msg in GREEDY_LAPS.values()
                if r.name == GREEDY_LOGGER and r.msg == msg}
        assert set(laps) == set(GREEDY_LAPS.values())
        for name, msg in GREEDY_LAPS.items():
            s, args = named[name], laps[msg].args
            want = {
                "search.stage": lambda: (args[0], args[1], s.seconds, args[3]),
                "join.accept": lambda: (args[0], s.seconds),
                "join.balance": lambda: (s.seconds,),
                "join.euler_break": lambda: (
                    args[0], s.seconds, s.end - named["search.scan"].start),
            }[name]()
            assert args == want, name
            assert laps[msg].getMessage() == msg % want
        assert laps[GREEDY_LAPS["search.stage"]].args[0] == \
            named["search.dispatch"].counters["sources"]
    else:
        got = {r.args[0]: r.args[1] for r in caplog.records
               if r.msg == "%s: %.2fs" and r.name == "matchtigs_tpu_torch.algos.matchtigs"}
        assert got == {label: named[name].seconds for name, label in MATCHTIGS_LAPS.items()}
    summary = [r.args for r in caplog.records
               if r.msg == "Computing %s took %.1fs and writing took %.1fs"]
    assert summary == [(algo, named["compute"].seconds, named["write"].seconds)]
    load = [r.args for r in caplog.records if r.msg == "Loading took %.1f seconds"]
    assert load == [(named["load"].seconds,)]


@pytest.mark.parametrize("algo", ALGOS)
def test_output_is_the_same_with_tracing_on_and_off(unitigs, tmp_path, monkeypatch, algo):
    run(unitigs, algo, tmp_path / "off.fa")
    assert run(unitigs, algo, tmp_path / "on.fa", monkeypatch)
    off = (tmp_path / "off.fa").read_bytes()
    assert off and off == (tmp_path / "on.fa").read_bytes()


@pytest.mark.parametrize("algo", ALGOS)
def test_tracing_off_never_calls_the_sink_and_keeps_nothing(unitigs, tmp_path, monkeypatch,
                                                            algo):
    """The sink is ``discard`` itself, counted: off, nothing reaches it and
    no span is left open."""
    calls = []

    def counted(span):
        calls.append(span)

    monkeypatch.setattr(tracing, "discard", counted)
    monkeypatch.setattr(tracing, "sink", counted)
    run(unitigs, algo, tmp_path / "out.fa")
    assert calls == []
    assert tracing._stack() == []
    assert tracing.span("load.read") is tracing.NOOP


def test_an_untimed_span_off_allocates_no_more_than_a_bare_with():
    """Off, ``with span(...) as sp: sp.add()`` reaches the same peak of
    traced memory as a ``with`` over a context made beforehand (the
    statement itself makes a bound method), and leaves nothing behind."""
    made = contextlib.nullcontext()

    def bare(n):
        for _ in range(n):
            with made:
                pass

    def spans(n):
        for _ in range(n):
            with tracing.span("x") as sp:
                sp.add()

    def peak(loop):
        loop(10)  # warm
        tracemalloc.start()
        try:
            start, _ = tracemalloc.get_traced_memory()
            tracemalloc.reset_peak()
            loop(1000)
            end, top = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        return end - start, top - start

    left, top = peak(spans)
    assert left == 0 and top <= peak(bare)[1]


@pytest.mark.parametrize("fmt", ["fa", "gfa"])
def test_the_writer_counts_its_bytes_into_a_pipe(unitigs, tmp_path, monkeypatch, fmt):
    """Traced, the CLI writes to an output that cannot seek (a FIFO), and
    ``write.records`` counts exactly the bytes the reader got."""
    path, k = unitigs
    fifo = tmp_path / "out"
    os.mkfifo(fifo)
    got = []
    reader = threading.Thread(target=lambda: got.append(fifo.read_bytes()))
    reader.start()
    spans = []
    monkeypatch.setattr(tracing, "sink", spans.append)
    try:
        rc = cli.main(["--fa-in", str(path), "-k", str(k), f"--greedytigs-{fmt}-out",
                       str(fifo), "--device", "cpu", "--log-level", "Warning"])
    finally:
        monkeypatch.setattr(tracing, "sink", tracing.discard)
        reader.join()
    assert rc == 0
    records = next(s for s in spans if s.name == "write.records")
    assert got[0] and records.counters["bytes"] == len(got[0])
    assert records.counters["tigs"] == got[0].count(b">" if fmt == "fa" else b"\nS\t")


def test_debug_logging_shows_every_span(unitigs, tmp_path, caplog):
    with caplog.at_level(logging.DEBUG, logger=tracing.__name__):
        run(unitigs, "greedytigs", tmp_path / "out.fa")
    lines = [r.getMessage() for r in caplog.records if r.name == tracing.__name__]
    assert any(line.startswith("span load.read ") and "records=" in line for line in lines)
    assert any(line.startswith("span write.records ") and "bytes=" in line for line in lines)


def test_stacks_are_per_thread_and_an_exception_closes_its_spans(monkeypatch, caplog):
    spans = []
    monkeypatch.setattr(tracing, "sink", spans.append)
    with tracing.span("outer") as outer:
        t = threading.Thread(target=lambda: tracing.span("other").__enter__())
        t.start()
        t.join()
        with pytest.raises(ValueError), caplog.at_level(logging.INFO):
            with tracing.span("failing", timed=True) as failing:
                failing.lap(logging.getLogger("x"), "never %.2f", tracing.ELAPSED)
                with tracing.span("inner"):
                    raise ValueError
        assert tracing._stack() == [outer]
    assert tracing._stack() == []
    assert [s.name for s in spans] == ["inner", "failing", "outer"]
    assert [s.parent for s in spans] == [failing.id, outer.id, 0]
    assert not any(r.msg == "never %.2f" for r in caplog.records)


def test_no_environment_variable_traces_the_port():
    root = Path(tracing.__file__).resolve().parents[1]
    assert [p for p in root.rglob("*.py") if "MATCHTIGS_NATIVE_TRACE" in p.read_text()] == []
