"""The port's CLI against the JAX package's on tests/test_cli.py's fixture:
byte-identical outputs of every algorithm (the port on ``--device cpu``)."""

import gzip

import pytest

from matchtigs_tpu import testing
from matchtigs_tpu.cli import main as j_main
from matchtigs_tpu_torch.cli import main as t_main


@pytest.fixture(scope="module")
def unitig_fa(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    store, kmers, k = testing.make_unitig_store(genome_length=4000, k=11, seed=5)
    path = tmp / "unitigs.fa.gz"
    with gzip.open(path, "wb") as f:
        for i in range(len(store)):
            f.write(b">%d\n%s\n" % (i, store.get_ascii(i)))
    return path, k


@pytest.mark.parametrize(
    "flag,name",
    [
        ("--greedytigs-fa-out", "g.fa"),
        ("--greedytigs-gfa-out", "g.gfa.gz"),
        ("--greedytigs-duplication-bitvector-out", "g.bv"),
    ],
)
def test_cli_output_byte_identical_to_jax(unitig_fa, tmp_path, flag, name):
    path, k = unitig_fa
    outs = []
    for side, main in (("jax", j_main), ("torch", t_main)):
        out = tmp_path / f"{side}_{name}"
        device = ["--device", "cpu"] if side == "torch" else []
        rc = main(
            ["--fa-in", str(path), "-k", str(k), flag, str(out),
             "--log-level", "Warning", *device]
        )
        assert rc == 0
        data = out.read_bytes()
        outs.append(gzip.decompress(data) if name.endswith(".gz") else data)
    assert outs[0] == outs[1] and len(outs[0]) > 0


@pytest.mark.parametrize(
    "options",
    [["--sssp-overflow-mode", "ladder"], ["--sssp-initial-capacity", "128"]],
    ids=["ladder", "C128"],
)
def test_cli_sssp_options_byte_identical_to_jax(
    unitig_fa, tmp_path, monkeypatch, options
):
    """Both CLIs on their device engines (the JAX stage on the XLA CPU
    backend, the port's plain version on the CPU it names)."""
    from matchtigs_tpu.algos import greedytigs as j_greedytigs
    from matchtigs_tpu_torch.algos import greedytigs as t_greedytigs

    for mod in (j_greedytigs, t_greedytigs):
        monkeypatch.setattr(mod, "_use_host_engine", lambda config: False)
    path, k = unitig_fa
    outs = []
    for side, main in (("jax", j_main), ("torch", t_main)):
        out = tmp_path / f"{side}.fa"
        device = ["--device", "cpu"] if side == "torch" else []
        rc = main(
            ["--fa-in", str(path), "-k", str(k), "--greedytigs-fa-out", str(out),
             "--use-mesh", "false", "--log-level", "Warning", *device, *options]
        )
        assert rc == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 0


def test_cli_refuses_capacity_below_one(unitig_fa, tmp_path, capsys):
    path, k = unitig_fa
    with pytest.raises(SystemExit):
        t_main(["--fa-in", str(path), "-k", str(k), "--sssp-initial-capacity",
                "0", "--greedytigs-fa-out", str(tmp_path / "x")])
    assert "must be >= 1" in capsys.readouterr().err


@pytest.mark.parametrize(
    "flag",
    ["--eulertigs-fa-out", "--pathtigs-gfa-out", "--matchtigs-fa-out",
     "--matchtigs-duplication-bitvector-out", "--matching-file-prefix"],
)
def test_cli_algorithm_byte_identical_to_jax(unitig_fa, tmp_path, flag):
    """Both CLIs write the same bytes for each algorithm's outputs; the
    matching prefix writes the instance and its solution (beside a
    matchtigs fasta)."""
    path, k = unitig_fa
    outs = []
    for side, main in (("jax", j_main), ("torch", t_main)):
        out = tmp_path / f"{side}.out"
        options = [flag, str(out)]
        if flag == "--matching-file-prefix":
            options += ["--matchtigs-fa-out", str(tmp_path / f"{side}.fa")]
            files = [tmp_path / f"{side}.out.matching",
                     tmp_path / f"{side}.out.matching.solution"]
        else:
            files = [out]
        device = ["--device", "cpu"] if side == "torch" else []
        rc = main(["--fa-in", str(path), "-k", str(k), *options,
                   "--log-level", "Warning", *device])
        assert rc == 0
        outs.append([f.read_bytes() for f in files])
    assert outs[0] == outs[1] and all(len(o) > 0 for o in outs[0])


@pytest.mark.parametrize(
    "flag", ["--greedytigs-fa-out", "--matchtigs-fa-out",
             "--matchtigs-duplication-bitvector-out"],
)
def test_cli_without_a_card_fails_instead_of_the_host(unitig_fa, tmp_path, monkeypatch, flag):
    """Without --device the search stage is the card's: with no CUDA device
    the run fails and writes nothing, it never runs on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, k = unitig_fa
    out = tmp_path / "x"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main(["--fa-in", str(path), "-k", str(k), flag, str(out),
                "--log-level", "Warning"])
    assert not out.exists()


def test_cli_accepts_sssp_batch_size_as_a_no_op(unitig_fa, tmp_path, caplog):
    """A JAX command line that passes --sssp-batch-size runs on the port:
    the flag is logged as ignored and the fasta is the same as without it."""
    path, k = unitig_fa
    outs = []
    for options in ([], ["--sssp-batch-size", "64"]):
        out = tmp_path / f"g{len(options)}.fa"
        caplog.clear()
        with caplog.at_level("INFO", logger="matchtigs_tpu_torch"):
            rc = t_main(["--fa-in", str(path), "-k", str(k), "--device", "cpu",
                         "--greedytigs-fa-out", str(out), *options])
        assert rc == 0
        noted = [r.getMessage() for r in caplog.records if "--sssp-batch-size" in r.getMessage()]
        assert noted == (["--sssp-batch-size 64 is accepted for compatibility and "
                          "ignored: the port's device search has no batch size"]
                         if options else [])
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 0


def test_cli_tunes_malloc_once(unitig_fa, tmp_path, monkeypatch):
    """main tunes the host allocator once, right after logging is set up,
    as the JAX CLI does."""
    from matchtigs_tpu_torch.utils import malloc_tuning

    calls = []
    monkeypatch.setattr(malloc_tuning, "tune_malloc", lambda: calls.append(1) or True)
    path, k = unitig_fa
    rc = t_main(["--fa-in", str(path), "-k", str(k), "--greedytigs-fa-out",
                 str(tmp_path / "g.fa"), "--log-level", "Warning", "--device", "cpu"])
    assert rc == 0 and calls == [1]
