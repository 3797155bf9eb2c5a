"""The plain reference, its control and its faults, on the CPU."""

import numpy as np
import pytest
import torch

from port_bench import generator, reference


def kmer_set_numpy(codes, offsets, k):
    """Canonical k-mers of every window inside one record, by plain loops
    over strings."""
    comp = str.maketrans("ACGT", "TGCA")
    out = set()
    text = "".join("ACGT"[c] for c in codes)
    for i in range(len(offsets) - 1):
        s = text[offsets[i]:offsets[i + 1]]
        for j in range(len(s) - k + 1):
            w = s[j:j + k]
            r = w.translate(comp)[::-1]
            out.add(min(w, r))
    return out


def packed(strings, k):
    return sorted(int("".join("0123"["ACGT".index(c)] for c in s), 4) for s in strings)


@pytest.fixture
def dataset(tmp_path):
    codes, offsets, kmers = generator.make_pangenome(6_000, 11, 3, 0.01, 4, True, "cpu")
    kmers = generator.kmers_numpy(kmers)
    path = tmp_path / "in.fa"
    generator.write_fasta(path, codes, offsets)
    return codes, offsets, kmers, path


def test_kmer_set_is_the_generators_and_a_plain_loops(dataset):
    codes, offsets, kmers, path = dataset
    got, malformed = reference.kmer_set(codes, offsets, 11, "cpu")
    assert malformed == 0
    np.testing.assert_array_equal(got.numpy().view(np.uint64), kmers)
    small = offsets[offsets <= 2000]
    want = packed(kmer_set_numpy(codes, small, 11), 11)
    assert reference.kmer_set(codes[: small[-1]], small, 11, "cpu")[0].tolist() == want


def test_blocks_do_not_change_the_set(dataset, monkeypatch):
    codes, offsets, _, _ = dataset
    whole, _ = reference.kmer_set(codes, offsets, 11, "cpu")
    monkeypatch.setattr(reference, "BLOCK", 97)
    assert torch.equal(reference.kmer_set(codes, offsets, 11, "cpu")[0], whole)


def test_multiline_lowercase_and_malformed_records(tmp_path):
    path = tmp_path / "x.fa"
    path.write_bytes(b">a\nACGTA\ncgt\r\n>b desc\nACNTACGT\n>c\nAC\n>d\nGGGTTT")
    codes, offsets = reference.read_fasta(path)
    assert offsets.tolist() == [0, 8, 16, 18, 24]
    assert bytes(np.frombuffer(b"ACGT", np.uint8)[codes[:8]]) == b"ACGTACGT"
    assert codes[10] == 255
    _, malformed = reference.kmer_set(codes, offsets, 4, "cpu")
    assert malformed == 2  # b holds an N, c is shorter than k


def test_an_empty_output_misses_every_kmer(dataset, tmp_path):
    codes, offsets, kmers, path = dataset
    empty = tmp_path / "empty.fa"
    empty.write_bytes(b"")
    got = reference.check_output(reference.input_kmers(path, 11, "cpu"), empty, 11, "cpu")
    assert (got["missing_kmers"], got["tigs"]) == (len(kmers), 0)


def test_compare_counts_missing_and_foreign():
    want = torch.tensor([1, 3, 5, 7])
    assert reference.compare(want, torch.tensor([1, 3, 5, 7])) == (0, 0)
    assert reference.compare(want, torch.tensor([0, 1, 5, 9])) == (2, 2)
    assert reference.compare(torch.tensor([], dtype=torch.int64), want) == (0, 4)


def test_control_and_faults_break_what_they_break(dataset, tmp_path):
    """The input read back as an output spells its k-mer set exactly, with
    a tig ratio of 1; the control (one base altered) leaves k-mers
    foreign; half the tigs left out leaves k-mers missing."""
    codes, offsets, kmers, path = dataset
    want = reference.input_kmers(path, 11, "cpu")
    assert want["unitigs"] == len(offsets) - 1 and want["malformed"] == 0
    unchanged = reference.check_output(want, path, 11, "cpu")
    assert unchanged["tig_ratio"] == unchanged["char_ratio"] == 1.0
    assert unchanged["missing_kmers"] == unchanged["foreign_kmers"] == 0
    for fault, field in (("alter_base", "foreign_kmers"), ("drop_half", "missing_kmers")):
        bad = tmp_path / f"{fault}.fa"
        reference.damage(path, bad, fault, seed=11)
        got = reference.check_output(want, bad, 11, "cpu")
        assert got[field] > 0, (fault, got)
