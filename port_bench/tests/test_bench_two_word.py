"""The generator and the reference at two words a k-mer (31 < k <= 63),
on the CPU: the generator's digest, the reference's k-mer sets against
the generator's, the port's numpy sets and a plain loop over strings,
and its comparison against the control and the faults it plants.  The
generator against the port's at these k is test_bench_generator.py's."""

import numpy as np
import pytest
import torch

from port_bench import generator, reference

COMP = str.maketrans("ACGT", "TGCA")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain_kmer_set(text: str, offsets, k: int) -> set:
    """Canonical k-mers of every window inside one record that holds only
    A, C, G and T, by plain loops over strings."""
    out = set()
    for i in range(len(offsets) - 1):
        s = text[offsets[i]:offsets[i + 1]]
        for j in range(len(s) - k + 1):
            w = s[j:j + k]
            if set(w) <= set("ACGT"):
                out.add(min(w, w.translate(COMP)[::-1]))
    return out


def as_strings(keys: torch.Tensor, k: int) -> list:
    """Two-word keys spelled out, first base from hi's top."""
    out = []
    for hi, lo in keys.tolist():
        v = (hi << 64) | (lo & ((1 << 64) - 1))
        out.append("".join("ACGT"[(v >> (2 * (k - 1 - j))) & 3] for j in range(k)))
    return out


def test_digest_hashes_the_16_bytes_of_each_key():
    """As the smoke's dataset_digest: codes, offsets, then each two-word
    key's 16 big-endian bytes, hi first."""
    import hashlib

    codes, offsets, kmers = generator.make_pangenome(5_000, 63, 2, 0.01, 3, True, "cpu")
    h = hashlib.sha256()
    h.update(codes.astype(np.uint8).tobytes())
    h.update(offsets.astype(np.int64).tobytes())
    h.update(kmers.numpy().astype(">i8").tobytes())
    assert generator.dataset_digest(codes, offsets, generator.kmers_numpy(kmers)) == h.hexdigest()


@pytest.mark.parametrize("k", [32, 33, 47, 63])
def test_kmer_set_is_the_ports_and_a_plain_loops(k, monkeypatch):
    """Over blocks of any size: the port's numpy k-mer set of every record,
    the generator's set, and on a prefix the set that plain loops over
    strings spell, in the same order."""
    from matchtigs_tpu_torch import testing

    codes, offsets, kmers = generator.make_pangenome(6_000, k, 3, 0.01, 4, True, "cpu")
    got, malformed = reference.kmer_set(codes, offsets, k, "cpu")
    assert malformed == 0
    assert torch.equal(got, kmers)
    want = np.unique(np.concatenate([testing.kmer_set_of_codes(codes[a:b], k)
                                     for a, b in zip(offsets[:-1], offsets[1:])]))
    np.testing.assert_array_equal(generator.kmers_numpy(got), want)
    monkeypatch.setattr(reference, "BLOCK", 97)
    assert torch.equal(reference.kmer_set(codes, offsets, k, "cpu")[0], got)
    small = offsets[offsets <= 2000]
    text = "".join("ACGT"[c] for c in codes[: small[-1]])
    prefix, _ = reference.kmer_set(codes[: small[-1]], small, k, "cpu")
    assert as_strings(prefix, k) == sorted(plain_kmer_set(text, small, k))


@pytest.mark.parametrize("k", [32, 33, 47, 63])
def test_malformed_and_short_records(tmp_path, k):
    """A record with a byte other than ACGT, or shorter than k, is counted
    malformed, as at one word; the windows over the bad byte are left out
    and the others kept."""
    rng = np.random.default_rng(k)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, n)) for n in (k + 9, 2 * k, k - 1, k)]
    seqs[1] = seqs[1][:k // 2] + "N" + seqs[1][k // 2 + 1:]
    path = tmp_path / "x.fa"
    path.write_text("".join(f">{i}\n{s.lower() if i == 3 else s}\n" for i, s in enumerate(seqs)))
    codes, offsets = reference.read_fasta(path)
    got, malformed = reference.kmer_set(codes, offsets, k, "cpu")
    assert malformed == 2  # 1 holds an N, 2 is shorter than k
    text = "".join(s.upper() for s in seqs)
    assert as_strings(got, k) == sorted(plain_kmer_set(text, offsets, k))


def test_compare_counts_missing_and_foreign_keys():
    """Two-word keys equal in one word are told apart by the other."""
    want = torch.tensor([[0, 1], [0, -1], [1, 0], [2, 5]])
    assert reference.compare(want, want) == (0, 0)
    got = torch.tensor([[0, 2], [0, -1], [2, 5], [3, 1], [3, 2]])
    assert reference.compare(want, got) == (2, 3)
    empty = torch.empty((0, 2), dtype=torch.int64)
    assert reference.compare(empty, want) == (0, 4)
    assert reference.compare(want, empty) == (4, 0)
    # long runs of one hi, lo on both sides of its sign bit
    rng = np.random.default_rng(3)
    los = rng.integers(-2**63, 2**63 - 1, 40, dtype=np.int64, endpoint=True)
    sets = [{(int(h), int(los[i])) for h, i in zip(rng.integers(0, 3, 80), rng.integers(0, 40, 80))}
            for _ in range(2)]
    want, got = (generator.sorted_unique_kmers(torch.tensor(sorted(s)), 63) for s in sets)
    assert reference.compare(want, got) == (len(sets[0] - sets[1]), len(sets[1] - sets[0]))


def test_check_output_counts_what_the_faults_plant(tmp_path):
    """At k=63: the input read back as an output spells its k-mer set
    exactly; the control (one base altered) leaves up to k k-mers foreign
    and as many missing; half the tigs left out leaves exactly their
    k-mers missing."""
    k = 63
    codes, offsets, kmers = generator.make_pangenome(20_000, k, 3, 0.01, 6, True, "cpu")
    path = tmp_path / "in.fa"
    generator.write_fasta(path, codes, offsets)
    want = reference.input_kmers(path, k, "cpu")
    assert want["unitigs"] == len(offsets) - 1 and want["malformed"] == 0
    assert torch.equal(want["kmers"], kmers)
    sound = reference.check_output(want, path, k, "cpu")
    assert sound["missing_kmers"] == sound["foreign_kmers"] == sound["malformed_records"] == 0
    assert sound["tig_ratio"] == sound["char_ratio"] == 1.0

    reference.damage(path, tmp_path / "alter.fa", "alter_base", seed=11)
    altered = reference.check_output(want, tmp_path / "alter.fa", k, "cpu")
    assert 1 <= altered["foreign_kmers"] <= k and 1 <= altered["missing_kmers"] <= k
    assert altered["tig_ratio"] == altered["char_ratio"] == 1.0

    reference.damage(path, tmp_path / "half.fa", "drop_half", seed=11)
    half = reference.check_output(want, tmp_path / "half.fa", k, "cpu")
    kept = [codes[a:b] for a, b in zip(offsets[:-1:2], offsets[1::2])]
    kept_offsets = np.concatenate([[0], np.cumsum([len(s) for s in kept])])
    left, _ = reference.kmer_set(np.concatenate(kept), kept_offsets, k, "cpu")
    assert half["missing_kmers"] == len(kmers) - len(left) > 0
    assert half["foreign_kmers"] == 0 and half["tigs"] == len(offsets) // 2
