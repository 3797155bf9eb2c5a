"""The frozen generator against the port's generator, on the CPU."""

import numpy as np
import pytest
import torch

from port_bench import generator, reference


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("genome_length,k,n_strains,with_repeats,seed", [
    (30_000, 31, 7, True, 0),
    (20_000, 31, 3, False, 2**31 + 7),
    (8_000, 15, 4, True, 5),
    (3_000, 7, 2, False, 1),
    (30_000, 63, 7, True, 0),
    (20_000, 32, 3, False, 2**31 + 7),
    (8_000, 47, 4, True, 5),
    (3_000, 33, 2, False, 1),
])
def test_bit_identical_to_the_port_generator(genome_length, k, n_strains, with_repeats, seed):
    from matchtigs_tpu_torch import testing

    codes, offsets, kmers = generator.make_pangenome(
        genome_length, k, n_strains, 0.01, seed, with_repeats, "cpu")
    assert kmers.shape == ((len(kmers),) if k <= 31 else (len(kmers), 2))
    kmers = generator.kmers_numpy(kmers)
    store, want_kmers, _ = testing.make_pangenome_store(
        genome_length=genome_length, k=k, n_strains=n_strains, mutation_rate=0.01,
        seed=seed, with_repeats=with_repeats, device="cpu")
    np.testing.assert_array_equal(codes, store.codes)
    np.testing.assert_array_equal(offsets, store.offsets)
    np.testing.assert_array_equal(kmers, want_kmers)
    assert kmers.dtype == want_kmers.dtype == (np.uint64 if k <= 31 else np.dtype("V16"))


def test_digest_is_the_smokes():
    """dataset_digest hashes as the smoke's does: codes, offsets, k-mers."""
    import hashlib

    codes, offsets, kmers = generator.make_pangenome(5_000, 31, 2, 0.01, 3, True, "cpu")
    kmers = generator.kmers_numpy(kmers)
    h = hashlib.sha256()
    for a in (codes.astype(np.uint8), offsets.astype(np.int64), kmers.astype(np.uint64)):
        h.update(a.tobytes())
    assert generator.dataset_digest(codes, offsets, kmers) == h.hexdigest()


def test_fasta_reads_back(tmp_path):
    """The fasta the harness writes is read back to the same unitigs by the
    port's reader and by the reference's."""
    from matchtigs_tpu_torch.io.readers import read_fasta

    codes, offsets, _ = generator.make_pangenome(20_000, 31, 3, 0.01, 9, True, "cpu")
    path = tmp_path / "u.fa"
    n = generator.write_fasta(path, codes, offsets)
    assert n == path.stat().st_size
    head = path.read_bytes()[:40].split(b"\n")
    assert head[0] == b">0" and set(head[1]) <= set(b"ACGT")
    store, headers = read_fasta(path)
    np.testing.assert_array_equal(store.codes, codes)
    np.testing.assert_array_equal(store.offsets, offsets)
    assert headers[-1] == str(len(offsets) - 2).encode()
    got_codes, got_offsets = reference.read_fasta(path)
    np.testing.assert_array_equal(got_codes, codes)
    np.testing.assert_array_equal(got_offsets, offsets)


def test_k_above_63_is_refused():
    codes, offsets, _ = generator.make_pangenome(1_000, 63, 2, 0.01, 0, False, "cpu")
    with pytest.raises(ValueError):
        generator.make_pangenome(1_000, 64, 2, 0.01, 0, False, "cpu")
    with pytest.raises(ValueError):
        reference.kmer_set(codes, offsets, 64, "cpu")


def test_a_seed_reorders_and_flips_the_same_unitigs():
    """Every seed holds the same k-mer set and the same unitig lengths, in
    an order and orientations of its own; the same seed, the same bytes."""
    codes, offsets, kmers = generator.make_pangenome(20_000, 31, 3, 0.01, 0, True, "cpu")
    want, _ = reference.kmer_set(codes, offsets, 31, "cpu")
    got = {}
    for seed in (1, 2**33 + 1, 1):
        c, o = generator.shuffle_unitigs(codes, offsets, seed, "cpu")
        np.testing.assert_array_equal(np.sort(np.diff(o)), np.sort(np.diff(offsets)))
        assert torch.equal(reference.kmer_set(c, o, 31, "cpu")[0], want)
        if seed in got:
            np.testing.assert_array_equal(c, got[seed])
        got[seed] = c
    assert not np.array_equal(got[1], got[2**33 + 1])
    assert not np.array_equal(got[1], codes)
