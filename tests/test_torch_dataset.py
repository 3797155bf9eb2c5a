"""The port's torch dataset generator (``make_pangenome_store(device=...)``,
``unitig_codes_from_kmers``) against the JAX package's numpy generator:
codes, offsets and k-mers equal bit for bit, on the CPU, with one-word
keys (k <= 31) and two-word keys (31 < k <= 63).  At k = 32, where the JAX
package's two-word generator raises, the port's two paths are held to each
other and to the strains' k-mers taken as strings."""

import numpy as np
import pytest
import torch

from matchtigs_tpu import testing as jtesting
from matchtigs_tpu_torch import testing as ttesting

# (genome_length, k, with_repeats, seed, n_strains)
PANGENOMES = [
    (2000, 9, False, 0, 4),
    (5000, 9, True, 1, 3),
    (20000, 15, False, 2, 4),
    (20000, 15, True, 3, 7),
    (50000, 21, True, 4, 7),
    (60000, 21, False, 5, 2),
    (100000, 31, True, 6, 7),
    (200000, 31, True, 0, 7),
    (200000, 31, False, 7, 3),
    # two-word keys; small, since the numpy path takes seconds here
    (50000, 33, True, 8, 7),
    (30000, 47, False, 9, 4),
    (50000, 63, True, 10, 7),
]
# (k, seed): even k gives palindromic k-mers, so self-twin chains
UNITIG_CASES = [(8, 0), (9, 1), (10, 2), (12, 3), (15, 4), (31, 5),
                (33, 6), (48, 7), (62, 8), (63, 9)]
# k = 32 pangenomes: (genome_length, with_repeats, seed, n_strains)
K32_PANGENOMES = [(20000, True, 11, 4), (30000, False, 12, 3)]
_COMPLEMENT = bytes.maketrans(bytes(range(4)), bytes(range(3, -1, -1)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's thread pool costs more than it saves, and
    under several test workers it waits on busy cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _arena(unitigs):
    offsets = np.zeros(len(unitigs) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(u) for u in unitigs])
    codes = np.concatenate(unitigs) if unitigs else np.empty(0, np.uint8)
    return codes.astype(np.uint8), offsets


@pytest.mark.parametrize("length,k,repeats,seed,strains", PANGENOMES)
def test_pangenome_store_bit_identical_to_jax(length, k, repeats, seed, strains):
    case = dict(genome_length=length, k=k, n_strains=strains, mutation_rate=0.01,
                seed=seed, with_repeats=repeats)
    want, want_kmers, _ = jtesting.make_pangenome_store(**case)
    got, got_kmers, got_k = ttesting.make_pangenome_store(**case, device="cpu")
    assert got_k == k and len(got) == len(want) > 0
    assert got_kmers.dtype == want_kmers.dtype == (np.uint64 if k <= 31 else np.dtype("V16"))
    assert np.array_equal(got_kmers, want_kmers)
    assert np.array_equal(got.offsets, want.offsets)
    assert np.array_equal(got.codes, want.codes)


def _kmer_set_with_cycles_and_palindromes(k: int, seed: int) -> np.ndarray:
    """Canonical k-mers of a random genome, of sequences X + revcomp(X) (for
    even k their middle k-mer is its own reverse complement, so their chain
    is its own twin) and of circular sequences (isolated cycles), each drawn
    again until it shares no (k-1)-mer with what came before."""
    rng = np.random.default_rng(seed + 100)  # not the genome's stream
    genome = jtesting.random_genome(min(3000, 4 ** (k - 1) // 64), seed=seed)
    seqs = [genome]
    overlaps = set(jtesting.kmer_set_of_codes(genome, k - 1).tolist())
    draws = [("palindrome", a) for a in (k + 5, 2 * k)]
    draws += [("circle", m) for m in (24, 40, 77)]
    for kind, size in draws:
        for _ in range(100):
            part = rng.integers(0, 4, size, dtype=np.uint8)
            if kind == "palindrome":
                seq = np.concatenate([part, 3 - part[::-1]])
            else:  # its k-mers wrap around
                seq = np.concatenate([part, part[:k - 1]])
            own = set(jtesting.kmer_set_of_codes(seq, k - 1).tolist())
            if not own & overlaps:
                break
        seqs.append(seq)
        overlaps |= own
    return np.unique(np.concatenate([jtesting.kmer_set_of_codes(q, k) for q in seqs]))


def _is_isolated_cycle(u: np.ndarray, k: int, kmers: set) -> bool:
    """The unitig closes on itself: its (k-1)-suffix is its (k-1)-prefix and
    its last k-mer's only successor is its first k-mer."""
    if len(u) < k or not np.array_equal(u[: k - 1], u[len(u) - k + 1:]):
        return False

    def canon(s):
        return min(s.tobytes(), (3 - s[::-1]).tobytes())

    succs = [c for c in range(4)
             if canon(np.append(u[len(u) - k + 1:], np.uint8(c))) in kmers]
    return succs == [u[k - 1]]


@pytest.mark.parametrize("k,seed", UNITIG_CASES)
def test_unitigs_from_kmers_bit_identical_to_jax(k, seed):
    kmers = _kmer_set_with_cycles_and_palindromes(k, seed)
    want = jtesting.unitigs_from_kmers(kmers, k)
    codes, offsets = ttesting.unitig_codes_from_kmers(ttesting.kmers_to_torch(kmers), k)
    want_codes, want_offsets = _arena(want)
    assert np.array_equal(offsets.numpy(), want_offsets)
    assert np.array_equal(codes.numpy(), want_codes)
    # the cases hold what the ordering and the dedupe must get right
    canon = {min(km.tobytes(), (3 - km[::-1]).tobytes())
             for u in want for km in np.lib.stride_tricks.sliding_window_view(u, k)}
    assert any(_is_isolated_cycle(u, k, canon) for u in want)
    if k % 2 == 0:
        assert any(np.array_equal(u, 3 - u[::-1]) for u in want)


def test_torch_generator_refuses_k_above_63():
    with pytest.raises(ValueError, match="k <= 63"):
        ttesting.make_pangenome_store(genome_length=2000, k=64, device="cpu")
    with pytest.raises(ValueError, match="k <= 63"):
        ttesting.unitig_codes_from_kmers(torch.zeros(4, 2, dtype=torch.int64), 64)
    with pytest.raises(ValueError, match="shape"):  # two-word keys are [n, 2]
        ttesting.unitig_codes_from_kmers(torch.zeros(4, dtype=torch.int64), 33)


def _rc(s: bytes) -> bytes:
    return s[::-1].translate(_COMPLEMENT)


def _canon(s: bytes) -> bytes:
    return min(s, _rc(s))


def _windows(s: bytes, k: int) -> list:
    return [s[j:j + k] for j in range(len(s) - k + 1)]


@pytest.mark.parametrize("length,repeats,seed,strains", K32_PANGENOMES)
def test_k32_both_paths_agree_and_spell_the_strains(length, repeats, seed, strains):
    """F6: at k = 32 the two-word keys' hi word holds no base.  The numpy
    and torch paths agree bit for bit; their unitigs spell each canonical
    k-mer of the strains (taken as strings) exactly once, and each unitig
    is maximal: neither end has a forced extension (one successor, whose
    one predecessor is the end, not its reverse complement and not already
    in the unitig)."""
    k = 32
    case = dict(genome_length=length, k=k, n_strains=strains, mutation_rate=0.01,
                seed=seed, with_repeats=repeats)
    store, kmers, _ = ttesting.make_pangenome_store(**case)
    got, got_kmers, _ = ttesting.make_pangenome_store(**case, device="cpu")
    assert kmers.dtype == np.dtype("V16") and np.array_equal(got_kmers, kmers)
    assert np.array_equal(got.offsets, store.offsets)
    assert np.array_equal(got.codes, store.codes)

    strings = {_canon(w) for s in ttesting.pangenome_strains(length, strains, 0.01, seed, repeats)
               for w in _windows(s.tobytes(), k)}
    unitigs = [store.get(i).tobytes() for i in range(len(store))]
    spelled = [_canon(w) for u in unitigs for w in _windows(u, k)]
    assert len(spelled) == len(set(spelled)) == len(strings) == len(kmers) > 0
    assert set(spelled) == strings

    def succs(x):
        return [x[1:] + bytes([c]) for c in range(4) if _canon(x[1:] + bytes([c])) in strings]

    def preds(x):
        return [bytes([c]) + x[:-1] for c in range(4) if _canon(bytes([c]) + x[:-1]) in strings]

    def forced_end(u):
        own = {_canon(w) for w in _windows(u, k)}
        last, nxt = u[-k:], succs(u[-k:])
        return (len(nxt) == 1 and preds(nxt[0]) == [last] and nxt[0] != _rc(last)
                and _canon(nxt[0]) not in own)

    assert not any(forced_end(u) or forced_end(_rc(u)) for u in unitigs)
    assert len({len(u) for u in unitigs}) > 1  # the draw branches


@pytest.mark.parametrize("k", [21, 32, 33, 63])
def test_spelled_kmers_torch_equal_numpy(k):
    """The torch k-mer oracle of a store's sequences (one word and two)
    equals the JAX package's numpy multiset."""
    store, _, _ = ttesting.make_pangenome_store(
        genome_length=20000, k=k, n_strains=3, mutation_rate=0.02, seed=k, with_repeats=True)
    seqs = [store.get(i) for i in range(len(store))]
    seqs.append(np.zeros(k - 1, np.uint8))  # too short for a k-mer
    store = type(store).from_flat(np.concatenate(seqs),
                                  np.concatenate([[0], np.cumsum([len(q) for q in seqs])]))
    got = ttesting.kmers_to_numpy(ttesting.spelled_kmers_torch(store, k, "cpu"))
    assert np.array_equal(np.sort(got), jtesting.kmer_multiset_of_walk_seqs(seqs, k))
    unique = ttesting.sorted_unique_kmers(ttesting.kmers_to_torch(got), k)
    assert np.array_equal(ttesting.kmers_to_numpy(unique), np.unique(got))


@pytest.mark.parametrize("k", [9, 33])
def test_numpy_generator_unchanged(k):
    """``device=None`` keeps the numpy path (k up to 63)."""
    case = dict(genome_length=8000, k=k, n_strains=3, mutation_rate=0.01, seed=9,
                with_repeats=True)
    want, want_kmers, _ = jtesting.make_pangenome_store(**case)
    got, got_kmers, _ = ttesting.make_pangenome_store(**case)
    assert np.array_equal(got_kmers, want_kmers)
    assert np.array_equal(got.offsets, want.offsets)
    assert np.array_equal(got.codes, want.codes)


def test_torch_generator_cache_round_trip(tmp_path):
    case = dict(genome_length=5000, k=15, n_strains=3, seed=2, with_repeats=True,
                cache_dir=str(tmp_path))
    made, made_kmers, _ = ttesting.make_pangenome_store(**case, device="cpu")
    assert len(list(tmp_path.glob("*.npz"))) == 1
    loaded, loaded_kmers, _ = ttesting.make_pangenome_store(**case)
    assert np.array_equal(loaded.codes, made.codes)
    assert np.array_equal(loaded.offsets, made.offsets)
    assert np.array_equal(loaded_kmers, made_kmers)
