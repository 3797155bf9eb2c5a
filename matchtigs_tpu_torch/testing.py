# Copied from matchtigs_tpu/testing.py; adds assert_tigs_spell_kmer_strings for k > 63, ball_graph (stage graphs with a ball of a given size), capi_merges and graph_links (a graph's topology as C ABI merge calls and as the links of a BCALM2 or GFA file), write_fasta, write_bcalm2 and write_gfa (those files, built over whole columns), same_graph_up_to_node_ids and split_linkless_nodes, unitigs_from_kmers runs its lookups in threads (same output), make_pangenome_store(device=...) builds the k-mer sets and unitigs with torch on a device for k <= 63 (same output; pangenome_on_device, unitig_codes_from_kmers, spelled_kmers_torch), and the two-word path handles k = 32 (the original raises there: its predecessor shift goes negative); without its python fallbacks: the port requires the native library.
"""Synthetic data generation and oracle checks.

The reference repo ships no fixtures; its real test oracle is k-mer-set
equivalence of the spelled tigs (SURVEY.md §4).  This module generates
random genomes, extracts their maximal unitigs (a minimal BCALM2-style
compactor over canonical k-mers), and provides the k-mer-set oracle used
by the test-suite and benchmarks.

Packed-integer generators cover k <= 31 (uint64) and k <= 63 (two-word);
make_unitig_store_strings covers arbitrary k for tiny inputs.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .graph.bigraph import Bigraph
from .io.readers import Links
from .io.sequence_store import SequenceStore
from .utils import dna


def random_genome(length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=length, dtype=np.uint8)


def random_genome_with_repeats(
    length: int,
    seed: int = 0,
    repeat_len: int = 300,
    n_families: int = 3,
    copies_per_family: int = 200,
    divergence: float = 0.03,
) -> np.ndarray:
    """Random genome with interspersed diverged repeat families.

    Real genomes are repeat-rich; repeat families create dense tangles in
    the de Bruijn graph where bounded shortest-path searches expand large
    balls — the regime the reference's resource-limited staged parallelism
    exists for (greedytigs/mod.rs:537-644) and where batched device search
    pays off.
    """
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=length, dtype=np.uint8)
    families = [
        rng.integers(0, 4, size=repeat_len, dtype=np.uint8)
        for _ in range(n_families)
    ]
    # interspersed repeats (LINE/SINE-like): diverged copies scattered
    for fam in families:
        positions = rng.integers(0, length - repeat_len, size=copies_per_family)
        for pos in positions:
            copy = fam.copy()
            muts = np.flatnonzero(rng.random(repeat_len) < divergence)
            copy[muts] = (
                copy[muts] + rng.integers(1, 4, size=len(muts), dtype=np.uint8)
            ) % 4
            genome[pos : pos + repeat_len] = copy
    # tandem satellite arrays (alpha-satellite-like): ~171bp units repeated
    # in place with small divergence -- the dense-tangle regime where the
    # de Bruijn graph becomes a hairball of short unitigs and bounded
    # searches expand large balls
    unit_len = 171
    n_arrays = max(1, length // 2_000_000)
    array_copies = min(400, max(0, (length - 1) // unit_len))
    for _ in range(n_arrays):
        if array_copies < 2:
            break
        unit = rng.integers(0, 4, size=unit_len, dtype=np.uint8)
        arr_len = unit_len * array_copies
        pos = int(rng.integers(0, max(1, length - arr_len)))
        for c in range(array_copies):
            copy = unit.copy()
            muts = np.flatnonzero(rng.random(unit_len) < 0.02)
            copy[muts] = (
                copy[muts] + rng.integers(1, 4, size=len(muts), dtype=np.uint8)
            ) % 4
            genome[pos + c * unit_len : pos + (c + 1) * unit_len] = copy
    return genome


def mutate_genome(genome: np.ndarray, rate: float, seed: int = 0) -> np.ndarray:
    """Substitution-mutated copy of a genome (pangenome-strain analog)."""
    rng = np.random.default_rng(seed)
    out = genome.copy()
    pos = np.flatnonzero(rng.random(len(genome)) < rate)
    out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos), dtype=np.uint8)) % 4
    return out


def make_pangenome_store(
    genome_length: int,
    k: int,
    n_strains: int = 4,
    mutation_rate: float = 0.005,
    seed: int = 0,
    cache_dir: str | None = None,
    with_repeats: bool = False,
    device: str | torch.device | None = None,
) -> tuple["SequenceStore", np.ndarray, int]:
    """Reference genome + mutated strains -> unitig store (BASELINE.json
    config-5 analog: pangenome unitigs with bubble-rich topology;
    `with_repeats` adds diverged repeat families for realistic dense
    tangles).

    With `cache_dir`, the deterministic result is cached on disk keyed by
    the parameters (generation is memory-bandwidth-bound at 10M+ scales).

    `device` (k <= 63) builds the k-mer sets and extracts the unitigs with
    torch on that device (`pangenome_on_device`); the genomes are still
    drawn by numpy on the host.  The result is bit-identical to the numpy
    path's (`device=None`).
    """
    if device is not None and k > 63:
        raise ValueError(f"the torch generator covers k <= 63, not k={k}")
    cache_path = None
    if cache_dir is not None:
        from pathlib import Path

        rep = "_rep" if with_repeats else ""
        key = f"pan_{genome_length}_{k}_{n_strains}_{mutation_rate}_{seed}{rep}"
        cache_path = Path(cache_dir) / f"{key}.npz"
        if cache_path.exists():
            data = np.load(cache_path)
            store = SequenceStore.from_flat(data["codes"], data["offsets"])
            return store, data["kmers"], k

    strains = pangenome_strains(genome_length, n_strains, mutation_rate, seed, with_repeats)
    if device is not None:
        kmers, codes, offsets = pangenome_on_device(strains, k, torch.device(device))
        store = SequenceStore.from_flat(codes, offsets)
    else:
        kmers = np.unique(np.concatenate([kmer_set_of_codes(s, k) for s in strains]))
        unitigs = unitigs_from_kmers(kmers, k)
        store = SequenceStore()
        for u in unitigs:
            store.add(u)
        store.finalize()
    if cache_path is not None:
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache_path, codes=store.codes, offsets=store.offsets, kmers=kmers)
    return store, kmers, k


def pangenome_strains(
    genome_length: int, n_strains: int, mutation_rate: float, seed: int, with_repeats: bool
):
    """The code arrays of `make_pangenome_store`'s strains, one at a time:
    the base genome, then its mutated copies."""
    if with_repeats:
        base = random_genome_with_repeats(
            genome_length,
            seed=seed,
            copies_per_family=max(20, genome_length // 25000),
        )
    else:
        base = random_genome(genome_length, seed=seed)
    return (
        base if i == 0 else mutate_genome(base, mutation_rate, seed=seed + 1000 + i)
        for i in range(n_strains)
    )


def _pairs_to_void(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) uint64 pairs -> void16 keys whose memcmp order is the
    numeric lexicographic order (big-endian fields)."""
    a = np.empty(len(hi), dtype=[("h", ">u8"), ("l", ">u8")])
    a["h"] = hi
    a["l"] = lo
    return a.view("V16").reshape(-1)


def _void_to_pairs(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    a = v.view([("h", ">u8"), ("l", ">u8")])
    return a["h"].astype(np.uint64), a["l"].astype(np.uint64)


def kmer_set_of_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Sorted unique canonical packed k-mers of one sequence.

    k <= 31: 1-D uint64; 31 < k <= 63: 1-D void16 keys (two-word packing).
    """
    if k <= 31:
        packed = dna.pack_kmers_u64(codes, k)
        return np.unique(dna.canonical_packed_u64(packed, k))
    hi, lo = dna.pack_kmers_2x64(codes, k)
    chi, clo = dna.canonical_packed_2x64(hi, lo, k)
    return np.unique(_pairs_to_void(chi, clo))


def kmer_multiset_of_walk_seqs(seqs: list[np.ndarray], k: int) -> np.ndarray:
    """Sorted canonical packed k-mers (with duplicates) over sequences."""
    if k <= 31:
        parts = [
            dna.canonical_packed_u64(dna.pack_kmers_u64(s, k), k)
            for s in seqs
            if len(s) >= k
        ]
        if not parts:
            return np.empty(0, dtype=np.uint64)
        return np.sort(np.concatenate(parts))
    parts = []
    for s in seqs:
        if len(s) < k:
            continue
        hi, lo = dna.pack_kmers_2x64(s, k)
        chi, clo = dna.canonical_packed_2x64(hi, lo, k)
        parts.append(_pairs_to_void(chi, clo))
    if not parts:
        return np.empty(0, dtype="V16")
    return np.sort(np.concatenate(parts))


def unitigs_from_kmers(kmers: np.ndarray, k: int) -> list[np.ndarray]:
    """Extract maximal unitigs from a canonical k-mer set.

    Returns a list of code arrays, one per unitig, canonical orientation
    (seq <= revcomp(seq) lexicographically on the packed form).
    k <= 31 takes the uint64 fast path; 31 < k <= 63 the two-word path.
    """
    if k > 31:
        return _unitigs_from_kmers_2x64(kmers, k)
    kmers = np.unique(kmers.astype(np.uint64))
    rc = dna.revcomp_packed_u64(kmers, k)
    oriented = np.unique(np.concatenate([kmers, rc]))  # all oriented k-mers
    n = len(oriented)
    mask = np.uint64((1 << (2 * k)) - 1)

    def find(vals: np.ndarray) -> np.ndarray:
        """Index into `oriented` or -1."""
        idx = np.searchsorted(oriented, vals)
        idx_c = np.clip(idx, 0, n - 1)
        ok = oriented[idx_c] == vals
        return np.where(ok, idx_c, -1).astype(np.int64)

    # Successor/predecessor degrees without materializing [n, 4] tables:
    # accumulate counts and the successor-index sum (the sum IS the unique
    # successor when out_deg == 1).
    # The nine lookups are independent and numpy's searchsorted releases
    # the GIL, so they run in threads.
    def succ(c: int) -> np.ndarray:
        return find(((oriented << np.uint64(2)) | np.uint64(c)) & mask)

    def pred(c: int) -> np.ndarray:
        return find((oriented >> np.uint64(2)) | (np.uint64(c) << np.uint64(2 * (k - 1))))

    with ThreadPoolExecutor(max_workers=min(4, os.cpu_count() or 1)) as pool:
        succs = [pool.submit(succ, c) for c in range(4)]
        preds = [pool.submit(pred, c) for c in range(4)]
        rc_job = pool.submit(lambda: find(dna.revcomp_packed_u64(oriented, k)))
        out_deg = np.zeros(n, dtype=np.uint8)
        in_deg = np.zeros(n, dtype=np.uint8)
        succ_sum = np.zeros(n, dtype=np.int64)
        for c in range(4):
            idx = succs[c].result()
            hit = idx >= 0
            out_deg += hit
            succ_sum += np.where(hit, idx, 0)
            in_deg += preds[c].result() >= 0
        rc_idx = rc_job.result()
    assert np.all(rc_idx >= 0)

    # Contracted edge i -> j: both are forced (out_deg[i] == 1,
    # in_deg[j] == 1) and j != rc(i) (BCALM2 palindrome rule: a unitig may
    # not contain a k-mer and its reverse complement).
    uniq_succ = np.where(out_deg == 1, succ_sum, -1)
    contracted = (
        (uniq_succ >= 0)
        & (in_deg[np.clip(uniq_succ, 0, n - 1)] == 1)
        & (uniq_succ != rc_idx)
    )
    nxt = np.where(contracted, uniq_succ, -1).astype(np.int64)
    has_contracted_in = np.zeros(n, dtype=bool)
    has_contracted_in[nxt[nxt >= 0]] = True
    starts = np.flatnonzero(~has_contracted_in).astype(np.int64)

    # Chain following (native C++).
    order, offsets = _follow_chains(n, nxt, starts)

    # Materialize sequences vectorized: chain = first kmer + one base per
    # further node; deduplicate reverse-complement twins.
    last_bases = (oriented[order] & np.uint64(3)).astype(np.uint8)
    shifts = np.uint64(2) * (np.uint64(k - 1) - np.arange(k, dtype=np.uint64))
    out: list[np.ndarray] = []
    seen: set[bytes] = set()
    prev = 0
    for end in offsets.tolist():
        first = oriented[order[prev]]
        head = ((first >> shifts) & np.uint64(3)).astype(np.uint8)
        arr = np.concatenate([head, last_bases[prev + 1 : end]])
        prev = end
        fwd = arr.tobytes()
        rc = dna.revcomp(arr)
        bwd = rc.tobytes()
        key = min(fwd, bwd)
        if key in seen:
            continue
        seen.add(key)
        out.append(arr if fwd <= bwd else rc)
    return out


def _unitigs_from_kmers_2x64(kmers: np.ndarray, k: int) -> list[np.ndarray]:
    """Two-word-packed unitig extraction for 31 < k <= 63 (same contraction
    rules as the uint64 path, incl. the BCALM2 palindrome stop)."""
    assert 31 < k <= 63
    k_lo, k_hi = 32, k - 32
    mask_hi = np.uint64((1 << (2 * k_hi)) - 1)
    kv = np.unique(np.asarray(kmers).view("V16").reshape(-1))
    hi, lo = _void_to_pairs(kv)
    rhi, rlo = dna.revcomp_packed_2x64(hi, lo, k)
    oriented_v = np.unique(
        np.concatenate([_pairs_to_void(hi, lo), _pairs_to_void(rhi, rlo)])
    )
    ohi, olo = _void_to_pairs(oriented_v)
    n = len(oriented_v)

    def find(vh: np.ndarray, vl: np.ndarray) -> np.ndarray:
        vv = _pairs_to_void(vh, vl)
        idx = np.searchsorted(oriented_v, vv)
        idx_c = np.clip(idx, 0, n - 1)
        ok = oriented_v[idx_c] == vv
        return np.where(ok, idx_c, -1).astype(np.int64)

    out_deg = np.zeros(n, dtype=np.uint8)
    in_deg = np.zeros(n, dtype=np.uint8)
    succ_sum = np.zeros(n, dtype=np.int64)
    two = np.uint64(2)
    for c in range(4):
        cc = np.uint64(c)
        # successor: shift left 2 within 2k bits, append base c
        sh = ((ohi << two) | (olo >> np.uint64(62))) & mask_hi
        sl = (olo << two) | cc
        idx = find(sh, sl)
        hit = idx >= 0
        out_deg += hit
        succ_sum += np.where(hit, idx, 0)
        # predecessor: shift right 2, prepend base c (at k = 32 hi holds no
        # base, so c lands in the top of lo)
        pl = (olo >> two) | ((ohi & np.uint64(3)) << np.uint64(62))
        if k_hi:
            ph = (ohi >> two) | (cc << np.uint64(2 * (k_hi - 1)))
        else:
            ph, pl = ohi, pl | (cc << np.uint64(62))
        in_deg += find(ph, pl) >= 0
    rc_ohi, rc_olo = dna.revcomp_packed_2x64(ohi, olo, k)
    rc_idx = find(rc_ohi, rc_olo)
    assert np.all(rc_idx >= 0)

    uniq_succ = np.where(out_deg == 1, succ_sum, -1)
    contracted = (
        (uniq_succ >= 0)
        & (in_deg[np.clip(uniq_succ, 0, n - 1)] == 1)
        & (uniq_succ != rc_idx)
    )
    nxt = np.where(contracted, uniq_succ, -1).astype(np.int64)
    has_in = np.zeros(n, dtype=bool)
    has_in[nxt[nxt >= 0]] = True
    starts = np.flatnonzero(~has_in).astype(np.int64)
    order, offsets = _follow_chains(n, nxt, starts)

    last_bases = (olo[order] & np.uint64(3)).astype(np.uint8)
    out: list[np.ndarray] = []
    seen: set[bytes] = set()
    prev = 0
    for end in offsets.tolist():
        fh, fl = int(ohi[order[prev]]), int(olo[order[prev]])
        head = np.empty(k, dtype=np.uint8)
        for j in range(k_hi):
            head[j] = (fh >> (2 * (k_hi - 1 - j))) & 3
        for j in range(k_lo):
            head[k_hi + j] = (fl >> (2 * (k_lo - 1 - j))) & 3
        arr = np.concatenate([head, last_bases[prev + 1 : end]])
        prev = end
        fwd = arr.tobytes()
        rc = dna.revcomp(arr)
        bwd = rc.tobytes()
        key = min(fwd, bwd)
        if key in seen:
            continue
        seen.add(key)
        out.append(arr if fwd <= bwd else rc)
    return out


def _follow_chains(n: int, nxt: np.ndarray, starts: np.ndarray):
    """(order, chain end offsets) via the native follow_chains."""
    from . import native

    lib = native.load()
    order = np.empty(n, dtype=np.int64)
    offsets = np.empty(n + 1, dtype=np.int64)
    p = native.as_ll_ptr
    n_chains = lib.follow_chains(
        n, p(np.ascontiguousarray(nxt)), len(starts),
        p(np.ascontiguousarray(starts)), p(order), p(offsets),
    )
    return order, offsets[:n_chains]


# -- the torch generator (k <= 63) ------------------------------------------
#
# Packed k-mers are int64 words.  For k <= 31 one word of 62 bits, so int64
# keeps uint64's order, and torch's coverage of uint64 is thin.  For
# 31 < k <= 63 two words, as numpy's two-word packing has them: hi holds the
# first k - 32 bases (at most 62 bits) and lo the last 32 (all 64 bits), so
# lo is compared with its bit 63 flipped (``_SIGN``), which makes int64's
# order uint64's, and masked after each right shift.  Keys cross the API as
# int64 ``[n]`` (k <= 31) or ``[n, 2]`` (hi, lo) tensors, and travel inside
# as tuples of their words.  Every step is a sort, a search, a gather or a
# scan, so the whole extraction runs on the device.

_SIGN = -(1 << 63)

# masks that swap ever wider groups of a 64-bit word; each leaves the top
# bits of its right-shifted half clear, so the sign bits an arithmetic
# shift brings in are dropped
_SWAP_MASKS = (
    (2, 0x3333333333333333),
    (4, 0x0F0F0F0F0F0F0F0F),
    (8, 0x00FF00FF00FF00FF),
    (16, 0x0000FFFF0000FFFF),
    (32, 0x00000000FFFFFFFF),
)


def _words(keys: torch.Tensor, k: int) -> tuple:
    """A key tensor as its words: ``(keys,)`` for k <= 31, ``(hi, lo)`` for
    31 < k <= 63."""
    if not 1 <= k <= 63:
        raise ValueError(f"the torch generator covers k <= 63, not k={k}")
    shape = (-1,) if k <= 31 else (-1, 2)
    if keys.dim() != len(shape) or (k > 31 and keys.shape[1] != 2):
        raise ValueError(f"k={k} takes int64 keys of shape {shape}, not {tuple(keys.shape)}")
    return (keys,) if k <= 31 else (keys[:, 0].contiguous(), keys[:, 1].contiguous())


def _tensor(words: tuple) -> torch.Tensor:
    return words[0] if len(words) == 1 else torch.stack(words, 1)


def _base_slot(b: int, k: int) -> tuple[int, int]:
    """(word, shift) of base ``b`` of a packed k-mer, first base most
    significant."""
    shift = 2 * (k - 1 - b)
    if k <= 31:
        return 0, shift
    return (0, shift - 64) if shift >= 64 else (1, shift)


def _reverse_groups(x: torch.Tensor) -> torch.Tensor:
    """The 32 2-bit groups of each int64 word in reverse order."""
    for shift, mask in _SWAP_MASKS:
        x = ((x >> shift) & mask) | ((x & mask) << shift)
    return x


def _revcomp_words(words: tuple, k: int) -> tuple:
    """Reverse complements of packed k-mers: the codes complemented, each
    word's 32 2-bit groups reversed, then the k codes shifted down."""
    if len(words) == 1:
        full = (1 << (2 * k)) - 1
        return ((_reverse_groups(words[0] ^ full) >> (2 * (32 - k))) & full,)
    hi, lo = words
    k_hi = k - 32
    top = _reverse_groups(~lo)  # the first 32 bases of the reverse complement
    if k_hi == 0:
        return torch.zeros_like(top), top
    mask = (1 << (2 * k_hi)) - 1
    bottom = _reverse_groups(hi ^ mask)  # its last k - 32, at the word's top
    shift = 64 - 2 * k_hi
    return (top >> shift) & mask, ((bottom >> shift) & mask) | (top << (2 * k_hi))


def canonical_kmers_torch(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical packed k-mer (k <= 63) of every window of ``codes``, in
    order: each window and its reverse complement packed by k shifts."""
    n = max(0, len(codes) - k + 1)
    c = codes.to(torch.int64)
    shape = (1 if k <= 31 else 2, n)
    fwd = torch.zeros(shape, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        window = c[j:j + n]
        word, shift = _base_slot(j, k)
        fwd[word] |= window << shift
        word, shift = _base_slot(k - 1 - j, k)
        rc[word] |= (3 - window) << shift
    if k <= 31:
        return torch.minimum(fwd[0], rc[0])
    take_rc = (rc[0] < fwd[0]) | ((rc[0] == fwd[0]) & ((rc[1] ^ _SIGN) < (fwd[1] ^ _SIGN)))
    return torch.where(take_rc, rc, fwd).T.contiguous()


def _sorted_unique(words: tuple) -> tuple:
    """The distinct keys in ascending order (lo words as unsigned)."""
    if len(words) == 1:
        return (torch.unique(words[0]),)
    hi, lo = words
    order = torch.argsort(lo ^ _SIGN, stable=True)
    order = order[torch.argsort(hi[order], stable=True)]
    hi, lo = hi[order], lo[order]
    del order
    new = torch.ones(len(hi), dtype=torch.bool, device=hi.device)
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    return hi[new], lo[new]


def sorted_unique_kmers(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The distinct packed k-mers of ``keys`` (int64 ``[n]`` or ``[n, 2]``)
    in numpy's order (uint64 values, or the big-endian void16 keys)."""
    return _tensor(_sorted_unique(_words(keys, k)))


def kmer_set_torch(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Sorted unique canonical packed k-mers of one sequence's codes (the
    torch form of `kmer_set_of_codes`, k <= 63)."""
    return sorted_unique_kmers(canonical_kmers_torch(codes, k), k)


def kmers_to_numpy(keys: torch.Tensor) -> np.ndarray:
    """Torch keys as numpy's: uint64 ``[n]``, or void16 (hi, lo) keys."""
    a = keys.cpu().numpy().view(np.uint64)
    return a if a.ndim == 1 else _pairs_to_void(a[:, 0], a[:, 1])


def kmers_to_torch(kmers: np.ndarray) -> torch.Tensor:
    """Numpy keys (uint64, or void16 for 31 < k <= 63) as the torch
    generator's int64 ``[n]`` or ``[n, 2]`` (hi, lo)."""
    if kmers.dtype == np.dtype("V16"):
        return torch.from_numpy(np.stack(_void_to_pairs(kmers), 1).view(np.int64))
    return torch.from_numpy(np.ascontiguousarray(kmers, np.uint64).view(np.int64))


def spelled_kmers_torch(store: SequenceStore, k: int, device) -> torch.Tensor:
    """Canonical packed k-mers of every sequence in ``store``, with repeats,
    on ``device`` (k <= 63; the host takes tens of seconds for a 10 Mbp
    pangenome's tigs): the windows of the concatenated codes that lie
    inside one sequence."""
    kmers = canonical_kmers_torch(torch.from_numpy(store.codes).to(device), k)
    offsets = torch.from_numpy(store.offsets).to(device, torch.int64)
    start = torch.arange(len(kmers), device=device)
    seq = torch.searchsorted(offsets, start, right=True) - 1
    return kmers[start + k <= offsets[seq + 1]]


def pangenome_on_device(strains, k: int, device: torch.device):
    """(kmers, codes uint8, offsets int64) as numpy arrays: the merged
    canonical k-mer set of the strains (numpy code arrays, uploaded one at a
    time; uint64 or void16 keys, as `kmer_set_of_codes` gives them) and its
    unitigs as a flat arena, both built on ``device``."""
    parts = [kmer_set_torch(torch.from_numpy(np.ascontiguousarray(s)).to(device), k)
             for s in strains]
    kmers = sorted_unique_kmers(torch.cat(parts), k)
    del parts
    codes, offsets = unitig_codes_from_kmers(kmers, k)
    return kmers_to_numpy(kmers), codes.cpu().numpy(), offsets.cpu().numpy()


def _search(keys: tuple, queries: tuple, right: bool = False) -> torch.Tensor:
    """Per query, the index of the first of the sorted unique ``keys`` not
    below it (or, ``right``, above it).  Two words: the run of keys with
    the query's hi, then a binary search on lo inside it."""
    if len(keys) == 1:
        return torch.searchsorted(keys[0], queries[0], right=right)
    hi, lo = keys
    left = torch.searchsorted(hi, queries[0])
    end = torch.searchsorted(hi, queries[0], right=True)
    steps = int((end - left).max()).bit_length() if len(left) else 0
    slo, qlo = lo ^ _SIGN, queries[1] ^ _SIGN
    for _ in range(steps):
        live = left < end
        mid = (left + end) >> 1
        at = slo[mid.clamp(max=len(slo) - 1)]
        up = live & ((at <= qlo) if right else (at < qlo))
        left = torch.where(up, mid + 1, left)
        end = torch.where(live & ~up, mid, end)
    return left


def _successor_base(words: tuple, k: int) -> tuple:
    """x's last k - 1 bases followed by A: the least of x's possible
    successors, which run from it to it | 3."""
    if len(words) == 1:
        return ((words[0] << 2) & ((1 << (2 * k)) - 1),)
    hi, lo = words
    mask = (1 << (2 * (k - 32))) - 1  # 0 at k = 32: hi holds no base
    return ((hi << 2) | ((lo >> 62) & 3)) & mask, lo << 2


def _list_rank(prv: torch.Tensor):
    """Pointer jumping over ``prv`` (the unique predecessor or -1; in-degree
    at most 1, so the nodes form disjoint paths and cycles): (p, r, m) with,
    for a path node, p its path's head and r its distance from it; for a
    cycle node, p another node of its cycle and m the cycle's smallest
    index.  Each round doubles the window; the rounds stop when p stops
    moving (every path converged and every cycle's length divides the
    window) or once the window covers every node."""
    n = len(prv)
    idx = torch.arange(n, device=prv.device)
    has = prv >= 0
    p = torch.where(has, prv, idx)
    r = has.to(torch.int64)
    m = idx
    for _ in range(max(1, n.bit_length())):
        m = torch.minimum(m, m[p])
        r = r + r[p]
        p_next = p[p]
        if torch.equal(p_next, p):
            break
        p = p_next
    return p, r, m


def unitig_codes_from_kmers(kmers: torch.Tensor, k: int):
    """The torch form of `unitigs_from_kmers` (k <= 63): (codes uint8, base
    offsets int64 with a leading 0) of the maximal unitigs of a canonical
    packed k-mer set (int64 ``[n]`` for k <= 31, ``[n, 2]`` (hi, lo) words
    above), on its device, in the numpy path's order and orientation: the
    chains from the starts by start index, then the isolated cycles by their
    smallest index, each walked from it (as the native ``follow_chains``);
    the first of each {chain, reverse-complement twin} pair kept, in its
    lexicographically smaller orientation.

    Each intermediate is dropped once spent: at 60 Mbp each per-k-mer array
    is 2.4 GB of the device."""
    words = _words(kmers, k)
    dev = kmers.device
    oriented = _sorted_unique(tuple(torch.cat(w) for w in zip(words, _revcomp_words(words, k))))
    del words
    n = len(oriented[0])
    if n >= 1 << 30:
        raise ValueError(f"{n} oriented k-mers exceed the chain key's 2^30")
    if n == 0:
        return (torch.empty(0, dtype=torch.uint8, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev))

    # The successors of x are the set's keys from base to base | 3, base =
    # x's last k-1 bases followed by A: one contiguous run of the sorted
    # set.  A predecessor of x is the reverse complement of a successor of
    # rc(x), so in_deg(x) = out_deg(rc(x)).
    base = _successor_base(oriented, k)
    first_succ = _search(oriented, base)
    out_deg = _search(oriented, (*base[:-1], base[-1] | 3), right=True) - first_succ
    del base
    rc_vals = _revcomp_words(oriented, k)
    rc_idx = _search(oriented, rc_vals)
    found = (w[rc_idx.clamp(max=n - 1)] for w in oriented)
    if not all(torch.equal(a, b) for a, b in zip(found, rc_vals)):
        raise RuntimeError("the oriented k-mer set is not closed under reverse complement")
    del rc_vals
    in_deg = out_deg[rc_idx]

    # Contracted edge i -> j: both forced and j != rc(i) (the BCALM2
    # palindrome stop); j's one predecessor is then i.
    contracted = (out_deg == 1) & (in_deg[first_succ.clamp(max=n - 1)] == 1)
    contracted &= first_succ != rc_idx
    del out_deg, in_deg
    nodes = torch.arange(n, device=dev)
    nxt = torch.where(contracted, first_succ, -1)
    prv = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prv[nxt[contracted]] = nodes[contracted]
    del first_succ, contracted

    # Chain order: (isolated cycle, head, rank).  A cycle is cut in front
    # of its smallest node, which then heads it.
    head, rank, low = _list_rank(prv)
    cycle = prv[head] >= 0
    if bool(cycle.any()):
        cut = prv.clone()
        cut[cycle & (low == nodes)] = -1
        head, rank, _ = _list_rank(cut)
        del cut
    del prv, low
    order = torch.argsort((cycle.to(torch.int64) << 60) | (head << 30) | rank)
    del rank
    head_sorted = head[order]
    new_chain = torch.ones(n, dtype=torch.bool, device=dev)
    new_chain[1:] = head_sorted[1:] != head_sorted[:-1]
    chain_start = torch.nonzero(new_chain).flatten()
    chain_end = torch.cat([chain_start[1:], torch.tensor([n], device=dev)])
    chain_of = torch.empty(n, dtype=torch.int64, device=dev)
    chain_of[order] = torch.cumsum(new_chain, 0) - 1
    del head, head_sorted, new_chain

    # Twin dedupe: chain c spells the reverse complement of the chain t that
    # starts at rc(last(c)).  The numpy loop drops c iff t came first (a
    # cycle's twin starts at its own smallest node, so it matches only when
    # that node is rc(last(c))); a chain that is its own twin is kept.
    chains = torch.arange(len(chain_start), device=dev)
    rc_last = rc_idx[order[chain_end - 1]]
    twin = chain_of[rc_last]
    keep = (twin >= chains) | (order[chain_start[twin]] != rc_last)
    del rc_idx, chain_of, rc_last, twin, chains
    kept_start, kept_nodes = chain_start[keep], (chain_end - chain_start)[keep]
    del chain_start, chain_end, keep

    # Materialize: the first k-mer's k bases, then each further node's last
    # base; then each chain in its smaller orientation over the codes.
    lengths = kept_nodes + (k - 1)
    offsets = torch.zeros(len(lengths) + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lengths, 0, out=offsets[1:])
    total = int(offsets[-1])
    seq = torch.repeat_interleave(torch.arange(len(lengths), device=dev), lengths,
                                  output_size=total)
    pos = torch.arange(total, device=dev) - offsets[seq]
    start = kept_start[seq]
    node = order[start + (pos - (k - 1)).clamp(min=0)]
    shift = (2 * (k - 1 - pos)).clamp(min=0)
    if len(oriented) == 1:
        fwd = oriented[0][node] >> shift
    else:  # the head k-mer's first k - 32 bases lie in hi
        fwd = torch.where(shift >= 64, oriented[0][node] >> (shift - 64).clamp(min=0),
                          oriented[1][node] >> shift.clamp(max=62))
    fwd = (fwd & 3).to(torch.uint8)
    del node, shift, start, order, oriented
    bwd = 3 - fwd[offsets[seq] + lengths[seq] - 1 - pos]  # the reverse complement
    del pos
    # the first position where a chain and its reverse complement differ
    # (none: a palindrome, kept forward)
    big = torch.iinfo(torch.int64).max
    first_diff = torch.full((len(lengths),), big, dtype=torch.int64, device=dev)
    first_diff.scatter_reduce_(
        0, seq, torch.where(fwd != bwd, torch.arange(total, device=dev), big), "amin"
    )
    at = first_diff.clamp(max=total - 1)
    flip = (first_diff != big) & (bwd[at] < fwd[at])
    return torch.where(flip[seq], bwd, fwd), offsets


def ball_graph(ball: int, fanout: int) -> tuple[int, np.ndarray, np.ndarray, int]:
    """(n_nodes, nbr, nw, max_weight): a padded adjacency with four slots
    per row whose node 0 has a ball of exactly ``ball`` nodes at the bound
    ``max_weight``.  Nodes 0..ball-1 form a tree (node i's children
    fanout*i+1 .. fanout*i+fanout, edge weight 1 + child % 3), and three
    more nodes hang in a chain off the deepest tree node, at max_weight + 1
    and beyond.  Every other node's ball is a subtree (or part of the
    chain), so the sources 0..n_nodes give balls of many sizes."""
    if not 1 <= fanout <= 3 or ball < 1:
        raise ValueError("ball >= 1 and 1 <= fanout <= 3")
    n, deg = ball + 3, 4
    nbr = np.full((n + 1, deg), n, np.int32)
    nw = np.full((n + 1, deg), 1 << 20, np.int32)
    dist = np.zeros(ball, np.int64)
    for child in range(1, ball):
        parent, slot = divmod(child - 1, fanout)
        nbr[parent, slot], nw[parent, slot] = child, 1 + child % 3
        dist[child] = dist[parent] + 1 + child % 3
    deepest = int(np.argmax(dist))
    nbr[deepest, fanout], nw[deepest, fanout] = ball, 1
    for j in (ball, ball + 1):
        nbr[j, 0], nw[j, 0] = j + 1, 1
    return n, nbr, nw, int(dist.max())


def capi_merges(g) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The topology of ``g`` as ``TigGraphBuilder.merge_nodes`` calls:
    columns (unitig_a, strand_a, unitig_b, strand_b), one row per in-edge x
    out-edge pair at each node v with v <= mirror(v) (the pairs at mirror(v)
    are their mirrors, which each call merges too), nodes ascending, then
    in-edges, then out-edges in CSR order."""
    return _in_out_pairs(g, np.flatnonzero(np.arange(g.n_nodes) <= g.mirror_node))


def graph_links(g) -> Links:
    """The links a BCALM2 or GFA file declares for the unitigs of ``g``:
    one row (a, sa, b, sb) per in-edge x out-edge pair at every node, nodes
    ascending, then in-edges, then out-edges in CSR order (the order of a
    loop over ``in_edges_of(v)`` and ``out_edges_of(v)``)."""
    a, sa, b, sb = _in_out_pairs(g, np.arange(g.n_nodes))
    return Links(a=a.astype(np.int64), sa=sa.astype(bool), b=b.astype(np.int64),
                 sb=sb.astype(bool))


def _in_out_pairs(g, nodes: np.ndarray) -> tuple:
    """(handle, forward) of the in-edge and of the out-edge of every
    in-edge x out-edge pair at ``nodes``, in the order of capi_merges."""
    out_off, out_edges, in_off, in_edges = g.csr()
    n_in = (in_off[nodes + 1] - in_off[nodes]).astype(np.int64)
    n_out = (out_off[nodes + 1] - out_off[nodes]).astype(np.int64)
    count = n_in * n_out
    row_node = np.repeat(np.arange(len(nodes)), count)
    local = np.arange(int(count.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(count) - count, count
    )
    i, o = np.divmod(local, np.maximum(n_out, 1)[row_node])
    ei = in_edges[in_off[nodes][row_node] + i]
    eo = out_edges[out_off[nodes][row_node] + o]
    handles, forwards = np.asarray(g.handles()), np.asarray(g.forwards())
    return handles[ei], forwards[ei], handles[eo], forwards[eo]


def same_graph_up_to_node_ids(g1, g2) -> bool:
    """Whether two graphs that hold one biedge pair per unitig, in store
    order, are the same graph but for their node numbering: equal edge
    weights, handles and orientations, one consistent bijection from g1's
    endpoint nodes onto g2's, and that bijection commutes with
    ``mirror_node``."""
    if (g1.n_nodes, g1.n_edges) != (g2.n_nodes, g2.n_edges):
        return False
    if not all(np.array_equal(getattr(g1, f)(), getattr(g2, f)())
               for f in ("weights", "handles", "forwards")):
        return False
    x = np.concatenate([g1.srcs(), g1.dsts()]).astype(np.int64)
    y = np.concatenate([g2.srcs(), g2.dsts()]).astype(np.int64)
    f = np.full(g1.n_nodes, -1, np.int64)
    f[x] = y
    inv = np.full(g2.n_nodes, -1, np.int64)
    inv[y] = x
    return bool(np.array_equal(f[x], y) and np.array_equal(inv[y], x)
                and (f >= 0).all() and (inv >= 0).all()
                and np.array_equal(f[g1.mirror_node], g2.mirror_node[f]))


def split_linkless_nodes(g) -> Bigraph:
    """``g`` (one biedge pair per unitig, in store order) as the links of
    its unitigs can state it.  A link pairs an in-edge with an out-edge at
    a node, so a node with no in-edge or no out-edge (two unitigs that end
    in the same (k-1)-mer and go on nowhere) is named by no link: each edge
    end at it becomes a node of its own, and so do the ends at its mirror.
    Nodes are numbered in order of the lowest endpoint slot that meets
    them, as ``build_bigraph_from_links`` numbers its nodes; the edges keep
    their weights, handles and orientations."""
    src, dst = g.srcs().astype(np.int64), g.dsts().astype(np.int64)
    n_uni = g.n_edges // 2
    linked = (np.bincount(src, minlength=g.n_nodes) > 0) & (
        np.bincount(dst, minlength=g.n_nodes) > 0)
    # endpoint slots of unitig u, as build_bigraph_from_links numbers them: the
    # forward edge's source, its mirror's target, the forward edge's
    # target, its mirror's source
    ends = np.stack([src[0::2], dst[1::2], dst[0::2], src[1::2]], axis=1).reshape(-1)
    key = np.where(linked[ends], ends, g.n_nodes + np.arange(len(ends)))
    _, first, slot_key = np.unique(key, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    node = rank[slot_key].reshape(n_uni, 4)
    mirror = np.empty(len(first), np.int32)
    mirror[node[:, 0]], mirror[node[:, 1]] = node[:, 1], node[:, 0]
    mirror[node[:, 2]], mirror[node[:, 3]] = node[:, 3], node[:, 2]
    out = Bigraph(len(first), mirror)
    out.add_biedge_pairs(src=node[:, 0].astype(np.int32), dst=node[:, 2].astype(np.int32),
                         weight=g.weights()[0::2], handle=g.handles()[0::2],
                         forward=g.forwards()[0::2], dummy_id=g.dummy_ids()[0::2])
    return out


# byte x of the 2-bit arena -> its 4 bases as ASCII, first base first
_PACKED_ASCII = np.frombuffer(b"ACGT", np.uint8)[
    (np.arange(256)[:, None] >> (2 * np.arange(4))) & 3
]


def _digits(v: np.ndarray) -> np.ndarray:
    """Decimal digit count of each non-negative int64."""
    nd = np.ones(len(v), np.int64)
    p = 10
    while p <= int(v.max(initial=0)):
        nd += v >= p
        p *= 10
    return nd


def _format_rows(fields: list, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Bytes of ``n`` rows, row i the concatenation of each field's i-th
    value: a bytes field is the same in every row, a bool column gives "+"
    or "-", an integer column its decimal digits.  Returns (buffer, row
    offsets [n + 1]): the fields side by side in one [n, width] byte matrix,
    compressed by one boolean mask of the bytes each row uses."""
    blocks, used = [], []
    for fld in fields:
        if isinstance(fld, bytes):
            blocks.append(np.broadcast_to(np.frombuffer(fld, np.uint8), (n, len(fld))))
            used.append(np.ones((n, len(fld)), bool))
        elif np.asarray(fld).dtype == bool:
            blocks.append(np.where(fld, ord("+"), ord("-")).astype(np.uint8)[:, None])
            used.append(np.ones((n, 1), bool))
        else:
            # right-aligned digits; the columns left of each number are unused
            v = np.array(fld, np.int64)
            nd = _digits(v)
            width = int(nd.max(initial=1))
            block = np.empty((n, width), np.uint8)
            for j in range(width - 1, -1, -1):
                v, block[:, j] = np.divmod(v, 10)
            blocks.append(block + np.uint8(48))
            used.append(np.arange(width) >= width - nd[:, None])
    used = np.concatenate(used, axis=1)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(used.sum(1), out=off[1:])
    return np.concatenate(blocks, axis=1)[used], off


def _join_records(store: SequenceStore, parts: list, tail: bytes) -> np.ndarray:
    """Bytes of one record per unitig, in store order: record i is each
    part's i-th piece, then the unitig's bases, then ``tail``.  A part is a
    bytes literal (the same in every record) or a ragged (buffer, offsets
    [n + 1]) pair.  Each piece is placed through one byte per output byte
    naming the piece it belongs to."""
    n = len(store)

    def literal(b: bytes):
        return np.tile(np.frombuffer(b, np.uint8), n), np.full(n, len(b), np.int64)

    pieces = [literal(p) if isinstance(p, bytes) else (p[0][p[1][0]:p[1][-1]], np.diff(p[1]))
              for p in parts]
    bases = _PACKED_ASCII[store.packed].reshape(-1)[: int(store.offsets[-1])]
    pieces += [(bases, store.lengths), literal(tail)]
    widths = np.stack([w for _, w in pieces], axis=1)  # [n, pieces]
    owner = np.repeat(np.tile(np.arange(len(pieces), dtype=np.uint8), n),
                      widths.reshape(-1))
    out = np.empty(len(owner), np.uint8)
    for i, (buf, _) in enumerate(pieces):
        out[owner == i] = buf
    return out


def _open_for_write(path):
    """``path`` opened for bytes, gzipped (level 1) when it ends in .gz."""
    import gzip

    if str(path).endswith(".gz"):
        return gzip.open(path, "wb", compresslevel=1)
    return open(path, "wb")


def write_fasta(path, store: SequenceStore) -> None:
    """``store`` as plain fasta, record i (store order) headed ``>i``, its
    sequence on one line.  Gzipped when ``path`` ends in .gz.  Built over
    whole columns: no loop over unitigs."""
    n = len(store)
    body = _join_records(store, [_format_rows([b">", np.arange(n), b"\n"], n)], b"\n")
    with _open_for_write(path) as f:
        f.write(memoryview(body))


def write_bcalm2(path, store: SequenceStore, links: Links) -> None:
    """``store`` as BCALM2 writes unitigs: record i (store order) headed
    ``>i LN:i:<len> KC:i:1 km:f:1.0`` followed by one ``L:<sa>:<b>:<sb>``
    tag per link with a = i (in ``links``' order), each after a space, its
    sequence on one line.  Gzipped when ``path`` ends in .gz.  Built over
    whole columns: no loop over unitigs or links."""
    n = len(store)
    head = _format_rows([b">", np.arange(n), b" LN:i:", store.lengths,
                         b" KC:i:1 km:f:1.0"], n)
    order = np.argsort(links.a, kind="stable")
    tags, tag_off = _format_rows([b" L:", links.sa[order], b":", links.b[order],
                                  b":", links.sb[order]], len(order))
    first = np.searchsorted(links.a[order], np.arange(n + 1))
    body = _join_records(store, [head, (tags, tag_off[first]), b"\n"], b"\n")
    with _open_for_write(path) as f:
        f.write(memoryview(body))


def write_gfa(path, store: SequenceStore, links: Links, k: int) -> None:
    """``store`` and ``links`` as GFA1 with numeric segment names, as GGCAT
    writes them: a header line with ``KL:Z:<k>``, one ``S`` line per
    unitig (names 0..n-1, store order), then one ``L`` line per link with
    a ``<k-1>M`` overlap, in ``links``' order.  Gzipped when ``path`` ends
    in .gz.  Built over whole columns: no loop over unitigs or links."""
    n = len(store)
    segs = _join_records(store, [_format_rows([b"S\t", np.arange(n), b"\t"], n)], b"\n")
    lines, _ = _format_rows([b"L\t", links.a, b"\t", links.sa, b"\t", links.b, b"\t",
                             links.sb, b"\t%dM\n" % (k - 1)], len(links))
    with _open_for_write(path) as f:
        f.write(b"H\tVN:Z:1.0\tKL:Z:%d\n" % k)
        f.write(memoryview(segs))
        f.write(memoryview(lines))


def make_unitig_store(
    genome_length: int = 20000, k: int = 15, seed: int = 0, n_sequences: int = 1
) -> tuple[SequenceStore, np.ndarray, int]:
    """Random genome(s) -> (unitig SequenceStore, canonical kmer set, k)."""
    kmer_parts = []
    for i in range(n_sequences):
        genome = random_genome(genome_length, seed=seed + i)
        kmer_parts.append(kmer_set_of_codes(genome, k))
    kmers = np.unique(np.concatenate(kmer_parts))
    unitigs = unitigs_from_kmers(kmers, k)
    store = SequenceStore()
    for u in unitigs:
        store.add(u)
    store.finalize()
    return store, kmers, k


def spelled_kmers(
    g: Bigraph, tigs: list[np.ndarray], store: SequenceStore, k: int
) -> np.ndarray:
    """Sorted canonical k-mer multiset spelled by the tigs."""
    from .io.writers import spell_walk

    seqs = [spell_walk(g, t, store, k) for t in tigs]
    return kmer_multiset_of_walk_seqs(seqs, k)


def assert_tigs_spell_kmer_set(
    g: Bigraph,
    tigs: list[np.ndarray],
    store: SequenceStore,
    k: int,
    kmers: np.ndarray,
    allow_duplicates: bool,
) -> None:
    got = spelled_kmers(g, tigs, store, k)
    got_set = np.unique(got)
    expected = (
        np.unique(kmers.astype(np.uint64))
        if k <= 31
        else np.unique(np.asarray(kmers).view("V16").reshape(-1))
    )
    assert got_set.shape == expected.shape and np.all(got_set == expected), (
        f"spelled kmer set mismatch: got {len(got_set)} expected {len(expected)}"
    )
    if not allow_duplicates:
        assert len(got) == len(expected), (
            f"duplicate kmers spelled: {len(got)} vs {len(expected)} unique"
        )


def make_unitig_store_strings(
    genome_length: int, k: int, seed: int = 0, n_sequences: int = 2
) -> tuple["SequenceStore", set, int]:
    """Arbitrary-k unitig generator over python string k-mers (slow; for
    tiny end-to-end tests in the k > 63 band where the packed-integer
    generators do not reach).  Returns (store, canonical kmer string set, k).
    """
    from .utils import dna

    def canon(s: str) -> str:
        rc = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        return min(s, rc)

    kmers: set[str] = set()
    for i in range(n_sequences):
        genome = dna.decode_to_ascii(random_genome(genome_length, seed=seed + i)).decode()
        for j in range(len(genome) - k + 1):
            kmers.add(canon(genome[j : j + k]))

    # maximal unitigs: follow unique successors over the bidirected kmer graph
    def succs(s: str):
        for c in "ACGT":
            nxt = s[1:] + c
            if canon(nxt) in kmers:
                yield nxt

    def preds(s: str):
        for c in "ACGT":
            prv = c + s[:-1]
            if canon(prv) in kmers:
                yield prv

    def rc(s: str) -> str:
        return s[::-1].translate(str.maketrans("ACGT", "TGCA"))

    visited: set[str] = set()
    unitigs: list[str] = []
    for km in sorted(kmers):
        if km in visited:
            continue
        # extend forward and backward while the chain is unbranched
        chain = [km]
        cur = km
        while True:
            ss = list(succs(cur))
            if len(ss) != 1:
                break
            nxt = ss[0]
            if canon(nxt) in visited or canon(nxt) == canon(km):
                break
            if len(list(preds(nxt))) != 1:
                break
            chain.append(nxt)
            visited.add(canon(nxt))
            cur = nxt
        cur = km
        while True:
            pp = list(preds(cur))
            if len(pp) != 1:
                break
            prv = pp[0]
            if canon(prv) in visited or canon(prv) == canon(km):
                break
            if len(list(succs(prv))) != 1:
                break
            chain.insert(0, prv)
            visited.add(canon(prv))
            cur = prv
        visited.add(canon(km))
        seq = chain[0] + "".join(s[-1] for s in chain[1:])
        unitigs.append(seq)

    store = SequenceStore()
    for u in unitigs:
        store.add_ascii(u.encode())
    store.finalize()
    return store, kmers, k


def assert_tigs_spell_kmer_strings(
    g: Bigraph,
    tigs: list[np.ndarray],
    store: SequenceStore,
    k: int,
    kmers: set[str],
) -> None:
    """Any-k form of :func:`assert_tigs_spell_kmer_set` over the canonical
    k-mer string set of :func:`make_unitig_store_strings`."""
    from .io.writers import spell_walk

    def canon(s: str) -> str:
        return min(s, s[::-1].translate(str.maketrans("ACGT", "TGCA")))

    got: set[str] = set()
    for t in tigs:
        seq = dna.decode_to_ascii(spell_walk(g, t, store, k)).decode()
        got.update(canon(seq[j : j + k]) for j in range(len(seq) - k + 1))
    assert got == kmers, (
        f"spelled kmer set mismatch: got {len(got)} expected {len(kmers)}"
    )
