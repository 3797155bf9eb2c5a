"""The benchmark's traffic generator: a synthetic pangenome's unitigs.

A frozen copy of ``matchtigs_tpu_torch.testing.make_pangenome_store``'s
device path for k <= 63: one 64-bit word per k-mer for k <= 31, two
(hi, lo) words for 31 < k <= 63, so that a change to the program cannot
change what the benchmark feeds it.  The genomes are drawn by numpy on
the host from the seed; the k-mer sets and the maximal unitigs are built
with torch on the given device.  The output is the flat unitig arena
(codes uint8 in 0..3, base offsets int64 with a leading 0) and the sorted
canonical k-mer set, bit-identical to the program's generator at the same
parameters.

The module imports nothing of the program.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch

# ---------------------------------------------------------------- genomes


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
    """Random genome with interspersed diverged repeat families and tandem
    satellite arrays, the dense tangles where bounded searches expand
    large balls."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=length, dtype=np.uint8)
    families = [
        rng.integers(0, 4, size=repeat_len, dtype=np.uint8)
        for _ in range(n_families)
    ]
    for fam in families:
        positions = rng.integers(0, length - repeat_len, size=copies_per_family)
        for pos in positions:
            copy = fam.copy()
            muts = np.flatnonzero(rng.random(repeat_len) < divergence)
            copy[muts] = (
                copy[muts] + rng.integers(1, 4, size=len(muts), dtype=np.uint8)
            ) % 4
            genome[pos : pos + repeat_len] = copy
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
    """Substitution-mutated copy of a genome (a strain)."""
    rng = np.random.default_rng(seed)
    out = genome.copy()
    pos = np.flatnonzero(rng.random(len(genome)) < rate)
    out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos), dtype=np.uint8)) % 4
    return out


def pangenome_strains(genome_length: int, n_strains: int, mutation_rate: float,
                      seed: int, with_repeats: bool):
    """The strains' code arrays, one at a time: the base genome, then its
    mutated copies."""
    if with_repeats:
        base = random_genome_with_repeats(
            genome_length, seed=seed,
            copies_per_family=max(20, genome_length // 25000),
        )
    else:
        base = random_genome(genome_length, seed=seed)
    return (
        base if i == 0 else mutate_genome(base, mutation_rate, seed=seed + 1000 + i)
        for i in range(n_strains)
    )


# ------------------------------------------------- k-mer sets and unitigs
#
# Packed k-mers are int64 words.  For k <= 31 one word of 62 bits, so int64
# keeps uint64's order.  For 31 < k <= 63 two words: hi holds the first
# k - 32 bases (at most 62 bits) and lo the last 32 (all 64 bits), so lo is
# compared with its bit 63 flipped (``_SIGN``), which makes int64's order
# uint64's, and masked after each right shift.  Keys cross the API as int64
# ``[n]`` (k <= 31) or ``[n, 2]`` (hi, lo) tensors, and travel inside as
# tuples of their words.

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


def _check_k(k: int) -> None:
    if not 1 <= k <= 63:
        raise ValueError(f"the benchmark's generator covers k <= 63, not k={k}")


def _words(keys: torch.Tensor, k: int) -> tuple:
    """A key tensor as its words: ``(keys,)`` for k <= 31, ``(hi, lo)`` for
    31 < k <= 63."""
    _check_k(k)
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


def canonical_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical packed k-mer of every window of ``codes``, in order: each
    window and its reverse complement packed by k shifts."""
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
    in ascending order (uint64 values, or the big-endian 16-byte keys)."""
    return _tensor(_sorted_unique(_words(keys, k)))


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
    """Pointer jumping over ``prv`` (the unique predecessor or -1): (p, r,
    m) with, for a path node, p its path's head and r its distance from it;
    for a cycle node, p another node of its cycle and m the cycle's
    smallest index."""
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
    """(codes uint8, base offsets int64 with a leading 0) of the maximal
    unitigs of a sorted canonical k-mer set (int64 ``[n]`` for k <= 31,
    ``[n, 2]`` (hi, lo) above), on its device: the chains from the starts
    by start index, then the isolated cycles by their smallest index; the
    first of each {chain, reverse-complement twin} pair kept, in its
    lexicographically smaller orientation."""
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
    # x's last k-1 bases followed by A; in_deg(x) = out_deg(rc(x)).
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

    contracted = (out_deg == 1) & (in_deg[first_succ.clamp(max=n - 1)] == 1)
    contracted &= first_succ != rc_idx
    del out_deg, in_deg
    nodes = torch.arange(n, device=dev)
    nxt = torch.where(contracted, first_succ, -1)
    prv = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prv[nxt[contracted]] = nodes[contracted]
    del first_succ, contracted

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

    chains = torch.arange(len(chain_start), device=dev)
    rc_last = rc_idx[order[chain_end - 1]]
    twin = chain_of[rc_last]
    keep = (twin >= chains) | (order[chain_start[twin]] != rc_last)
    del rc_idx, chain_of, rc_last, twin, chains
    kept_start, kept_nodes = chain_start[keep], (chain_end - chain_start)[keep]
    del chain_start, chain_end, keep

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
    # each in one expression, so that no int64 column outlives its last use
    if len(oriented) == 1:
        fwd = ((oriented[0][node] >> shift) & 3).to(torch.uint8)
    else:  # the head k-mer's first k - 32 bases lie in hi
        fwd = (torch.where(shift >= 64, oriented[0][node] >> (shift - 64).clamp(min=0),
                           oriented[1][node] >> shift.clamp(max=62)) & 3).to(torch.uint8)
    del node, shift, start, order, oriented
    bwd = 3 - fwd[offsets[seq] + lengths[seq] - 1 - pos]
    del pos
    big = torch.iinfo(torch.int64).max
    first_diff = torch.full((len(lengths),), big, dtype=torch.int64, device=dev)
    first_diff.scatter_reduce_(
        0, seq, torch.where(fwd != bwd, torch.arange(total, device=dev), big), "amin"
    )
    at = first_diff.clamp(max=total - 1)
    flip = (first_diff != big) & (bwd[at] < fwd[at])
    return torch.where(flip[seq], bwd, fwd), offsets


def make_pangenome(genome_length: int, k: int, n_strains: int, mutation_rate: float,
                   seed: int, with_repeats: bool, device):
    """(codes uint8, offsets int64) as numpy arrays and the k-mers as an
    int64 tensor on ``device``, ``[n]`` for k <= 31 and ``[n, 2]`` (hi, lo)
    above (``kmers_numpy`` gives numpy's uint64 or 16-byte keys): the
    pangenome's unitigs and its merged canonical k-mer set, built on
    ``device``."""
    _check_k(k)
    device = torch.device(device)
    parts = [sorted_unique_kmers(canonical_kmers(
        torch.from_numpy(np.ascontiguousarray(s)).to(device), k), k)
        for s in pangenome_strains(genome_length, n_strains, mutation_rate, seed,
                                   with_repeats)]
    kmers = sorted_unique_kmers(torch.cat(parts), k)
    del parts
    codes, offsets = unitig_codes_from_kmers(kmers, k)
    return codes.cpu().numpy(), offsets.cpu().numpy(), kmers


def shuffle_unitigs(codes: np.ndarray, offsets: np.ndarray, seed: int, device):
    """The same unitigs in another order, each reverse-complemented or not,
    both drawn from ``seed``: the same k-mer set and the same sizes for
    every seed.  The arena is rebuilt on ``device``."""
    n = len(offsets) - 1
    rng = np.random.default_rng(seed)
    order = torch.from_numpy(rng.permutation(n)).to(device)
    flip = torch.from_numpy(rng.random(n) < 0.5).to(device)
    old = torch.from_numpy(offsets).to(device)
    lengths = (old[1:] - old[:-1])[order]
    new = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(lengths, 0, out=new[1:])
    total = int(new[-1])
    rec = torch.repeat_interleave(torch.arange(n, device=device), lengths, output_size=total)
    pos = torch.arange(total, device=device) - new[rec]
    start, f = old[order][rec], flip[rec]
    src = torch.where(f, start + lengths[rec] - 1 - pos, start + pos)
    del rec, pos, start
    base = torch.from_numpy(codes).to(device)[src]
    out = torch.where(f, 3 - base, base)
    return out.cpu().numpy(), new.cpu().numpy()


def kmers_numpy(kmers: torch.Tensor) -> np.ndarray:
    """The k-mers as numpy's uint64, or for two words as 16-byte keys, hi
    then lo, each big-endian, whose byte order is the keys' order."""
    a = kmers.cpu().numpy().view(np.uint64)
    if a.ndim == 1:
        return a
    pairs = np.empty(len(a), dtype=[("h", ">u8"), ("l", ">u8")])
    pairs["h"], pairs["l"] = a[:, 0], a[:, 1]
    return pairs.view("V16").reshape(-1)


# ---------------------------------------------------------------- outputs

_ASCII = np.frombuffer(b"ACGT", np.uint8)


def fasta_bytes(codes: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """The unitigs as plain fasta, record i headed ``>i`` and its sequence
    on one line, as one uint8 buffer (built over whole columns)."""
    n = len(offsets) - 1
    ids = np.arange(n, dtype=np.int64)
    nd = np.ones(n, np.int64)
    p = 10
    while p <= max(n - 1, 0):
        nd += ids >= p
        p *= 10
    lengths = np.diff(offsets)
    rec_len = 1 + nd + 1 + lengths + 1  # '>' digits '\n' bases '\n'
    rec_off = np.zeros(n + 1, np.int64)
    np.cumsum(rec_len, out=rec_off[1:])
    out = np.full(int(rec_off[-1]), ord("\n"), np.uint8)
    out[rec_off[:-1]] = ord(">")
    # digits, most significant first, right-aligned before the first '\n'
    v = ids.copy()
    end = rec_off[:-1] + 1 + nd  # one past the last digit
    for j in range(int(nd.max(initial=1))):
        live = nd > j
        out[(end - 1 - j)[live]] = ord("0") + (v[live] % 10).astype(np.uint8)
        v //= 10
    # bases: one boolean mask of the sequence bytes, filled in order
    seq_start = end + 1
    mask = np.zeros(len(out) + 1, np.int8)
    mask[seq_start] += 1
    mask[seq_start + lengths] -= 1
    out[np.cumsum(mask[:-1], dtype=np.int8).view(bool)] = _ASCII[codes]
    return out


def write_fasta(path: Path, codes: np.ndarray, offsets: np.ndarray) -> int:
    """Write the unitigs as plain fasta, flushed to the disk (so that no
    write-back of it falls into a later window); returns the bytes."""
    buf = fasta_bytes(codes, offsets)
    with open(path, "wb") as f:
        f.write(memoryview(buf))
        f.flush()
        os.fsync(f.fileno())
    return len(buf)


def dataset_digest(codes: np.ndarray, offsets: np.ndarray, kmers: np.ndarray) -> str:
    """sha256 over a dataset's codes (uint8), base offsets (int64) and
    k-mers (uint64, or the 16 bytes of each two-word key), in that order."""
    h = hashlib.sha256()
    two_words = kmers.dtype == np.dtype("V16")
    for a, dtype in ((codes, np.uint8), (offsets, np.int64),
                     (kmers, kmers.dtype if two_words else np.uint64)):
        h.update(np.ascontiguousarray(a, dtype=dtype))
    return h.hexdigest()
