"""The plain reference that decides ``correct``.

The configurations state the guarantee: the tigs a call writes spell
exactly the k-mer set of the unitigs it read, counting a k-mer and its
reverse complement as one.  The reference works that set out again from
the input fasta, works out the set the output fasta spells, and counts
the k-mers missing from the output, the k-mers foreign to the input, and
the malformed records (a byte other than A, C, G or T, or a record
shorter than k).  It also measures what the tigs cost against what the
unitigs cost: their count (``tig_ratio``) and their characters
(``char_ratio``), the quantity matchtigs minimise.  A search stage that
finds fewer joins writes more tigs and more characters.

Plain numpy and torch; it imports nothing of the program, and runs on
whatever device it is given, in blocks of bases.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[_c + 32] = _i  # lower case
BLOCK = 1 << 27  # k-mer windows per block on the device


def read_fasta(path) -> tuple[np.ndarray, np.ndarray]:
    """(codes uint8, base offsets int64 with a leading 0) of a fasta file,
    sequences over several lines allowed; a byte other than ACGT (either
    case) has the code 255."""
    data = np.fromfile(path, dtype=np.uint8)
    if len(data) == 0:
        return np.empty(0, np.uint8), np.zeros(1, np.int64)
    if data[-1] != ord("\n"):
        data = np.append(data, np.uint8(ord("\n")))
    ends = np.flatnonzero(data == ord("\n"))
    starts = np.concatenate([[0], ends[:-1] + 1])
    # drop a carriage return before each line break
    cr = (ends > starts) & (data[np.maximum(ends - 1, 0)] == ord("\r"))
    line_end = ends - cr
    is_hdr = data[np.minimum(starts, len(data) - 1)] == ord(">")
    is_hdr &= ends > starts
    if not is_hdr[np.flatnonzero(line_end > starts)[:1]].all():
        raise ValueError(f"{path}: sequence before the first header")
    rec = np.cumsum(is_hdr) - 1
    seq = ~is_hdr & (line_end > starts)
    n = int(is_hdr.sum())
    lengths = np.bincount(rec[seq], weights=(line_end - starts)[seq], minlength=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lengths.astype(np.int64), out=offsets[1:])
    mask = np.zeros(len(data) + 1, np.int8)
    mask[starts[seq]] += 1
    mask[line_end[seq]] -= 1
    codes = _CODE[data[np.cumsum(mask[:-1], dtype=np.int8).view(bool)]]
    return codes, offsets


def kmer_set(codes: np.ndarray, offsets: np.ndarray, k: int, device) -> tuple:
    """(sorted unique canonical k-mers as an int64 tensor on ``device``,
    malformed records): every window of k bases inside one record, packed
    two bits a base, first base most significant, the smaller of it and
    its reverse complement.  A window over a byte other than ACGT is left
    out, and its record counted malformed, as is a record shorter than
    k."""
    if not 1 <= k <= 31:
        raise ValueError(f"the reference packs k <= 31 into one word, not k={k}")
    lengths = np.diff(offsets)
    bad_rec = np.zeros(len(lengths), bool)
    bad_rec |= lengths < k
    codes_t = torch.from_numpy(codes)
    off = torch.from_numpy(offsets).to(device)
    parts = []
    total = len(codes)
    for lo in range(0, max(total - k + 1, 0), BLOCK):
        hi = min(lo + BLOCK, total - k + 1)
        c = codes_t[lo:hi + k - 1].to(device, torch.int64)
        n = hi - lo
        start = torch.arange(lo, hi, device=device)
        rec = torch.searchsorted(off, start, right=True) - 1
        inside = start + k <= off[rec + 1]
        fwd = torch.zeros(n, dtype=torch.int64, device=device)
        rc = torch.zeros_like(fwd)
        bad = torch.zeros(n, dtype=torch.bool, device=device)
        for j in range(k):
            w = c[j:j + n]
            bad |= w > 3
            w = w & 3
            fwd |= w << (2 * (k - 1 - j))
            rc |= (3 - w) << (2 * j)
        del c
        bad_inside = bad & inside
        if bool(bad_inside.any()):
            bad_rec[np.unique(rec[bad_inside].cpu().numpy())] = True
        keep = inside & ~bad
        parts.append(torch.unique(torch.minimum(fwd, rc)[keep]))
        del fwd, rc, bad, keep, start, rec, inside
    kmers = torch.unique(torch.cat(parts)) if parts else torch.empty(
        0, dtype=torch.int64, device=device)
    return kmers, int(bad_rec.sum())


def compare(want: torch.Tensor, got: torch.Tensor) -> tuple[int, int]:
    """(missing, foreign): the keys of ``want`` not in ``got``, and of
    ``got`` not in ``want``; both sorted and unique."""
    if len(want) == 0:
        return 0, len(got)
    at = torch.searchsorted(want, got).clamp(max=len(want) - 1)
    common = int((want[at] == got).sum())
    return len(want) - common, len(got) - common


def input_kmers(path, k: int, device) -> dict:
    """The input's k-mer set and its counts."""
    codes, offsets = read_fasta(path)
    kmers, malformed = kmer_set(codes, offsets, k, device)
    return dict(kmers=kmers, unitigs=len(offsets) - 1, characters=int(offsets[-1]),
                malformed=malformed)


def check_output(want: dict, path, k: int, device) -> dict:
    """The numbers compared for one output file, and what it holds."""
    codes, offsets = read_fasta(path)
    got, malformed = kmer_set(codes, offsets, k, device)
    missing, foreign = compare(want["kmers"], got)
    tigs = len(offsets) - 1
    return dict(
        missing_kmers=missing, foreign_kmers=foreign, malformed_records=malformed,
        tig_ratio=tigs / max(1, want["unitigs"]),
        char_ratio=int(offsets[-1]) / max(1, want["characters"]),
        tigs=tigs, characters=int(offsets[-1]),
    )


# ------------------------------------------------------ control and faults
# Each takes the records of a sound output and returns those of a damaged
# one: (codes, offsets) -> (codes, offsets).


def alter_base(codes, offsets, seed: int):
    """The control: one base of the longest tig changed to another, at a
    place drawn from the seed."""
    codes = codes.copy()
    t = int(np.argmax(np.diff(offsets)))
    rng = np.random.default_rng(seed)
    at = int(offsets[t] + rng.integers(0, offsets[t + 1] - offsets[t]))
    codes[at] = (codes[at] + 1 + rng.integers(0, 3)) % 4
    return codes, offsets


def drop_half(codes, offsets, seed: int):
    """Every other tig left out."""
    lengths = np.diff(offsets)[::2]
    keep = np.repeat(np.arange(len(offsets) - 1) % 2 == 0, np.diff(offsets))
    new = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=new[1:])
    return codes[keep], new


FAULTS = {"alter_base": alter_base, "drop_half": drop_half}


def damage(src: Path, dst: Path, fault: str, seed: int) -> None:
    """Write to ``dst`` the output ``src`` with ``fault`` planted."""
    from .generator import write_fasta

    codes, offsets = read_fasta(src)
    write_fasta(dst, *FAULTS[fault](codes, offsets, seed))
