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
whatever device it is given, in blocks of bases.  A k-mer of k <= 31 is
one int64 word; one of 31 < k <= 63 is two, hi holding its first k - 32
bases and lo its last 32, and a set of them an int64 ``[n, 2]`` tensor in
the order of the unsigned 128-bit key.
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
_SIGN = -(1 << 63)  # lo ^ _SIGN orders int64 words as unsigned ones


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
    ``[n]`` for k <= 31 and ``[n, 2]`` above, malformed records): every
    window of k bases inside one record, packed two bits a base, first
    base most significant, the smaller of it and its reverse complement.
    A window over a byte other than ACGT is left out, and its record
    counted malformed, as is a record shorter than k."""
    if not 1 <= k <= 63:
        raise ValueError(f"the reference packs k <= 63 into two words, not k={k}")
    words = 1 if k <= 31 else 2
    lengths = np.diff(offsets)
    bad_rec = np.zeros(len(lengths), bool)
    bad_rec |= lengths < k
    codes_t = torch.from_numpy(codes)
    off = torch.from_numpy(offsets).to(device)
    parts = []
    total = len(codes)
    for first in range(0, max(total - k + 1, 0), BLOCK):
        end = min(first + BLOCK, total - k + 1)
        c = codes_t[first:end + k - 1].to(device, torch.int64)
        n = end - first
        start = torch.arange(first, end, device=device)
        rec = torch.searchsorted(off, start, right=True) - 1
        inside = start + k <= off[rec + 1]
        fwd = torch.zeros((words, n), dtype=torch.int64, device=device)  # (hi,) lo
        rc = torch.zeros_like(fwd)
        bad = torch.zeros(n, dtype=torch.bool, device=device)
        for j in range(k):
            w = c[j:j + n]
            bad |= w > 3
            w = w & 3
            f, r = 2 * (k - 1 - j), 2 * j  # the base's bit in each strand's key
            fwd[words - 1 - f // 64] |= w << (f % 64)
            rc[words - 1 - r // 64] |= (3 - w) << (r % 64)
        del c
        bad_inside = bad & inside
        if bool(bad_inside.any()):
            bad_rec[np.unique(rec[bad_inside].cpu().numpy())] = True
        keep = inside & ~bad
        del bad, start, rec, inside, bad_inside
        canon = torch.where(_below(rc, fwd), rc, fwd)[:, keep]
        del fwd, rc, keep
        parts.append(_unique(canon.T))
        del canon
    kmers = torch.cat(parts) if parts else torch.empty(
        (0, words), dtype=torch.int64, device=device)
    del parts
    kmers = _unique(kmers)
    return (kmers[:, 0] if words == 1 else kmers), int(bad_rec.sum())


def _below(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per column, whether key ``a`` lies below key ``b`` (``[words, n]``,
    lo as unsigned)."""
    if len(a) == 1:
        return a[0] < b[0]
    return (a[0] < b[0]) | ((a[0] == b[0]) & ((a[1] ^ _SIGN) < (b[1] ^ _SIGN)))


def _unique(keys: torch.Tensor) -> torch.Tensor:
    """The distinct rows of ``[n, words]`` keys in ascending order; two
    words by a stable sort on lo, then one on hi."""
    if keys.shape[1] == 1:
        return torch.unique(keys[:, 0])[:, None]
    order = torch.argsort(keys[:, 1] ^ _SIGN, stable=True)
    order = order[torch.argsort(keys[:, 0][order], stable=True)]
    keys = keys[order]
    del order
    new = torch.ones(len(keys), dtype=torch.bool, device=keys.device)
    new[1:] = (keys[1:] != keys[:-1]).any(1)
    return keys[new]


def compare(want: torch.Tensor, got: torch.Tensor) -> tuple[int, int]:
    """(missing, foreign): the keys of ``want`` not in ``got``, and of
    ``got`` not in ``want``; both sorted and unique.  Each key of ``got``
    is looked up in ``want``; two words by the run of ``want``'s keys with
    its hi, then a binary search on lo inside that run, in blocks of
    keys."""
    if len(want) == 0:
        return 0, len(got)
    if want.dim() == 1:
        at = torch.searchsorted(want, got).clamp(max=len(want) - 1)
        common = int((want[at] == got).sum())
        return len(want) - common, len(got) - common
    hi, lo = want[:, 0].contiguous(), want[:, 1] ^ _SIGN
    common = 0
    for first in range(0, len(got), BLOCK):
        q_hi, q_lo = got[first:first + BLOCK, 0].contiguous(), got[first:first + BLOCK, 1] ^ _SIGN
        left = torch.searchsorted(hi, q_hi)
        end = torch.searchsorted(hi, q_hi, right=True)
        for _ in range(int((end - left).max()).bit_length()):
            live = left < end
            mid = (left + end) >> 1
            up = live & (lo[mid.clamp(max=len(lo) - 1)] < q_lo)
            left = torch.where(up, mid + 1, left)
            end = torch.where(live & ~up, mid, end)
        at = left.clamp(max=len(lo) - 1)
        common += int(((left < len(lo)) & (hi[at] == q_hi) & (lo[at] == q_lo)).sum())
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
