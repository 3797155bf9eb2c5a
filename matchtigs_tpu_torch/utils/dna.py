# Copied from matchtigs_tpu/utils/dna.py; revcomp_packed_u64 uses a byte table (same output).
"""2-bit DNA encoding utilities (numpy, host side).

Array-native analog of the reference's ``compact-genome`` crate
(upstream src/bin.rs:25-30): sequences are stored once, 2-bit
packed, and edges refer to them by handle.  Unlike the pointer-based
Rust arena, sequences here live in one flat uint8 code array (one code
per base, values 0..3) plus an offsets array, which maps directly to
vectorized slicing, reverse complement, and spelling.

Encoding: A=0, C=1, G=2, T=3 so that complement(x) = 3 - x.
"""

from __future__ import annotations

import numpy as np

# ASCII -> 2-bit code lookup (255 = invalid).
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _ch, _code in zip(b"ACGT", (0, 1, 2, 3)):
    _CODE_LUT[_ch] = _code
for _ch, _code in zip(b"acgt", (0, 1, 2, 3)):
    _CODE_LUT[_ch] = _code

_CHAR_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_ascii(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII DNA -> uint8 codes (0..3). Raises on non-ACGT characters."""
    raw = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    codes = _CODE_LUT[raw]
    if codes.max(initial=0) > 3:
        bad = raw[codes == 255]
        raise ValueError(f"Non-ACGT character in sequence: {bytes(bad[:10])!r}")
    return codes


def decode_to_ascii(codes: np.ndarray) -> bytes:
    """uint8 codes (0..3) -> ASCII DNA bytes."""
    return _CHAR_LUT[codes].tobytes()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array."""
    return (3 - codes)[::-1]


def canonical_u64(kmer_codes: np.ndarray) -> int:
    """Canonical (min of fwd/rc) 2-bit packing of a k-mer, k <= 31."""
    f = pack_u64(kmer_codes)
    r = pack_u64(revcomp(kmer_codes))
    return min(f, r)


def pack_u64(kmer_codes: np.ndarray) -> int:
    """Pack a k-mer (k <= 31) into a python int, first base most significant."""
    v = 0
    for c in kmer_codes.tolist():
        v = (v << 2) | int(c)
    return v


def pack_kmers_u64(codes: np.ndarray, k: int) -> np.ndarray:
    """All overlapping k-mers of `codes` packed into uint64, vectorized.

    k must be <= 31 (2 bits per base, 62 bits used).
    """
    assert k <= 31, "pack_kmers_u64 supports k <= 31"
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    c = codes.astype(np.uint64)
    # Rolling pack via prefix trick: value[i] = sum_{j<k} c[i+j] << 2*(k-1-j)
    out = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        out |= c[j : j + n] << np.uint64(2 * (k - 1 - j))
    return out


# byte -> its four 2-bit codes complemented and in reverse order
_REVCOMP_BYTE = np.array(
    [sum((3 - ((b >> (2 * i)) & 3)) << (2 * (3 - i)) for i in range(4)) for b in range(256)],
    dtype=np.uint8,
)


def revcomp_packed_u64(vals: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers (vectorized, uint64; k <= 32):
    all 32 codes of each word complemented and reversed by a byte table
    and a byte swap, then the k codes shifted down."""
    v = np.ascontiguousarray(vals, dtype=np.uint64)
    r = _REVCOMP_BYTE[v.reshape(-1).view(np.uint8)].view(np.uint64).byteswap()
    return (r >> np.uint64(2 * (32 - k))).reshape(v.shape)


def canonical_packed_u64(vals: np.ndarray, k: int) -> np.ndarray:
    """Canonical form (elementwise min of fwd and rc) of packed k-mers."""
    rc = revcomp_packed_u64(vals, k)
    return np.minimum(vals.astype(np.uint64), rc)


# -- two-word packing for 31 < k <= 63 (2k bits across hi/lo uint64) ------

def pack_kmers_2x64(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All overlapping k-mers packed into (hi, lo) uint64 pairs, first base
    most significant.  lo holds the last 32 bases, hi the first k-32."""
    assert 31 < k <= 63
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    c = codes.astype(np.uint64)
    lo = np.zeros(n, dtype=np.uint64)
    hi = np.zeros(n, dtype=np.uint64)
    k_lo = 32
    k_hi = k - k_lo
    for j in range(k_hi):  # bases 0 .. k_hi-1 -> hi
        hi |= c[j : j + n] << np.uint64(2 * (k_hi - 1 - j))
    for j in range(k_lo):  # bases k_hi .. k-1 -> lo
        lo |= c[k_hi + j : k_hi + j + n] << np.uint64(2 * (k_lo - 1 - j))
    return hi, lo


def revcomp_packed_2x64(
    hi: np.ndarray, lo: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Reverse complement of (hi, lo)-packed k-mers."""
    assert 31 < k <= 63
    k_lo = 32
    k_hi = k - k_lo
    chi = ~hi.astype(np.uint64)
    clo = ~lo.astype(np.uint64)
    # reversed base j of the result comes from base k-1-j of the input
    rhi = np.zeros_like(hi)
    rlo = np.zeros_like(lo)
    for j in range(k):
        src = k - 1 - j  # input base index feeding output base j
        if src >= k_hi:  # input base in lo
            base = (clo >> np.uint64(2 * (k_lo - 1 - (src - k_hi)))) & np.uint64(3)
        else:
            base = (chi >> np.uint64(2 * (k_hi - 1 - src))) & np.uint64(3)
        if j < k_hi:
            rhi |= base << np.uint64(2 * (k_hi - 1 - j))
        else:
            rlo |= base << np.uint64(2 * (k_lo - 1 - (j - k_hi)))
    return rhi, rlo


def canonical_packed_2x64(
    hi: np.ndarray, lo: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Canonical (lexicographic min of fwd/rc) of (hi, lo)-packed k-mers."""
    rhi, rlo = revcomp_packed_2x64(hi, lo, k)
    take_rc = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    return np.where(take_rc, rhi, hi), np.where(take_rc, rlo, lo)
