# Copied from matchtigs_tpu/io/readers.py; read_gfa logs which name resolution it took.
"""Unitig input parsers: plain fasta, BCALM2/GGCAT fasta, GFA (all + gzip).

Capability-equivalent of ``genome-graph::io`` (call sites
upstream src/bin.rs:31-43,874-915).  All three formats produce a
:class:`SequenceStore` plus a topology source: GFA L-lines and BCALM2
header annotations yield explicit links (built with the union-find
link builder, the reference's fast path); plain fasta falls back to
vectorized (k-1)-overlap deduplication
(:func:`matchtigs_tpu_torch.graph.build.build_bigraph_from_unitigs`).  For true
compacted de Bruijn unitig sets the two constructions agree.

All three parsers are vectorized over the whole byte buffer — per-line
python loops cost ~8us/record (minutes at the 60M-base scale, where a
BCALM2 file has ~7.8M records and ~15M link tags), against seconds for
the numpy line scan + windowed integer decode.  The reference contract
is that BCALM2/GFA is the *fast* input path (bin.rs:902-915), so the
link formats must not be slower than plain fasta.

Gzip is sniffed by the ``.gz`` extension, like the reference
(upstream src/bin.rs:877,894,905).
"""

from __future__ import annotations

import gzip
import logging
import os
import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils import dna
from ..utils.tracing import span
from .sequence_store import SequenceStore

logger = logging.getLogger(__name__)


@dataclass
class Links:
    """Explicit topology links as column arrays.

    One row per directed link ``(a, sa) -> (b, sb)``: unitig ``a`` read in
    orientation ``sa`` (True = forward) is followed by unitig ``b`` in
    orientation ``sb`` — GFA L-line / BCALM2 ``L:sa:b:sb`` semantics.
    Column layout avoids materializing millions of small tuples
    (the same reasoning as ops/candidates.py); iteration still yields
    ``(a, sa, b, sb)`` tuples for small-scale/test use.
    """

    a: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64)
    )
    sa: np.ndarray = field(default_factory=lambda: np.empty(0, bool))
    b: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64)
    )
    sb: np.ndarray = field(default_factory=lambda: np.empty(0, bool))

    def __len__(self) -> int:
        return len(self.a)

    def __iter__(self):
        for a, sa, b, sb in zip(self.a, self.sa, self.b, self.sb):
            yield int(a), bool(sa), int(b), bool(sb)

    @classmethod
    def from_rows(cls, rows) -> "Links":
        if isinstance(rows, Links):
            return rows
        if not rows:
            return cls()
        return cls(
            a=np.asarray([r[0] for r in rows], dtype=np.int64),
            sa=np.asarray([r[1] for r in rows], dtype=bool),
            b=np.asarray([r[2] for r in rows], dtype=np.int64),
            sb=np.asarray([r[3] for r in rows], dtype=bool),
        )


@dataclass
class GfaProperties:
    k: int | None
    header: str | None
    # L-line topology, unitig ids being S-line ordinals.
    links: Links | None = None


def _open_maybe_gz(path: str | Path, mode: str = "rb"):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, mode)
    return open(path, mode)


def _line_spans(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Non-empty line (start, end) spans; ends exclude ``\\r``."""
    n = len(arr)
    nl = np.flatnonzero(arr == 10)  # '\n'
    line_s = np.empty(len(nl) + 1, dtype=np.int64)
    line_s[0] = 0
    line_s[1:] = nl + 1
    line_e = np.append(nl, np.int64(n))
    line_e -= (line_e > line_s) & (arr[np.maximum(line_e - 1, 0)] == 13)
    keep = line_s < line_e
    return line_s[keep], line_e[keep]


def _span_mask(n: int, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Boolean mask selecting the union of non-overlapping [s, e) spans."""
    d = np.zeros(n + 1, dtype=np.int8)
    d[starts] += 1
    d[ends] -= 1
    # spans don't nest, so the running sum is 0/1 and fits int8; the
    # dtype pin matters: the default promotion to int64 materializes an
    # 8x temporary (4.8 GB at a 600 MB input).
    return np.cumsum(d[:-1], dtype=np.int8).view(bool)


def _store_from_spans(
    arr: np.ndarray, seq_s: np.ndarray, seq_e: np.ndarray
) -> SequenceStore:
    """Bulk-encode the given sequence spans (file order) into a store."""
    lens = (seq_e - seq_s).astype(np.int64)
    offsets = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    codes = dna.encode_ascii(arr[_span_mask(len(arr), seq_s, seq_e)])
    assert len(codes) == int(offsets[-1])
    return SequenceStore.from_flat(codes, offsets)


def _compress_spans(
    arr: np.ndarray, starts: np.ndarray, ends: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate ordered non-overlapping byte spans via one boolean
    compress (repeat/scatter index arrays cost 8 bytes per byte moved).

    Returns (buffer, span_start_offsets): span i occupies
    ``buffer[off[i] : off[i] + (ends[i] - starts[i])]``.
    """
    buf = arr[_span_mask(len(arr), starts, ends)]
    lens = (ends - starts).astype(np.int64)
    off = np.cumsum(lens) - lens
    return buf, off


_PARSE_MAX_DIGITS = 18  # fits int64


def _parse_uints(
    buf: np.ndarray, starts: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Decode decimal runs starting at ``starts``: (values, n_digits).

    Vectorized windowed Horner over up to 18 digits; n_digits = 0 marks
    a non-digit at the start position.  ``buf`` must have at least
    ``_PARSE_MAX_DIGITS`` non-digit pad bytes at the end (callers pad).
    """
    n = len(starts)
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    # One 1D gather per digit column with early exit: a 2D window gather
    # materializes an [n, 18] int64 index (1.2 GB at 8.5M refs), while
    # real ids are ~7 digits.
    base = starts.astype(np.int64, copy=False)
    val = np.zeros(n, dtype=np.int64)
    nd = np.zeros(n, dtype=np.int64)
    active = np.ones(n, dtype=bool)
    for j in range(_PARSE_MAX_DIGITS):
        c = buf[base + j].astype(np.int64)
        active &= (c >= 48) & (c <= 57)
        if not active.any():
            break
        val = np.where(active, val * 10 + (c - 48), val)
        nd += active
    return val, nd


def _fasta_scan(arr: np.ndarray):
    """Shared fasta structure scan: line spans + header classification."""
    line_s, line_e = _line_spans(arr)
    is_hdr = arr[line_s] == ord(">") if len(line_s) else np.empty(0, bool)
    rec = np.cumsum(is_hdr) - 1
    if len(rec) and rec[0] < 0:
        raise ValueError("sequence data before the first '>' header")
    return line_s, line_e, is_hdr, rec


def _fasta_store(arr, line_s, line_e, is_hdr, rec) -> SequenceStore:
    """Build the store from a fasta scan (multi-line records allowed)."""
    n_rec = int(rec[-1]) + 1 if len(rec) else 0
    seq = ~is_hdr
    lens = (line_e - line_s)[seq]
    rec_len = np.bincount(rec[seq], weights=lens, minlength=n_rec).astype(
        np.int64
    )
    offsets = np.zeros(n_rec + 1, dtype=np.int64)
    np.cumsum(rec_len, out=offsets[1:])
    # Union of sequence-line spans; headers/newlines are the small
    # fraction, so a boolean mask avoids full-length gather indices.
    mask = _span_mask(len(arr), line_s[seq], line_e[seq])
    codes = dna.encode_ascii(arr[mask])
    assert len(codes) == int(offsets[-1])
    return SequenceStore.from_flat(codes, offsets)


def read_fasta(
    path: str | Path, with_headers: bool = True
) -> tuple[SequenceStore, list[bytes] | None]:
    """Read unitigs from a (possibly gzipped) fasta file.

    Covers both the plain-fasta path (upstream src/bin.rs:891-901)
    and the BCALM2 path (:902-915): BCALM2 headers carry topology
    annotations (``L:+:12:-`` links), but the graph builder re-derives
    topology from the sequences, so both reduce to sequence loading.
    """
    with _open_maybe_gz(path) as f:
        data = f.read()
    arr = np.frombuffer(data, dtype=np.uint8)
    if len(arr) == 0:
        return (
            SequenceStore.from_flat(np.empty(0, np.uint8), np.zeros(1, np.int64)),
            [] if with_headers else None,
        )
    line_s, line_e, is_hdr, rec = _fasta_scan(arr)
    store = _fasta_store(arr, line_s, line_e, is_hdr, rec)
    if not with_headers:
        return store, None  # 7.8M small bytes objects cost ~3s + 400MB
    headers = [
        data[s + 1 : e]
        for s, e in zip(line_s[is_hdr].tolist(), line_e[is_hdr].tolist())
    ]
    return store, headers


_KL_RE = re.compile(rb"\bKL:Z:(\d+)\b")
_OVERLAP_RE = re.compile(rb"^(\d+)M$")


def read_bcalm2(path: str | Path) -> tuple[SequenceStore, Links]:
    """Read BCALM2/GGCAT fasta: sequences plus header-annotated topology.

    BCALM2 headers carry ``L:<my_strand>:<other_id>:<other_strand>`` tags
    (the reference's fast input path, upstream src/bin.rs:902-915).
    The tag scan runs over one concatenated header buffer: candidate
    positions from a 4-byte stencil match, ids from the windowed decimal
    decode — no per-record python.
    """
    with _open_maybe_gz(path) as f:
        data = f.read()
    arr = np.frombuffer(data, dtype=np.uint8)
    if len(arr) == 0:
        return (
            SequenceStore.from_flat(np.empty(0, np.uint8), np.zeros(1, np.int64)),
            Links(),
        )
    line_s, line_e, is_hdr, rec = _fasta_scan(arr)
    store = _fasta_store(arr, line_s, line_e, is_hdr, rec)

    hs, he = line_s[is_hdr] + 1, line_e[is_hdr]  # drop '>'
    # Keep each header's line break as an in-buffer separator so a tag at
    # the start of one header can't see the previous header's tail.
    hbuf, hoff = _compress_spans(
        arr, hs, np.minimum(he + 1, len(arr))
    )
    # Pad so windowed decodes past the last byte stay in bounds.
    hbuf = np.concatenate(
        [hbuf, np.full(_PARSE_MAX_DIGITS + 4, 10, np.uint8)]
    )
    # Stencil for "L:[+-]:" at tag boundaries (start or after whitespace).
    m = hbuf[:-4] == ord("L")
    m &= hbuf[1:-3] == ord(":")
    m &= (hbuf[2:-2] == ord("+")) | (hbuf[2:-2] == ord("-"))
    m &= hbuf[3:-1] == ord(":")
    p = np.flatnonzero(m)
    if len(p):
        pre = hbuf[np.maximum(p - 1, 0)]
        p = p[(p == 0) | (pre == 32) | (pre == 9) | (pre == 10) | (pre == 13)]
    vals, nd = _parse_uints(hbuf, p + 4)
    tail = p + 4 + nd
    ok = (
        (nd > 0)
        & (hbuf[tail] == ord(":"))
        & ((hbuf[tail + 1] == ord("+")) | (hbuf[tail + 1] == ord("-")))
    )
    p, vals, tail = p[ok], vals[ok], tail[ok]
    uid = np.searchsorted(hoff, p, side="right") - 1
    return store, Links(
        a=uid.astype(np.int64),
        sa=hbuf[p + 2] == ord("+"),
        b=vals,
        sb=hbuf[tail + 1] == ord("+"),
    )


def _tabs_after(tabs: np.ndarray, line_s: np.ndarray, line_e: np.ndarray,
                count: int) -> np.ndarray:
    """First ``count`` tab positions of each line as an [L, count] matrix;
    positions at/after line end are set to the line end (missing field)."""
    i0 = np.searchsorted(tabs, line_s)
    idx = i0[:, None] + np.arange(count, dtype=np.int64)[None, :]
    t = tabs[np.minimum(idx, len(tabs) - 1)] if len(tabs) else np.full(
        idx.shape, np.int64(1 << 62)
    )
    if len(tabs):
        t = np.where(idx < len(tabs), t, np.int64(1 << 62))
    return np.minimum(t, line_e[:, None])


def _resolve_names_numeric(
    arr, name_s, name_e, ref_s, ref_e
) -> tuple[np.ndarray, np.ndarray] | None:
    """Map L-line name references to S-line ordinals when every name is a
    canonical decimal (no leading zeros, fits int64).  Returns
    (ids, found_mask) or None when the fast path doesn't apply."""
    max_end = 0
    for s, e in ((name_s, name_e), (ref_s, ref_e)):
        lens = e - s
        if len(s) and (
            lens.min(initial=1) < 1 or lens.max(initial=0) > _PARSE_MAX_DIGITS
        ):
            return None
        max_end = max(max_end, int(e.max(initial=0)))
    # Windowed decodes read past span ends; names/refs are followed by a
    # non-digit in-file (tab or newline), so the file itself is the pad
    # unless a span runs to within a window of EOF.
    if len(arr) - max_end < _PARSE_MAX_DIGITS:
        pad = np.concatenate(
            [arr, np.full(_PARSE_MAX_DIGITS, 10, np.uint8)]
        )
    else:
        pad = arr
    nvals, nnd = _parse_uints(pad, name_s)
    if np.any(nnd != name_e - name_s):
        return None  # non-digit characters in some S name
    # leading zeros make distinct strings numerically equal — bail out
    if np.any((arr[name_s] == ord("0")) & (name_e - name_s > 1)):
        return None
    rvals, rnd = _parse_uints(pad, ref_s)
    order = np.argsort(nvals, kind="stable")
    snames = nvals[order]
    pos = np.searchsorted(snames, rvals)
    posc = np.minimum(pos, max(len(snames) - 1, 0))
    found = (
        (rnd == ref_e - ref_s)
        & (rnd > 0)
        & (pos < len(snames))
        & (snames[posc] == rvals)
        if len(snames)
        else np.zeros(len(rvals), bool)
    )
    ids = order[posc] if len(snames) else np.zeros(len(rvals), np.int64)
    # leading-zero refs can't match canonical names
    found &= ~((arr[ref_s] == ord("0")) & (ref_e - ref_s > 1))
    return ids.astype(np.int64), found


def read_gfa(path: str | Path) -> tuple[SequenceStore, GfaProperties]:
    """Read unitigs from a (possibly gzipped) GFA1 file.

    Extracts k from the header ``KL:Z:<k>`` tag if present, else from the
    first L-line overlap CIGAR ``<k-1>M`` (the reference's GFA reader also
    recovers k from the file; upstream src/bin.rs:874-890).

    Vectorized: one line scan classifies records; S-line sequences bulk-
    encode via a span mask; L-line name references resolve through a
    sorted numeric lookup when names are canonical decimals (the common
    assembler output), falling back to a python name map otherwise.
    L-lines may precede their S-lines (resolution is deferred).
    """
    with _open_maybe_gz(path) as f:
        data = f.read()
    arr = np.frombuffer(data, dtype=np.uint8)
    if len(arr) == 0:
        return (
            SequenceStore.from_flat(np.empty(0, np.uint8), np.zeros(1, np.int64)),
            GfaProperties(k=None, header=None, links=Links()),
        )
    line_s, line_e = _line_spans(arr)
    first = arr[line_s]
    header: str | None = None
    k: int | None = None
    h_rows = np.flatnonzero(first == ord("H"))
    if len(h_rows):
        s, e = int(line_s[h_rows[0]]), int(line_e[h_rows[0]])
        header = bytes(arr[s:e]).decode()
        m = _KL_RE.search(data[s:e])
        if m:
            k = int(m.group(1))

    tabs = np.flatnonzero(arr == 9)

    s_rows = first == ord("S")
    ss, se = line_s[s_rows], line_e[s_rows]
    t = _tabs_after(tabs, ss, se, 3)  # S \t name \t seq [\t tags...]
    if np.any(t[:, 1] >= se):
        bad = int(np.argmax(t[:, 1] >= se))
        raise ValueError(
            f"{path}: malformed S-line at byte {int(ss[bad])}"
        )
    name_s, name_e = t[:, 0] + 1, t[:, 1]
    seq_s, seq_e = t[:, 1] + 1, t[:, 2]
    star = (seq_e - seq_s == 1) & (arr[np.minimum(seq_s, len(arr) - 1)] == ord("*"))
    if np.any(star):
        bad = int(np.argmax(star))
        name = bytes(arr[name_s[bad] : name_e[bad]]).decode()
        # GFA permits S-lines without an inline sequence; tig computation
        # must spell output sequences, so such files cannot be processed
        # (the reference reads GFA via genome-graph, which also requires
        # sequences; upstream src/bin.rs:892-906).
        raise ValueError(
            f"GFA segment {name!r} has a '*' (absent) sequence; matchtigs "
            "needs the unitig sequences inline to spell output tigs"
        )
    store = _store_from_spans(arr, seq_s, seq_e)

    l_rows = first == ord("L")
    ls, le = line_s[l_rows], line_e[l_rows]
    t = _tabs_after(tabs, ls, le, 6)  # L from fo to to_o overlap
    complete = t[:, 3] < le  # fields 1-4 present (orient b inline)
    ls, le, t = ls[complete], le[complete], t[complete]
    fa_s, fa_e = t[:, 0] + 1, t[:, 1]
    sa = arr[np.minimum(t[:, 1] + 1, len(arr) - 1)] == ord("+")
    fb_s, fb_e = t[:, 2] + 1, t[:, 3]
    sb = arr[np.minimum(t[:, 3] + 1, len(arr) - 1)] == ord("+")
    if k is None and len(ls):
        ov_s, ov_e = int(t[0, 4]) + 1, int(t[0, 5])
        m = _OVERLAP_RE.match(bytes(arr[ov_s:ov_e]))
        if m:
            k = int(m.group(1)) + 1

    resolved = _resolve_names_numeric(
        arr, name_s, name_e,
        np.concatenate([fa_s, fb_s]), np.concatenate([fa_e, fb_e]),
    )
    n_l = len(ls)
    logger.info(
        "GFA names of %d segments and %d links resolved %s", len(name_s), n_l,
        "as decimals" if resolved is not None else "through a name map",
    )
    if resolved is not None:
        ids, found = resolved
        a_ids, b_ids = ids[:n_l], ids[n_l:]
        keep = found[:n_l] & found[n_l:]
        links = Links(
            a=a_ids[keep], sa=sa[keep], b=b_ids[keep], sb=sb[keep]
        )
    else:
        # Arbitrary string names: python name map (rare; assembler GFAs
        # use integer ordinals).
        name_to_id = {
            bytes(arr[s:e]): i
            for i, (s, e) in enumerate(zip(name_s.tolist(), name_e.tolist()))
        }
        rows = []
        for i in range(n_l):
            na = bytes(arr[fa_s[i] : fa_e[i]])
            nb = bytes(arr[fb_s[i] : fb_e[i]])
            if na in name_to_id and nb in name_to_id:
                rows.append(
                    (name_to_id[na], bool(sa[i]), name_to_id[nb], bool(sb[i]))
                )
        links = Links.from_rows(rows)
    return store, GfaProperties(k=k, header=header, links=links)


def load_unitigs(
    gfa_in: str | None = None,
    fa_in: str | None = None,
    bcalm_in: str | None = None,
    k: int | None = None,
) -> tuple[SequenceStore, int, str | None, Links | None]:
    """CLI-style loader: exactly one input source.

    Returns (store, k, gfa_header, links): links is the explicit topology
    (GFA L-lines / BCALM2 header annotations) when the format provides one
    — the reference builds the graph from it instead of overlap hashing
    (upstream src/bin.rs:874-915) — else None (plain fasta).
    """
    given = [x for x in (gfa_in, fa_in, bcalm_in) if x is not None]
    if len(given) != 1:
        raise ValueError(
            "Specify exactly one of gfa_in, fa_in, bcalm_in"
        )
    if gfa_in is None and k is None:
        raise ValueError("k is required for fasta/bcalm input")
    with span("load.read") as sp:
        header = file_k = None
        if gfa_in is not None:
            store, props = read_gfa(gfa_in)
            links, header, file_k = props.links, props.header, props.k
        elif bcalm_in is not None:
            store, links = read_bcalm2(bcalm_in)
        else:
            store, links = read_fasta(fa_in, with_headers=False)[0], None
        if sp:
            sp.add(records=len(store), bytes=os.path.getsize(given[0]))
    if gfa_in is not None:
        if file_k is None and k is None:
            raise ValueError("GFA file does not declare k; pass k explicitly")
        if k is not None and file_k is not None and k != file_k:
            raise ValueError(f"GFA file k={file_k} conflicts with k={k}")
        return store, int(k if file_k is None else file_k), header, links
    return store, int(k), None, links
