# Copied from matchtigs_tpu/io/writers.py; without its python fallbacks: the port requires the native library.
"""Tig materialization: spell edge walks into sequences and write outputs.

Capability-equivalent of the reference's walk writers
(fasta: upstream src/bin.rs:418-606, GFA: :608-818, duplication
bitvectors: upstream src/implementation/mod.rs:651-702), with the
same splicing semantics:

- the first edge contributes its full oriented sequence;
- a following *original* edge contributes its oriented sequence minus an
  overlap prefix of ``k-1`` characters — or ``k-1-w`` characters if the
  preceding edge was a cheap dummy of weight ``w`` (the dummy "pre-spells"
  w of the overlap) (upstream src/bin.rs:533-537);
- dummy edges themselves contribute nothing;
- backward edges take the reverse complement, trimming the overlap from the
  sequence *tail* before reversing (upstream src/bin.rs:567-597).

Gzip output is selected by a ``.gz`` extension with a configurable
compression level, like the reference (upstream src/bin.rs:200-218).
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from ..graph.bigraph import Bigraph
from ..utils import dna
from ..utils.tracing import span
from .sequence_store import SequenceStore


def spell_walk(
    g: Bigraph, walk: np.ndarray, store: SequenceStore, k: int
) -> np.ndarray:
    """Spell one edge walk into a DNA code array (uint8 values 0..3)."""
    walk = np.asarray(walk)
    handles = g.handles()
    forwards = g.forwards()
    weights = g.weights()
    dummies = g.is_dummy()

    first = int(walk[0])
    assert not dummies[first], "walk must start with an original edge"
    parts: list[np.ndarray] = []
    seq = store.get(int(handles[first]))
    parts.append(seq if forwards[first] else dna.revcomp(seq))

    prev = first
    for cur in walk[1:].tolist():
        if dummies[cur]:
            prev = cur
            continue
        offset = k - 1 if not dummies[prev] else k - 1 - int(weights[prev])
        seq = store.get(int(handles[cur]))
        if forwards[cur]:
            parts.append(seq[offset:])
        else:
            parts.append(dna.revcomp(seq[: len(seq) - offset]))
        prev = cur
    return np.concatenate(parts)


def spelled_length(g: Bigraph, walk: np.ndarray, k: int) -> int:
    """Length of the spelled walk without materializing it.

    (k-1) + sum of original-edge weights + sum of cheap-dummy weights:
    each cheap dummy of weight w makes the next edge contribute w extra
    characters (offset k-1-w instead of k-1).
    """
    walk = np.asarray(walk)
    w = g.weights()[walk]
    d = g.is_dummy()[walk]
    return int(k - 1 + w[~d].sum() + w[d].sum())


def spell_walks_flat(
    g: Bigraph, walks: Sequence[np.ndarray], store: SequenceStore, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Spell many walks at once: (flat codes, per-walk end offsets).

    The native multithreaded speller (native/tigs.cpp); the tests hold
    it against the JAX package's writers and the per-walk
    :func:`spell_walk`."""
    if not len(walks):
        return np.empty(0, np.uint8), np.empty(0, np.int64)
    from .. import native
    from ..ops.walks import Walks

    lib = native.load()

    wk = Walks.from_list(walks)  # no-op when walks is already flat
    flat = np.ascontiguousarray(wk.flat, dtype=np.int64)
    walk_off = np.ascontiguousarray(wk.offsets, dtype=np.int64)
    E = g.n_edges
    handle = np.ascontiguousarray(g.handles()[:E], dtype=np.int64)
    weight = np.ascontiguousarray(g.weights()[:E], dtype=np.int64)
    forward = np.ascontiguousarray(g.forwards()[:E], dtype=np.int8)
    dummy = np.ascontiguousarray(g.is_dummy()[:E], dtype=np.int8)
    packed = np.ascontiguousarray(store.packed, dtype=np.uint8)
    seq_off = np.ascontiguousarray(store.offsets, dtype=np.int64)
    # total spelled length = (k-1) per walk + every edge's weight
    # (cheap dummies contribute their weight through the next edge's
    # reduced overlap; breaking dummies never appear inside walks); the
    # same closed form gives per-walk output starts, so the speller runs
    # multithreaded over disjoint output regions.
    import os

    per_walk = np.empty(len(walks), dtype=np.int64)
    starts = np.concatenate([[0], walk_off[:-1]])
    sums = np.add.reduceat(weight[flat], starts) if len(flat) else per_walk[:0]
    per_walk[:] = (k - 1) + sums
    walk_out_start = np.zeros(len(walks), dtype=np.int64)
    np.cumsum(per_walk[:-1], out=walk_out_start[1:])
    total = int(walk_out_start[-1] + per_walk[-1])
    out = np.empty(total, dtype=np.uint8)
    out_off = np.empty(len(walks), dtype=np.int64)
    n_threads = max(1, min(os.cpu_count() or 1, len(walks) // 1024))
    p = native.as_ll_ptr
    written = lib.spell_walks_packed_mt(
        p(flat),
        p(walk_off),
        len(walks),
        p(handle),
        p(weight),
        native.as_i8_ptr(forward),
        native.as_i8_ptr(dummy),
        native.as_u8_ptr(packed),
        p(seq_off),
        k,
        native.as_u8_ptr(out),
        p(out_off),
        p(walk_out_start),
        n_threads,
    )
    if written != total:
        raise AssertionError(
            f"native speller wrote {written} of {total} expected chars"
        )
    return out, out_off


def _open_out(path: str | Path, compression_level: int = 6):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "wb", compresslevel=compression_level)
    return open(path, "wb")


def write_spell_debug(
    g: Bigraph,
    walks: Sequence[np.ndarray],
    store: SequenceStore,
    k: int,
    path: str | Path,
) -> None:
    """Per-edge spell annotations, one ``tig N`` block per walk — the
    reference writers' optional debug channel
    (upstream src/bin.rs:493-524,543-589 ``debug_writer``):

    ``| <edge><f|r> <full first sequence>`` for the first edge,
    ``| skip dummy <edge> weight <w>`` for dummies, and
    ``| <edge><f|r>:off <offset> <spelled part>`` for following originals.
    """
    handles = g.handles()
    forwards = g.forwards()
    weights = g.weights()
    dummies = g.is_dummy()
    with span("write.debug"), open(path, "wb") as f:
        for i, walk in enumerate(walks):
            walk = np.asarray(walk)
            f.write(b"tig %d\n" % (i + 1))
            first = int(walk[0])
            seq = store.get(int(handles[first]))
            spelled = seq if forwards[first] else dna.revcomp(seq)
            f.write(
                b"| %d%s %s "
                % (
                    first,
                    b"f" if forwards[first] else b"r",
                    dna.decode_to_ascii(spelled),
                )
            )
            prev = first
            for cur in walk[1:].tolist():
                if dummies[cur]:
                    f.write(
                        b"| skip dummy %d weight %d "
                        % (cur, int(weights[cur]))
                    )
                    prev = cur
                    continue
                offset = (
                    k - 1 if not dummies[prev] else k - 1 - int(weights[prev])
                )
                seq = store.get(int(handles[cur]))
                part = (
                    seq[offset:]
                    if forwards[cur]
                    else dna.revcomp(seq[: len(seq) - offset])
                )
                f.write(
                    b"| %d%s:off %d %s "
                    % (
                        cur,
                        b"f" if forwards[cur] else b"r",
                        offset,
                        dna.decode_to_ascii(part),
                    )
                )
                prev = cur
            f.write(b"\n")


def _record_bytes(n: int, per_record: int) -> int:
    """Bytes of ``n`` records numbered from 1, each ``per_record`` bytes
    besides its number's digits and its sequence."""
    total, power = per_record * n, 1
    while power <= n:
        total += n - power + 1  # one more digit for each number >= power
        power *= 10
    return total


def _spell(g, walks, store, k) -> tuple[np.ndarray, np.ndarray]:
    """``spell_walks_flat`` under the ``write.spell`` span."""
    with span("write.spell") as sp:
        flat, offsets = spell_walks_flat(g, walks, store, k)
        sp.add(characters=len(flat))
    return flat, offsets


def write_walks_fasta(
    g: Bigraph,
    walks: Sequence[np.ndarray],
    store: SequenceStore,
    k: int,
    path: str | Path,
    compression_level: int = 6,
    debug_path: str | Path | None = None,
) -> None:
    """Write walks as fasta records ``>1``, ``>2``, ... like the reference
    (upstream src/bin.rs:492); `debug_path` additionally writes
    per-edge spell annotations (bin.rs debug_writer)."""
    flat, offsets = _spell(g, walks, store, k)
    with span("write.records") as sp, _open_out(path, compression_level) as f:
        prev = 0
        for i, end in enumerate(offsets.tolist()):
            f.write(b">%d\n" % (i + 1))
            f.write(dna.decode_to_ascii(flat[prev:end]))
            f.write(b"\n")
            prev = end
        if sp:  # counted, not asked of the file: a pipe cannot tell()
            sp.add(tigs=len(offsets), bytes=_record_bytes(len(offsets), 3) + len(flat))
    if debug_path is not None:
        write_spell_debug(g, walks, store, k, debug_path)


def write_walks_gfa(
    g: Bigraph,
    walks: Sequence[np.ndarray],
    store: SequenceStore,
    k: int,
    header: str | None,
    path: str | Path,
    compression_level: int = 6,
    debug_path: str | Path | None = None,
) -> None:
    """Write walks as GFA segments with the input header (or ``H KL:Z:k``),
    mirroring upstream src/bin.rs:688-704; `debug_path` additionally
    writes per-edge spell annotations."""
    flat, offsets = _spell(g, walks, store, k)
    with span("write.records") as sp, _open_out(path, compression_level) as f:
        hdr = (header if header is not None else f"H\tKL:Z:{k}").encode() + b"\n"
        f.write(hdr)
        prev = 0
        for i, end in enumerate(offsets.tolist()):
            f.write(b"S\t%d\t" % (i + 1))
            f.write(dna.decode_to_ascii(flat[prev:end]))
            f.write(b"\n")
            prev = end
        if sp:
            sp.add(tigs=len(offsets),
                   bytes=len(hdr) + _record_bytes(len(offsets), 4) + len(flat))
    if debug_path is not None:
        write_spell_debug(g, walks, store, k, debug_path)


def write_duplication_bitvector(
    g: Bigraph,
    walks: Iterable[np.ndarray],
    path: str | Path,
    compression_level: int = 6,
) -> None:
    """ASCII bitvector per walk: '1' per original k-mer, '0' per duplicated
    (dummy) k-mer, repeated ``weight`` times per edge
    (upstream src/implementation/mod.rs:671-702)."""
    weights = g.weights()
    dummies = g.is_dummy()
    with span("write.bitvector"), _open_out(path, compression_level) as f:
        for walk in walks:
            walk = np.asarray(walk)
            if len(walk) == 0:
                raise ValueError("empty walk in duplication bitvector output")
            chars = np.where(dummies[walk], ord("0"), ord("1")).astype(np.uint8)
            reps = weights[walk].astype(np.int64)
            f.write(np.repeat(chars, reps).tobytes())
            f.write(b"\n")
