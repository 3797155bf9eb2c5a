# Copied from matchtigs_tpu/ops/candidates.py; the class docstring says how the port's greedy_accept consumes the columns; without its python fallbacks: the port requires the native library.
"""Column-oriented candidate shortest-path sets.

The candidate phase produces tens of millions of (out_node, in_node,
distance) rows at scale.  Keeping the three columns as separate
contiguous int64 arrays — instead of an interleaved [M, 3] matrix —
means every producer (the native Dijkstra buffers and the packed device
extraction both return column-blocked flat buffers) and every consumer
(the acceptance key packer, the matching collapse, ball-size counters)
works on unit-stride data.  The interleaved representation cost an extra
concat + column-split round trip (~10s + ~3s at 51M rows / 60M bases).

The reference streams candidates one at a time out of its per-thread
Dijkstra (``upstream src/implementation/greedytigs/mod.rs:324-341``)
so never materializes this set; the batched design makes the layout an
explicit choice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Candidates:
    """(u, v, d) candidate columns; u/v node ids, d the path distance.

    Columns are freshly-allocated contiguous int64 unless stated
    otherwise; `greedy_accept` consumes them (releases them as it packs).
    """

    u: np.ndarray
    v: np.ndarray
    d: np.ndarray

    def __len__(self) -> int:
        return len(self.u)

    def to_triples(self) -> np.ndarray:
        """Interleaved [M, 3] copy (tests / oracles / file dumps)."""
        out = np.empty((len(self.u), 3), dtype=np.int64)
        out[:, 0] = self.u
        out[:, 1] = self.v
        out[:, 2] = self.d
        return out

    @staticmethod
    def empty() -> "Candidates":
        e = np.empty(0, dtype=np.int64)
        return Candidates(e, e.copy(), e.copy())

    @staticmethod
    def from_triples(arr: np.ndarray) -> "Candidates":
        arr = np.asarray(arr, dtype=np.int64).reshape(-1, 3)
        return Candidates(
            np.ascontiguousarray(arr[:, 0]),
            np.ascontiguousarray(arr[:, 1]),
            np.ascontiguousarray(arr[:, 2]),
        )

    @staticmethod
    def concat(chunks: list["Candidates"]) -> "Candidates":
        """Concatenate per-column: contiguous block copies only.

        At scale the copies go through the native bulk-populated MT
        memcpy (extract.cpp:copy_i64_populated): the fresh destination
        otherwise pays lazy first-touch page faults one at a time, which
        on this class of virtualized host made a 1.2GB concat cost 10.5s
        for ~0.5s of actual copying."""
        if not chunks:
            return Candidates.empty()
        if len(chunks) == 1:
            return chunks[0]
        total = sum(len(c) for c in chunks)
        copy = None
        if total >= (1 << 22):
            import ctypes
            import os

            from .. import native

            lib = native.load()
            nt = min(os.cpu_count() or 1, 16)
            llp = ctypes.POINTER(ctypes.c_longlong)

            def copy(dst, off, src):
                dst_p = ctypes.cast(dst.ctypes.data + 8 * off, llp)
                lib.copy_i64_populated(dst_p, native.as_ll_ptr(src), len(src), nt)

        u = np.empty(total, dtype=np.int64)
        v = np.empty(total, dtype=np.int64)
        d = np.empty(total, dtype=np.int64)
        pos = 0
        for c in chunks:
            n = len(c)
            if copy is not None and n:
                copy(u, pos, np.ascontiguousarray(c.u, dtype=np.int64))
                copy(v, pos, np.ascontiguousarray(c.v, dtype=np.int64))
                copy(d, pos, np.ascontiguousarray(c.d, dtype=np.int64))
            else:
                u[pos : pos + n] = c.u
                v[pos : pos + n] = c.v
                d[pos : pos + n] = c.d
            pos += n
        return Candidates(u, v, d)
