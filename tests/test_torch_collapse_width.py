"""The packed candidate collapse at ids of 24 to 26 bits.

``algos/matchtigs.py:_collapse_candidates`` packs each expanded row into
one int64, ``lo<<(idb+10) | hi<<10 | w<<3 | o<<2 | su<<1 | sv``, with the
smallest id width ``idb`` (23 to 26) that holds the instance's ids, and
takes the argsort route only where no such width does (past 2^26 ids) or
a weight reaches 128.  Here: the packing passes (native and numpy) and
both dedup passes at ``idb`` 24, 25 and 26 on ids up to ``2^idb - 1`` and
weights up to 127, against rows expanded and deduplicated independently;
and the route the collapse takes at the boundaries of the id count and
the weight, as its ``collapse.expand`` span counts it (``id_bits``),
with the five columns of the JAX package's packed route at the true id
count on every route."""

import mmap

import numpy as np
import pytest
import torch
from test_torch_matchtigs_large import _candidates, _graphs

from matchtigs_tpu.algos import matchtigs as j_matchtigs
from matchtigs_tpu_torch.algos import matchtigs as t_matchtigs
from matchtigs_tpu_torch.ops.candidates import Candidates
from matchtigs_tpu_torch.utils import tracing

N_CLASSES = 24  # node classes: node 2c is canonical, 2c + 1 its mirror


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _instance(idb, n_cand, seed):
    """Candidates over ``N_CLASSES`` node classes whose ids (1-4 a class,
    shared by a node and its mirror) lie half at the bottom of the id
    range and half at its top, the last id ``2^idb - 1``; weights 1-127.
    Returns the candidates' columns, the id layout, the canonical flags,
    the mirrors and ``node_of_id``, an array of ``2^idb`` ids of which
    only the used ones are written (an anonymous mapping: the pages never
    written stay unbacked)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 5, N_CLASSES)
    low = N_CLASSES // 2
    starts = np.empty(N_CLASSES, dtype=np.int64)
    starts[:low] = np.cumsum(counts[:low]) - counts[:low]
    top = np.cumsum(counts[low:][::-1])[::-1]
    starts[low:] = (1 << idb) - top
    n_nodes = 2 * N_CLASSES
    nodes = np.arange(n_nodes, dtype=np.int64)
    mirror = nodes ^ 1
    is_canon = nodes <= mirror
    ids_start = starts[nodes // 2]
    ids_count = counts[nodes // 2].astype(np.int64)
    u = rng.integers(0, n_nodes, n_cand)
    v = rng.integers(0, n_nodes, n_cand)
    w = rng.integers(1, 128, n_cand)
    w[:2] = 127
    # the last id of the range in a row of weight 127
    u[0] = v[1] = 2 * N_CLASSES - 2
    mapped = mmap.mmap(-1, 8 << idb)
    node_of_id = np.frombuffer(mapped, dtype=np.int64)
    for c in range(N_CLASSES):
        node_of_id[starts[c]:starts[c] + counts[c]] = 2 * c
    return (u, v, w), ids_start, ids_count, is_canon, mirror, node_of_id


def _reference_rows(u, v, w, ids_start, ids_count, is_canon):
    """Every (lo, hi, w, o, su, sv) row of the candidates' id products,
    expanded one candidate at a time, sorted."""
    rows = []
    for uc, vc, wc in zip(u.tolist(), v.tolist(), w.tolist()):
        for i in range(int(ids_count[uc])):
            for j in range(int(ids_count[vc])):
                a, b = int(ids_start[uc]) + i, int(ids_start[vc]) + j
                rows.append((min(a, b), max(a, b), wc, int(a <= b),
                             int(is_canon[uc]), int(is_canon[vc])))
    return np.array(sorted(rows), dtype=np.int64)


def _reference_dedup(rows, node_of_id, mirror):
    """Per id pair the first (least) row, self pairs dropped, each pair's
    out and in node resolved: (lo, hi, w, u, v)."""
    lo, hi, w, o, su, sv = rows.T
    first = np.ones(len(rows), dtype=bool)
    first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    keep = first & (lo != hi)
    lo, hi, w, o, su, sv = (c[keep] for c in (lo, hi, w, o, su, sv))
    a, b = node_of_id[lo], node_of_id[hi]
    u_can = np.where(o == 1, a, b)
    v_can = np.where(o == 1, b, a)
    return (lo, hi, w, np.where(su == 1, u_can, mirror[u_can]),
            np.where(sv == 1, v_can, mirror[v_can]))


@pytest.mark.parametrize("n_cand", [3_000, 60_000])
@pytest.mark.parametrize("idb", [24, 25, 26])
def test_wide_packed_rows_sort_and_round_trip(idb, n_cand):
    """The rows of both packing passes: equal, non-negative, ascending as
    ``(lo, hi, w, o, su, sv)`` and unpacking to the independently expanded
    rows, the last id ``2^idb - 1`` and the weight 127 among them; both
    dedup passes (the fused native one from 2^18 rows, and dedup, unpack
    and resolve) emit the first row of each id pair with its out and in
    node, which are the nodes of a candidate of that weight."""
    (u, v, w), ids_start, ids_count, is_canon, mirror, node_of_id = _instance(
        idb, n_cand, seed=idb)
    packed = t_matchtigs._expand_pack_native(u, v, w, ids_start, ids_count, is_canon, idb)
    assert np.array_equal(
        packed, t_matchtigs._expand_pack_numpy(u, v, w, ids_start, ids_count, is_canon, idb))
    assert packed.min() >= 0 and np.all(packed[1:] >= packed[:-1])
    want = _reference_rows(u, v, w, ids_start, ids_count, is_canon)
    unpacked = np.stack([packed >> (idb + 10), (packed >> 10) & ((1 << idb) - 1),
                         (packed >> 3) & 127, (packed >> 2) & 1, (packed >> 1) & 1,
                         packed & 1], axis=1)
    assert np.array_equal(unpacked, want)
    assert want[:, 1].max() == (1 << idb) - 1 and want[:, 2].max() == 127
    assert want[:, 0].min() == 0

    ref = _reference_dedup(want, node_of_id, mirror)
    fused = t_matchtigs._dedup_resolve_native(packed, node_of_id, mirror, idb)
    assert (fused is None) == (len(packed) < (1 << 18))
    for res in (fused, t_matchtigs._dedup_unpack_resolve(packed, node_of_id, mirror, idb)):
        if res is None:
            continue
        for column, g_col, w_col in zip(("lo", "hi", "w", "u", "v"), res, ref):
            assert np.array_equal(g_col, w_col), column
    lo, hi, wk, ur, vr = ref
    assert len(lo) and hi.max() == (1 << idb) - 1
    cand_keys = (u * len(mirror) + v) * 128 + w
    assert np.isin((ur * len(mirror) + vr) * 128 + wk, cand_keys).all()


@pytest.mark.parametrize("given, weight_shift, id_bits", [
    ((1 << 23) - 1, 0, 23),
    (1 << 23, 0, 23),  # ids 0 .. 2^23 - 1 fit 23 bits
    ((1 << 23) + 1, 0, 24),
    ((1 << 25) + 1, 0, 26),
    (1 << 26, 0, 26),
    ((1 << 26) + 1, 0, 0),
    (0, 128, 0),
    ((1 << 23) + 1, 128, 0),
])
def test_route_by_id_count_and_weight(monkeypatch, given, weight_shift, id_bits):
    """``collapse.expand`` counts the packed row's id width, or 0 on the
    argsort route, for the id count given (at least the true one) and the
    weights (raised by ``weight_shift``); the five columns are those of
    the JAX package's packed route at the true id count."""
    jg, tg, _, _, _ = _graphs("golden-pangenome")
    ids_start, ids_count, n_ids, _, _ = t_matchtigs._matching_node_ids(tg, tg.imbalances())
    host = _candidates("golden-pangenome", "host")
    want = list(j_matchtigs._collapse_candidates(jg, host, ids_start, ids_count, n_ids))
    want[2] = want[2] + weight_shift
    spans = []
    monkeypatch.setattr(tracing, "sink", spans.append)
    # the port's collapse empties the candidates it is given: it gets a copy
    cands = Candidates(host.u.copy(), host.v.copy(), host.d + weight_shift)
    got = t_matchtigs._collapse_candidates(tg, cands, ids_start, ids_count,
                                           max(n_ids, given))
    expand = [s.counters for s in spans if s.name == "collapse.expand"]
    assert expand == [dict(rows=expand[0]["rows"], id_bits=id_bits)]
    assert len(got[0]) > 0
    for column, g_col, w_col in zip(("lo", "hi", "w", "u", "v"), got, want):
        assert np.array_equal(g_col, w_col), column
