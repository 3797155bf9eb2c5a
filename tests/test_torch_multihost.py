"""Two processes of one gloo group run the port's mesh path on the CPU.

The test starts this file's own ``__main__`` twice (it imports only the
port, never jax).  Each process joins the group with
``initialize_distributed``, runs the sharded search stage (K6) over a mesh
of 4 CPU shards per process (8 in all), then greedy matchtigs with
``use_mesh=True`` on one CPU shard each, on the same graph and on one
with many components: the host-routed and overflow-tail
Dijkstra on its slice of the sources, the acceptance sort's merge-split
across the two processes (K7) and the per-component Euler split.  Both
must give the same candidates and walks, equal to the JAX package's
single-process candidates and to the port's host engine.

    python tests/test_torch_multihost.py <rank> <world> <port> <out.npz>
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
GRAPH = dict(genome_length=5000, k=11, seed=0)  # tests/test_multihost.py's
# the golden pangenome of tests/test_golden_outputs.py: 152 tigs, so the
# Euler split deals many components over the two processes
TIG_GRAPH = dict(genome_length=20000, k=13, n_strains=4, mutation_rate=0.02,
                 seed=11, with_repeats=True)
SHARDS_PER_PROCESS = 4


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker(rank: int, world: int, port: int, out: str) -> None:
    sys.path.insert(0, str(REPO))
    from matchtigs_tpu_torch import testing
    from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig, compute_greedytigs
    from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs
    from matchtigs_tpu_torch.ops.device_graph import build_device_graph
    from matchtigs_tpu_torch.ops.matching import unbalanced_nodes
    from matchtigs_tpu_torch.ops.sssp import extract_packed_candidates
    from matchtigs_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
        sharded_bounded_sssp,
    )

    initialize_distributed(f"localhost:{port}", world, rank, timeout_s=120)
    store, _, k = testing.make_unitig_store(**GRAPH)
    g = build_bigraph_from_unitigs(store, k)
    dg = build_device_graph(g)
    out_nodes, in_mask, _ = unbalanced_nodes(g)
    mask = np.zeros(dg.n_nodes + 1, dtype=bool)
    mask[: len(in_mask)] = in_mask

    mesh = make_mesh(["cpu"] * SHARDS_PER_PROCESS)
    packed, dist, overflow, srcs = sharded_bounded_sssp(
        dg, out_nodes, k - 1, 256, mesh
    )
    assert dist is None
    real = srcs != dg.n_nodes
    cands = extract_packed_candidates(dg, packed, srcs, real & ~overflow, mask)
    order = np.lexsort((cands.d, cands.v, cands.u))

    config = dict(engine="device", device="cpu", use_mesh=True, initial_capacity=4,
                  overflow_mode="host", host_route_threshold=1)
    tigs = compute_greedytigs(g.copy(), GreedytigConfig(k=k, **config))
    tstore, _, tk = testing.make_pangenome_store(**TIG_GRAPH)
    many = compute_greedytigs(build_bigraph_from_unitigs(tstore, tk),
                              GreedytigConfig(k=tk, **config))
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "matchtigs_tpu"))
    assert not leaked, leaked
    np.savez(out, u=cands.u[order], v=cands.v[order], d=cands.d[order],
             n_shards=mesh.size, tigs_flat=tigs.flat, tigs_offsets=tigs.offsets,
             many_flat=many.flat, many_offsets=many.offsets)
    import torch.distributed as dist_mod

    dist_mod.destroy_process_group()


def test_two_process_mesh(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    outs = [tmp_path / f"rank{i}.npz" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(i), "2", str(port), str(outs[i])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode(errors="replace"))
    finally:
        for p in procs:  # a rank that failed leaves the other waiting
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"

    res = [np.load(o) for o in outs]
    assert int(res[0]["n_shards"]) == 2 * SHARDS_PER_PROCESS
    for key in ("u", "v", "d", "tigs_flat", "tigs_offsets", "many_flat", "many_offsets"):
        assert np.array_equal(res[0][key], res[1][key]), key

    # the JAX package's single-process stage on the same graph
    from matchtigs_tpu import testing as jtesting
    from matchtigs_tpu.graph.build import build_bigraph_from_unitigs as j_build
    from matchtigs_tpu.ops.device_graph import build_device_graph as j_device_graph
    from matchtigs_tpu.ops.matching import unbalanced_nodes as j_unbalanced
    from matchtigs_tpu.ops.sssp import batched_bounded_sssp, extract_packed_candidates

    store, _, k = jtesting.make_unitig_store(**GRAPH)
    jg = j_build(store, k)
    jdg = j_device_graph(jg)
    out_nodes, in_mask, _ = j_unbalanced(jg)
    mask = np.zeros(jdg.n_nodes + 1, dtype=bool)
    mask[: len(in_mask)] = in_mask
    sources = np.asarray(out_nodes, dtype=np.int32)
    packed, _, over = batched_bounded_sssp(
        jdg, sources, max_weight=k - 1, capacity=256, return_packed=True
    )
    cands = extract_packed_candidates(jdg, packed, sources, ~over, mask)
    order = np.lexsort((cands.d, cands.v, cands.u))
    for key in ("u", "v", "d"):
        assert np.array_equal(res[0][key], getattr(cands, key)[order]), key

    # the port's host engine in this process, on both graphs
    from matchtigs_tpu_torch import testing as ttesting
    from matchtigs_tpu_torch.algos.greedytigs import GreedytigConfig, compute_greedytigs
    from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs as t_build

    for name, (tstore, _, tk) in (("tigs", ttesting.make_unitig_store(**GRAPH)),
                                  ("many", ttesting.make_pangenome_store(**TIG_GRAPH))):
        host = compute_greedytigs(t_build(tstore, tk), GreedytigConfig(k=tk, engine="host"))
        assert np.array_equal(res[0][f"{name}_flat"], host.flat), name
        assert np.array_equal(res[0][f"{name}_offsets"], host.offsets), name
    assert len(res[0]["many_offsets"]) == 152


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
