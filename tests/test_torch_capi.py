"""The port's C ABI against the JAX package's: ``TigGraphBuilder.compute_tigs``
for every algorithm id, and a C host program linked against each package's
library (``matchtigs_tpu_torch/native/capi_embed.c`` and
``native/capi_embed.c``).  All comparisons are exact."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from matchtigs_tpu.capi import TigGraphBuilder as JBuilder
from test_c_abi import C_TEST
from matchtigs_tpu_torch import native, testing
from matchtigs_tpu_torch.capi import TigGraphBuilder as TBuilder
from matchtigs_tpu_torch.graph.build import build_bigraph_from_unitigs

REPO = Path(__file__).resolve().parent.parent
CASE = dict(genome_length=3000, k=9, seed=1)  # tests/test_capi.py's graph

# Reads "<unitigs> <k> <merges>", the unitig weights, then one merge per
# line "a strand_a b strand_b"; prints the tig count, then each tig's
# limit and its (signed unitig, insert) pairs.
C_HOST = r"""
#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>
#include <stddef.h>
extern void matchtigs_initialise(void);
extern void *matchtigs_initialise_graph(size_t);
extern void matchtigs_merge_nodes(void *, size_t, int, size_t, int);
extern void matchtigs_build_graph(void *, const size_t *);
extern size_t matchtigs_compute_tigs(void *, size_t, size_t, size_t,
                                     const char *, const char *, int64_t *,
                                     size_t *, size_t *);
int main(int argc, char **argv) {
  if (argc != 3) return 2;
  size_t algo = (size_t)atoi(argv[1]), n, k, m;
  FILE *f = fopen(argv[2], "r");
  if (!f || fscanf(f, "%zu %zu %zu", &n, &k, &m) != 3) return 2;
  matchtigs_initialise();
  void *h = matchtigs_initialise_graph(n);
  size_t *weights = malloc(n * sizeof *weights);
  for (size_t i = 0; i < n; ++i)
    if (fscanf(f, "%zu", &weights[i]) != 1) return 2;
  for (size_t i = 0; i < m; ++i) {
    size_t a, b;
    int sa, sb;
    if (fscanf(f, "%zu %d %zu %d", &a, &sa, &b, &sb) != 4) return 2;
    matchtigs_merge_nodes(h, a, sa, b, sb);
  }
  fclose(f);
  matchtigs_build_graph(h, weights);
  size_t cap = 8 * n + 64;
  int64_t *edges = malloc(cap * sizeof *edges);
  size_t *inserts = malloc(cap * sizeof *inserts);
  size_t *limits = malloc(cap * sizeof *limits);
  size_t tigs = matchtigs_compute_tigs(h, algo, 1, k, "", "", edges, inserts,
                                       limits);
  printf("tigs %zu\n", tigs);
  size_t prev = 0;
  for (size_t t = 0; t < tigs; ++t) {
    printf("%zu:", limits[t]);
    for (size_t i = prev; i < limits[t]; ++i)
      printf(" %lld/%zu", (long long)edges[i], inserts[i]);
    printf("\n");
    prev = limits[t];
  }
  return 0;
}
"""


def _graph():
    store, kmers, k = testing.make_unitig_store(**CASE)
    g = build_bigraph_from_unitigs(store, k)
    return store, k, testing.capi_merges(g)


def _build(cls, store, k, merges):
    builder = cls(len(store))
    for row in zip(*(col.tolist() for col in merges)):
        builder.merge_nodes(*row)
    builder.build_graph(store.lengths + 1 - k)
    return builder


@pytest.mark.parametrize("algo", [1, 2, 3, 4, 5])
def test_compute_tigs_identical_to_jax(algo):
    """Ids 4 and 5 on the port's device stage (plain torch versions on the
    CPU) and on its host engine, against the JAX package's default."""
    store, k, merges = _graph()
    want = _build(JBuilder, store, k, merges).compute_tigs(algo, k)
    runs = [dict(device="cpu")]
    if algo in (4, 5):
        runs.append(dict(engine="host"))
    for options in runs:
        got = _build(TBuilder, store, k, merges).compute_tigs(algo, k, **options)
        for g_col, w_col in zip(got, want):
            assert g_col.dtype == w_col.dtype and np.array_equal(g_col, w_col), options


@pytest.fixture(scope="module")
def c_hosts(tmp_path_factory):
    """(JAX executable, port executable, graph file, environment, and the
    two executables of tests/test_c_abi.py's program)."""
    if shutil.which("gcc") is None:
        pytest.skip("no C toolchain")
    tmp = tmp_path_factory.mktemp("torch_capi")

    def config(*flags):
        return subprocess.run(["python3-config", *flags], capture_output=True,
                              text=True, check=True).stdout.split()

    subprocess.run(
        ["gcc", "-shared", "-fPIC", "-O2", str(REPO / "native/capi_embed.c"),
         *config("--includes"), "-o", str(tmp / "libmatchtigs_tpu.so"),
         *config("--ldflags", "--embed")],
        check=True,
    )
    native.build_capi(tmp / "libmatchtigs_tpu_torch.so")
    exes = []
    for name, program in (("host", C_HOST), ("abi_test", C_TEST)):
        src = tmp / f"{name}.c"
        src.write_text(program)
        for lib in ("matchtigs_tpu", "matchtigs_tpu_torch"):
            exe = tmp / f"{name}_{lib}"
            subprocess.run(["gcc", "-O2", str(src), "-o", str(exe), f"-L{tmp}",
                            f"-l{lib}", *config("--ldflags", "--embed")], check=True)
            exes.append(exe)
    store, k, merges = _graph()
    graph = tmp / "graph.txt"
    lines = [f"{len(store)} {k} {len(merges[0])}",
             " ".join(map(str, (store.lengths + 1 - k).tolist()))]
    lines += [f"{a} {int(sa)} {b} {int(sb)}"
              for a, sa, b, sb in zip(*(col.tolist() for col in merges))]
    graph.write_text("\n".join(lines) + "\n")
    paths = [str(REPO)] + [p for p in sys.path if p and Path(p).is_dir()]
    env = {
        "PYTHONPATH": ":".join(paths),
        "JAX_PLATFORMS": "cpu",
        "LD_LIBRARY_PATH": str(tmp),
        "PATH": "/usr/bin:/bin",
        "HOME": str(tmp),
    }
    return exes[0], exes[1], graph, env, exes[2:]


def _run(exe, algo, graph, env):
    return subprocess.run([str(exe), str(algo), str(graph)], capture_output=True,
                          text=True, env=env, timeout=300)


@pytest.mark.parametrize("algo", [1, 2, 3])
def test_c_host_byte_identical_to_jax(c_hosts, algo):
    j_exe, t_exe, graph, env, _ = c_hosts
    want, got = (_run(exe, algo, graph, env) for exe in (j_exe, t_exe))
    assert want.returncode == got.returncode == 0, got.stderr[-2000:]
    assert got.stdout == want.stdout and not got.stdout.startswith("tigs 0\n")


@pytest.mark.parametrize("algo", [4, 5])
def test_c_host_without_a_card_reports_the_error(c_hosts, algo):
    """Ids 4 and 5 search on the card: without one the call prints the
    error and returns no tigs, never tigs from the host search."""
    _, t_exe, graph, env, _ = c_hosts
    got = _run(t_exe, algo, graph, env)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout == "tigs 0\n"
    assert "RuntimeError" in got.stderr and "no CUDA device" in got.stderr


def test_c_abi_program_byte_identical_to_jax(c_hosts):
    """tests/test_c_abi.py's own C program (eulertigs on three unitigs),
    linked against each library."""
    *_, env, abi_exes = c_hosts
    want, got = (subprocess.run([str(exe)], capture_output=True, text=True, env=env,
                                timeout=300) for exe in abi_exes)
    assert want.returncode == got.returncode == 0, got.stdout + got.stderr[-2000:]
    assert got.stdout == want.stdout and "C_ABI_OK" in got.stdout
