# Copied from matchtigs_tpu/utils/malloc_tuning.py; the module docstring names the port's caller.
"""Host allocator tuning for array-churn workloads.

The pipeline's hot phases allocate and free tens-of-MB numpy arrays in
quick succession (candidate triples, sort keys, CSR scratch).  glibc
serves allocations above its mmap threshold with fresh mmap/munmap pairs,
so every such array pays a first-touch page-fault storm: measured at
bench scale (5.2M candidates), the acceptance phase alone dropped from
3.5s to 0.24s once freed arenas were reused.

``tune_malloc()`` raises the mmap threshold via ``mallopt`` so large
blocks come from the (reused) heap arena.  Trade-off: freed memory is
returned to the OS lazily, so peak RSS reporting is stickier.  Called by
the CLI; library users opt in explicitly.

The reference avoids the problem class by reusing per-thread Rust Vecs
(upstream src/implementation/greedytigs/mod.rs:276-341); this is
the flat-numpy analog.
"""

from __future__ import annotations

import ctypes
import logging
import sys

logger = logging.getLogger(__name__)

_M_TRIM_THRESHOLD = -1  # malloc.h: M_TRIM_THRESHOLD
_M_MMAP_THRESHOLD = -3  # malloc.h: M_MMAP_THRESHOLD

_INT_MAX = (1 << 31) - 1  # mallopt takes C int

_done = False


def tune_malloc(mmap_threshold: int = _INT_MAX) -> bool:
    """Keep malloc'd pages resident for the process lifetime.

    Two knobs, both needed: M_MMAP_THRESHOLD at INT_MAX so even GB-scale
    blocks (candidate columns, native triple buffers) come from the heap
    arena instead of fresh mmap/munmap pairs, and M_TRIM_THRESHOLD at
    INT_MAX so freeing a block at the heap top does not shrink the heap.
    Without both, every repetition re-faults its big arrays; on this
    class of virtualized host a first-touch fault storm over 1.2 GB
    measured anywhere from 0.4s to 39s (host-side page ballooning).

    Trade-off: RSS stays at peak. Safe to call repeatedly (applies once)
    and a no-op on non-glibc platforms.
    """
    global _done
    if _done:
        return True
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, mmap_threshold))
        ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, _INT_MAX)) and ok
    except OSError:  # non-glibc libc
        return False
    if ok:
        _done = True
    else:
        logger.debug("mallopt(M_MMAP_THRESHOLD/M_TRIM_THRESHOLD) rejected")
    return ok


_MADV_POPULATE_WRITE = 23  # linux 5.14+


def prewarm_heap(n_bytes: int, chunk: int = 1 << 30) -> bool:
    """Pre-fault ~n_bytes of heap arena with bulk page population.

    Large numpy allocations otherwise pay first-touch page faults one at
    a time; on this class of virtualized host a cold 1.2 GB fill measured
    anywhere from 0.4s to 39s, while MADV_POPULATE_WRITE populates the
    same range in ~1s of one syscall.  Chunks stay below the (raised)
    mmap threshold so they extend the reusable heap arena, and with
    M_TRIM_THRESHOLD at INT_MAX the pages stay resident after free.

    Call after tune_malloc(), sized to the expected peak working set.
    Returns True if population succeeded (False = unsupported kernel or
    allocation failure; harmless, first-touch just happens lazily).
    """
    if not tune_malloc():
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.malloc.restype = ctypes.c_void_p
        libc.free.argtypes = [ctypes.c_void_p]
    except OSError:
        return False
    ok = True
    ptrs = []
    remaining = int(n_bytes)
    while remaining > 0:
        size = min(chunk, remaining)
        p = libc.malloc(ctypes.c_size_t(size))
        if not p:
            ok = False
            break
        # madvise needs a page-aligned range; align inside the block
        aligned = (p + 4095) & ~4095
        alen = (size - (aligned - p)) & ~4095
        if alen <= 0 or libc.madvise(
            ctypes.c_void_p(aligned), ctypes.c_size_t(alen),
            _MADV_POPULATE_WRITE,
        ) != 0:
            ok = False  # pre-5.14 kernel: fall back to lazy faulting
            libc.free(ctypes.c_void_p(p))
            break
        ptrs.append(p)
        remaining -= size
    for p in ptrs:
        libc.free(ctypes.c_void_p(p))
    return ok and remaining <= 0


def available_memory_bytes() -> int | None:
    """MemAvailable from /proc/meminfo, or None when unavailable."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None
