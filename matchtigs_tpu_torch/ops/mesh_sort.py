"""Sort and merge-split of int64 keys: the two parts of the mesh's
acceptance sort (:func:`matchtigs_tpu_torch.parallel.mesh.sharded_accept_key_sort`).

A CUDA tensor launches ``csrc/mesh_sort.cu`` on the current stream without
synchronizing (``mesh_sort_launch``: a key-only LSD radix sort, 8 passes of
8-bit digits; ``mesh_merge_split_launch``: a merge path over half of the
outputs, a tile per block through shared memory); a CPU tensor runs the
plain torch version beside each.
"""

from __future__ import annotations

import torch

from .sssp import KERNEL_LAUNCHES, build_kernels

TILE = 4096  # keys per tile of the sort's scatter passes (kTileKeys)


def _check_keys(*keys: torch.Tensor) -> None:
    device = keys[0].device
    for k in keys:
        if k.dtype != torch.int64 or k.dim() != 1 or not k.is_contiguous():
            raise ValueError("keys must be contiguous 1-D int64 tensors")
        if k.device != device:
            raise ValueError("keys must be on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """``keys`` (int64 [n]) sorted ascending, as a new tensor on their
    device."""
    _check_keys(keys)
    if keys.device.type == "cpu":
        return sort_keys_plain(keys)
    n = keys.shape[0]
    out = torch.empty_like(keys)
    if n == 0:
        return out
    tmp = torch.empty_like(keys)
    lib = build_kernels()["mesh_sort"]
    state = torch.empty(
        (lib.mesh_sort_state_words(n),), dtype=torch.int64, device=keys.device
    )
    with torch.cuda.device(keys.device):
        err = lib.mesh_sort_launch(
            keys.data_ptr(), out.data_ptr(), tmp.data_ptr(), state.data_ptr(), n,
            _stream(keys.device),
        )
    if err != 0:
        raise RuntimeError(f"mesh_sort_launch failed: cudaError {err}")
    KERNEL_LAUNCHES["mesh_sort"] += 1
    return out


def sort_keys_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`sort_keys`."""
    _check_keys(keys)
    return torch.sort(keys).values


def merge_split(a: torch.Tensor, b: torch.Tensor, keep_high: bool) -> torch.Tensor:
    """The low half (or with ``keep_high`` the high half) of the merge of
    two sorted int64 blocks of one length L: L keys, sorted, as a new
    tensor on their device."""
    _check_keys(a, b)
    if a.shape != b.shape:
        raise ValueError("the two blocks must have one length")
    if a.device.type == "cpu":
        return merge_split_plain(a, b, keep_high)
    L = a.shape[0]
    out = torch.empty_like(a)
    if L == 0:
        return out
    lib = build_kernels()["mesh_sort"]
    with torch.cuda.device(a.device):
        err = lib.mesh_merge_split_launch(
            a.data_ptr(), b.data_ptr(), L, int(keep_high), out.data_ptr(),
            _stream(a.device),
        )
    if err != 0:
        raise RuntimeError(f"mesh_merge_split_launch failed: cudaError {err}")
    KERNEL_LAUNCHES["mesh_merge_split"] += 1
    return out


def merge_split_plain(a: torch.Tensor, b: torch.Tensor, keep_high: bool) -> torch.Tensor:
    """Plain torch version of :func:`merge_split`."""
    _check_keys(a, b)
    L = a.shape[0]
    merged = torch.sort(torch.cat([a, b])).values
    return (merged[L:] if keep_high else merged[:L]).contiguous()
