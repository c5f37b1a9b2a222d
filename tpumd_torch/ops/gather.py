"""Row gather ``table[idx]``: the CUDA kernel, its wrapper and its plain
PyTorch version.

The kernel (``tpumd_torch/csrc/row_gather.cu``) replaces the TPU kernel
tools/probes/gather_probe.py::k_tala, a take_along_axis row gather.  Every
row gather of the matrix neighbor engine goes through ``gather_rows``: the
stencil's candidate cells and the candidates' coordinates in
``ops/neighbor.py::build_neighbors``, the neighbours' tags for the special
codes, and the packed j-side rows of ``ops/pairwise.py::pair_sums`` and the
granular sweep.  ``gather_rows`` launches the kernel for CUDA tensors and
takes the plain version only for CPU tensors; it never falls back from one
to the other.
"""

from __future__ import annotations

import ctypes

import torch

from tpumd_torch.ops import _build
from tpumd_torch.ops.lj_cellgrid import LaunchCounts

counts = LaunchCounts()

DTYPES = (torch.float32, torch.float64, torch.int32)
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P]


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor):
    """table[idx] in plain PyTorch."""
    return table[idx.long()]


def _check(table, idx):
    if (table.dim() != 2 or table.dtype not in DTYPES
            or not table.is_contiguous()):
        raise ValueError(f"gather_rows: table must be a contiguous 2-D "
                         f"tensor of {DTYPES}, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if (idx.dtype != torch.int32 or idx.dim() not in (1, 2)
            or not idx.is_contiguous() or idx.device != table.device):
        raise ValueError(f"gather_rows: idx must be a contiguous (M,) or "
                         f"(M, K) int32 tensor on {table.device}, got "
                         f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (T, L) at ``idx`` (M,) or (M, K) int32, every
    index in [0, T): a (M, L) or (M, K, L) tensor equal to table[idx]."""
    _check(table, idx)
    if table.device.type == "cpu":
        counts.plain_calls += 1
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: no kernel for device {table.device}")
    out = torch.empty(tuple(idx.shape) + (table.shape[1],),
                      dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    fn = _build.kernel_function("tpumd_row_gather", _ARGTYPES)
    dev = table.device
    with torch.cuda.device(dev):
        rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                idx.numel(), table.shape[1] * table.element_size(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row_gather kernel launch failed: CUDA error "
                           f"{rc}")
    counts.kernel_launches += 1
    return out
