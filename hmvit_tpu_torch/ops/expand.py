"""Dense-grid expansion of compacted per-pillar rows (port of
``hmvit_tpu/ops/expand.py``).

The pillar path reduces points to one row per non-empty pillar, sorted
by cell id; the dense (cells, C) BEV grid is those rows placed at their
cells and zeros elsewhere.  :func:`expand_rows_to_dense` (v1) and
:func:`expand_rows_to_dense_v2` launch the two CUDA kernels of
``csrc/expand.cu`` (the replacements of the Pallas ``_expand_kernel`` and
``_expand_v2_kernel``; one slice template, the two differ only in how a
thread block finds its rows) for CUDA tensors and run
:func:`expand_rows_to_dense_plain` — searchsorted + gather, the JAX
package's oracle — for CPU tensors or under
:func:`hmvit_tpu_torch.ops.plain_ops`.  All three are pure placement and
agree bit for bit.

On a CUDA tensor the kernel is the only route: a launch that fails
raises.  Dropped from the JAX package: the ``num_cells % 4096 == 0``
precondition, which came from the Pallas kernels' slab layout (the last
block or sub-block may be short here, and the kernels stop at
``num_cells``), and v2's ``C <= 125`` limit, which came from packing
byte-split ids into the rows' spare lanes for the TPU's copy engine; here
ids, rows and tables go to the kernel as they are, and any grid and any C
of an even number of bytes per row runs.

The tables (``r0``: first row at or after each 4096-cell block start;
``r0s``: the same per 128-cell sub-block; one entry per started block
and a last one for ``num_cells``) are built here with
``torch.searchsorted``, outside the kernels, as the JAX wrappers build
theirs outside ``pallas_call``.  Forward only, like the Pallas kernels.
"""
from __future__ import annotations

import torch

from . import cuda, use_kernel

BLOCK = 4096  # cells per block of the v1 table
SUB = 128     # cells per sub-block of the v2 table


def expand_rows_to_dense_plain(comp, comp_ids, num_cells: int):
    """Plain version: comp (M, C) sorted by comp_ids (M,) (fill rows carry
    id >= num_cells) -> (num_cells, C), rows placed, zeros elsewhere."""
    m, c = comp.shape
    if m == 0:
        return torch.zeros((num_cells, c), dtype=comp.dtype,
                           device=comp.device)
    cells = torch.arange(num_cells, dtype=comp_ids.dtype,
                         device=comp_ids.device)
    pos = torch.clamp(torch.searchsorted(comp_ids, cells), max=m - 1)
    hit = comp_ids[pos] == cells
    return torch.where(hit[:, None], comp[pos],
                       torch.zeros((), dtype=comp.dtype, device=comp.device))


def expand_rows_launch(comp, comp_ids, num_cells: int, v2: bool = False):
    """Validate and lay out one launch of the v1 (or v2) kernel: returns
    (launch, out) where ``launch()`` runs the kernel into ``out``
    (num_cells, C).  The table is built here, once."""
    if comp.ndim != 2 or tuple(comp_ids.shape) != (comp.shape[0],):
        raise ValueError(f"expand: rows {tuple(comp.shape)} and ids "
                         f"{tuple(comp_ids.shape)} do not fit")
    if num_cells < 0:
        raise ValueError(f"expand: num_cells {num_cells}")
    if comp.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("the expansion kernels are forward only")
    row_bytes = comp.shape[1] * comp.element_size()
    if row_bytes == 0 or row_bytes % 2:
        raise ValueError(f"expand: rows of {row_bytes} bytes")
    comp = comp.contiguous()
    if comp.data_ptr() % 16:
        comp = comp.clone()
    ids = comp_ids.to(torch.int32).contiguous()
    step = SUB if v2 else BLOCK
    starts = torch.arange(0, num_cells + step, step, dtype=torch.int32,
                          device=ids.device).clamp_(max=num_cells)
    table = torch.searchsorted(ids, starts, out_int32=True)
    out = torch.empty((num_cells, comp.shape[1]), dtype=comp.dtype,
                      device=comp.device)
    kernel = cuda.EXPAND_ROWS_V2 if v2 else cuda.EXPAND_ROWS
    return (lambda: kernel.launch([comp, ids, table, out],
                                  [row_bytes, num_cells]), out)


def _expand(comp, comp_ids, num_cells: int, v2: bool):
    if use_kernel(comp):
        launch, out = expand_rows_launch(comp, comp_ids, num_cells, v2)
        launch()
        return out
    return expand_rows_to_dense_plain(comp, comp_ids, num_cells)


def expand_rows_to_dense(comp, comp_ids, num_cells: int):
    """v1: a thread block per 256-cell slice of a 4096-cell block finds
    the slice's rows inside the block's ``r0`` range with one warp's
    search, then writes the slice through a cell -> row map."""
    return _expand(comp, comp_ids, num_cells, False)


def expand_rows_to_dense_v2(comp, comp_ids, num_cells: int):
    """v2: same contract and the same slice template; a slice's rows come
    straight from the ``r0s`` table of its 128-cell sub-blocks, no
    search."""
    return _expand(comp, comp_ids, num_cells, True)
