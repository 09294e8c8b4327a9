"""Bytes and operations of one launch of the port's window-attention
kernels (stripe K2, plain K3), from its integer arguments ``[dtype, n,
j, windows, t, win, wcols, heads, dim_head]``: q and the output (n,
windows * t, c), [K|V] (n, j, windows * t, 2c) in the operand type; the
bias (heads, t, t) and the mask (n, j, windows * t) in float32; q k^T
and p v per (map, window, head): 4 t (j t) d operations (the frozen
copy of ``hmvit_tpu_torch/ops/opcount.py::attention_ops``)."""
from ..peaks import DTYPE_CODES, bound_s


def launch_bound_s(ints) -> float:
    code, n, j, nwin, t, _, _, heads, d = (int(i) for i in ints[:9])
    dtype, size = DTYPE_CODES[code]
    c, tokens = heads * d, nwin * t
    nbytes = (size * (2 * n * tokens * c + n * j * tokens * 2 * c)
              + 4 * (heads * t * t + n * j * tokens))
    ops = 4.0 * n * nwin * heads * t * (j * t) * d
    return bound_s(nbytes, ops, dtype)
