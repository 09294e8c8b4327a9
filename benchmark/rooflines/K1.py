"""K1: the pair warp (every sender's typed [K|V] map into each receiver's
frame).  Its bytes are those its taps must read, which depend on the
poses: the source pixels whose tap weight is non-zero for some pixel of
some pair, counted once a typed map (from the adjoint of the reference's
twin on a one-channel map of ones, as ``chip_smoke.py::
touched_source_bytes`` counts them), plus the output written once and
the per-pair tables; its operations 12 a output value (4 taps, a
multiply-add and a weight each).  Integer arguments ``[dtype, B*I, L,
TY, I, H, W, C, row0, rows]``; its third tensor argument (kept with
the record): each receiver's typed map; the warp's geometry: the
configuration's ``fusion_geometry``."""
import torch

from ..peaks import DTYPE_CODES, bound_s as _bound
from ..reference.ops.fused_warp import pair_warp_xla

KERNEL = "pair_warp"


def touched_pixels(pairwise, rtype, ty: int, receivers: int, size: int,
                   discrete_ratio: float, downsample_rate: int) -> int:
    """Source pixels (of all typed maps) that the taps read."""
    l = pairwise.shape[1]
    mode = torch.zeros(1, l, dtype=torch.long)
    mode[0, :receivers] = torch.as_tensor(rtype[:receivers])
    ones = torch.ones(1, ty, l, size, size, 1, requires_grad=True)
    with torch.enable_grad():
        pair_warp_xla(ones, pairwise, mode, discrete_ratio, downsample_rate,
                      receivers).sum().backward()
    return int((ones.grad != 0).sum())


def bound_s(launch: dict, request: dict, config: dict) -> float:
    code, bi, l, ty, r, h, w, c, _, rows = (int(i) for i in launch["ints"])
    dtype, size = DTYPE_CODES[code]
    pair = torch.as_tensor(request["pairwise_t_matrix"][:, :l, :l],
                           dtype=torch.float32)
    geo = config["fusion_geometry"]
    touched = touched_pixels(pair, launch["small"][2].tolist(), ty, r, h,
                             geo["discrete_ratio"], geo["downsample_rate"])
    nbytes = (touched * c + bi * l * rows * w * c) * size + bi * (l * 32 + 4)
    return _bound(nbytes, 12.0 * bi * l * rows * w * c, dtype)
