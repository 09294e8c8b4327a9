"""ctypes binding of the native rotated IoU and greedy NMS
(``hmvit_tpu_torch/native/rotated_nms.cpp``, the port's copy of the JAX
package's ``native/rotated_nms.cpp``): convex-quad clipping in double
precision, the pick order of :func:`hmvit_tpu_torch.utils.nms.nms_rotated`
(descending score, ties by ascending index, at most ``top`` candidates).
Built on first use by :mod:`hmvit_tpu_torch.ops.host_build`."""
from __future__ import annotations

import ctypes

import numpy as np

from ..ops import host_build

NAME = "rotated_nms"
_F32P = ctypes.POINTER(ctypes.c_float)


def _bind(lib):
    lib.nms_rotated.restype = ctypes.c_longlong
    lib.nms_rotated.argtypes = [
        _F32P, _F32P, ctypes.c_longlong, ctypes.c_float, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32)]
    lib.rotated_iou_matrix.restype = None
    lib.rotated_iou_matrix.argtypes = [
        _F32P, ctypes.c_longlong, _F32P, ctypes.c_longlong, _F32P]


def library(require: bool = False):
    """The loaded library, or ``None`` (with one warning) when it does
    not build; ``require=True`` raises instead."""
    return host_build.load(NAME, _bind, require)


def _as_corners2d(corners) -> np.ndarray:
    c = np.ascontiguousarray(np.asarray(corners, np.float32)[..., :4, :2])
    return c.reshape(-1, 4, 2)


def nms_rotated_native(corners, scores, threshold: float, top: int = 1000,
                       require: bool = False):
    """Greedy NMS of (N, 4, 2) or (N, 8, 3) corners: the kept indices in
    pick order (int32), or ``None`` when the library is unavailable."""
    lib = library(require)
    if lib is None:
        return None
    c = _as_corners2d(corners)
    s = np.ascontiguousarray(np.asarray(scores, np.float32))
    n = c.shape[0]
    if n == 0:
        return np.array([], dtype=np.int32)
    keep = np.empty(n, np.int32)
    n_keep = lib.nms_rotated(c.ctypes.data_as(_F32P), s.ctypes.data_as(_F32P),
                             n, ctypes.c_float(threshold), top,
                             keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return keep[:n_keep].copy()


def rotated_iou_matrix_native(corners_a, corners_b, require: bool = False):
    """(N, M) float32 BEV IoU, or ``None`` when the library is
    unavailable."""
    lib = library(require)
    if lib is None:
        return None
    a = _as_corners2d(corners_a)
    b = _as_corners2d(corners_b)
    out = np.empty((a.shape[0], b.shape[0]), np.float32)
    lib.rotated_iou_matrix(a.ctypes.data_as(_F32P), a.shape[0],
                           b.ctypes.data_as(_F32P), b.shape[0],
                           out.ctypes.data_as(_F32P))
    return out
