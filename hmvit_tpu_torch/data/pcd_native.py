"""The dataset's padded pcd read through the native parser
(``hmvit_tpu_torch/native/pcd_parser.cpp``, the port's copy of the JAX
package's ``native/pcd_parser.cpp``), with :mod:`.pcd_io`'s numpy reader
as its fallback, as ``hmvit_tpu/data/pcd_native.py`` reads.

The native parser shuffles with its own xorshift64* Fisher-Yates, so a
shuffled native read holds the points of the JAX package's native read in
the same order; the numpy fallback shuffles with
``numpy.random.default_rng(seed)``, as JAX's fallback does.  A parser
that does not build warns once, and ``host_build.calls("pcd_parser")``
counts the reads each path served (:mod:`hmvit_tpu_torch.ops.host_build`)."""
from __future__ import annotations

import ctypes

import numpy as np

from ..ops import host_build
from .pcd_io import read_pcd_padded as read_pcd_padded_numpy

NAME = "pcd_parser"


def _bind(lib):
    lib.parse_pcd.restype = ctypes.c_long
    lib.parse_pcd.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                              ctypes.c_long, ctypes.c_uint, ctypes.c_int]


def library(require: bool = False):
    """The loaded parser, or ``None`` (with one warning) when it does not
    build; ``require=True`` raises instead."""
    return host_build.load(NAME, _bind, require)


def read_pcd_padded(path: str, max_points: int, seed: int = 0,
                    shuffle: bool = False):
    """Parse a pcd into a fixed (max_points, 4) float32 buffer and its
    (max_points,) mask; ``shuffle`` permutes the points (seeded) before
    the truncation, so a truncated read keeps a random subset.

    The native parser where it builds, else the numpy reader
    (:func:`hmvit_tpu_torch.data.pcd_io.read_pcd_padded`).  A file the
    native parser refuses (no x / y / z, no points) goes to the numpy
    reader, which names the fault."""
    lib = library()
    if lib is not None:
        out = np.zeros((max_points, 4), np.float32)
        n = lib.parse_pcd(str(path).encode(),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          max_points, seed & 0xFFFFFFFF, int(shuffle))
        if n >= 0:
            mask = np.zeros(max_points, np.float32)
            mask[:n] = 1
            host_build.count(NAME, "native")
            return out, mask
    host_build.count(NAME, "numpy")
    return read_pcd_padded_numpy(path, max_points, seed, shuffle)
