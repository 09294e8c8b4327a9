"""Minimal PCD reader / writer (the port's own copy of
``hmvit_tpu/data/pcd_io.py``), and the fixed-size padded read of the
dataset's numpy path (:mod:`.pcd_native` reads through the native
parser first).

OPV2V point clouds store intensity either as a proper ``intensity`` field
or packed into the red channel of an ``rgb`` field.  The parser handles
ascii and binary encodings and both layouts, returning (N, 4) float32
[x, y, z, intensity].
"""
from __future__ import annotations

import numpy as np

_PCD_DTYPES = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
}


def read_pcd(path: str) -> np.ndarray:
    """Parse a .pcd file -> (N, 4) [x, y, z, intensity] float32."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()

        np_fields = []
        for name, size, typ, count in zip(fields, sizes, types, counts):
            base = _PCD_DTYPES[(typ, size)]
            if count == 1:
                np_fields.append((name, base))
            else:
                np_fields.append((name, base, (count,)))
        dtype = np.dtype(np_fields)

        if mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = raw.reshape(n, -1)
            data = {}
            col = 0
            for name, count in zip(fields, counts):
                data[name] = raw[:, col] if count == 1 else raw[:, col:col + count]
                col += count
        elif mode == "binary":
            buf = f.read(dtype.itemsize * n)
            arr = np.frombuffer(buf, dtype=dtype, count=n)
            data = {name: arr[name] for name in fields}
        else:
            raise ValueError(f"unsupported pcd DATA mode {mode!r}")

    xyz = np.stack(
        [np.asarray(data["x"], np.float32),
         np.asarray(data["y"], np.float32),
         np.asarray(data["z"], np.float32)], axis=1
    )
    if "intensity" in data:
        inten = np.asarray(data["intensity"], np.float32)
    elif "rgb" in data:
        packed = np.asarray(data["rgb"])
        if packed.dtype.kind == "f":
            packed = packed.astype(np.float32).view(np.uint32)
        red = (packed.astype(np.uint32) >> 16) & 0xFF
        inten = red.astype(np.float32) / 255.0
    else:
        inten = np.zeros(len(xyz), np.float32)
    return np.concatenate([xyz, inten[:, None]], axis=1)


def write_pcd(path: str, points: np.ndarray) -> None:
    """Write (N, >=3) points as an ascii pcd with an intensity field."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    inten = points[:, 3] if points.shape[1] > 3 else np.zeros(n, np.float32)
    with open(path, "w") as f:
        f.write(
            "# .PCD v0.7 - Point Cloud Data file format\n"
            "VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
            "TYPE F F F F\nCOUNT 1 1 1 1\n"
            f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {n}\nDATA ascii\n"
        )
        for i in range(n):
            f.write(
                f"{points[i, 0]:.6f} {points[i, 1]:.6f} "
                f"{points[i, 2]:.6f} {inten[i]:.6f}\n"
            )


def read_pcd_padded(path: str, max_points: int, seed: int = 0,
                    shuffle: bool = False):
    """Parse a pcd into a fixed (max_points, 4) float32 buffer and its
    (max_points,) mask; ``shuffle`` permutes the points first with
    ``numpy.random.default_rng(seed)``.  The numpy path of
    :func:`hmvit_tpu_torch.data.pcd_native.read_pcd_padded`, which the
    dataset reads through: unshuffled reads equal the native parser's,
    shuffled ones hold the same points in another order."""
    pts = read_pcd(path)
    if shuffle:
        pts = pts[np.random.default_rng(seed).permutation(len(pts))]
    n = min(len(pts), max_points)
    out = np.zeros((max_points, 4), np.float32)
    out[:n] = pts[:n]
    mask = np.zeros(max_points, np.float32)
    mask[:n] = 1
    return out, mask
