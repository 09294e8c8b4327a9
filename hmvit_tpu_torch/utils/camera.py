"""Camera-space utilities (port of ``hmvit_tpu/utils/camera.py``): 3D box
projection into images, and 2D / 3D box drawing in numpy (the JAX
package draws with OpenCV, which the port does not need).

:func:`draw_2d_boxes` draws the pixels ``cv2.rectangle`` draws (straight
edges widened by ``(thickness + 1) // 2`` on each side, joined by filled
discs of that radius at the corners).  :func:`draw_3d_boxes` draws each
edge as the pixels within ``thickness / 2 + 1`` of the segment, in the
solid colour, where ``cv2.line(..., LINE_AA)`` blends: for an edge whose
ends lie in the image every pixel one colours lies within a pixel of one
the other colours.  Where OpenCV clips an edge at the image's border its
fill can reach a few pixels further.
"""
from __future__ import annotations

import numpy as np

# CARLA/UE4 agent frame (x fwd, y right, z up) -> OpenCV camera axes
_UE4_TO_CV = np.array(
    [[0.0, 1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], np.float64)

# corner connectivity of the global 8-corner convention
BOX_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7))


def corners_to_camera(corners, intrinsic, cam_to_agent):
    """Project agent-frame box corners into camera pixel + depth.

    corners: (N, 8, 3) agent frame; intrinsic (3, 3); cam_to_agent
    (4, 4) camera pose in the agent frame.  Returns (N, 8, 3) =
    (u, v, depth)."""
    corners = np.asarray(corners, np.float64)
    rt = np.linalg.inv(np.asarray(cam_to_agent, np.float64))  # agent->cam
    cam = corners @ rt[:3, :3].T + rt[:3, 3]
    cv = cam @ _UE4_TO_CV.T
    uvw = cv @ np.asarray(intrinsic, np.float64).T
    depth = uvw[..., 2:3]
    uv = uvw[..., :2] / np.where(np.abs(depth) < 1e-6, 1e-6, depth)
    return np.concatenate([uv, depth], axis=-1)


def filter_boxes_in_image(cam_corners, image_w: int, image_h: int):
    """Keep boxes with at least one corner inside the image and in front
    of the camera."""
    c = np.asarray(cam_corners)
    inside = ((c[..., 0] > 0) & (c[..., 0] < image_w)
              & (c[..., 1] > 0) & (c[..., 1] < image_h)
              & (c[..., 2] > 0))
    return c[inside.any(axis=1)]


def _paint(out, rows, cols, color):
    """Set ``out[rows, cols]`` (an (H, W, C) image) to ``color`` where
    the indices lie inside the image."""
    h, w = out.shape[:2]
    keep = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    out[rows[keep], cols[keep]] = np.asarray(color)[:out.shape[2]]


def _rectangle(out, p0, p1, color, thickness: int):
    """``cv2.rectangle(out, p0, p1, color, thickness)`` for thickness >= 1
    on integer corners."""
    h, w = out.shape[:2]
    xa, xb = sorted((p0[0], p1[0]))
    ya, yb = sorted((p0[1], p1[1]))
    r = (thickness + 1) // 2 if thickness > 1 else 0
    # the pixel window that can hold any of the outline, clipped
    x_lo, x_hi = max(xa - r, 0), min(xb + r, w - 1)
    y_lo, y_hi = max(ya - r, 0), min(yb + r, h - 1)
    if x_lo > x_hi or y_lo > y_hi:
        return
    ys, xs = np.mgrid[y_lo:y_hi + 1, x_lo:x_hi + 1]
    in_x = (xs >= xa) & (xs <= xb)
    in_y = (ys >= ya) & (ys <= yb)
    near_x = (np.abs(xs - xa) <= r) | (np.abs(xs - xb) <= r)
    near_y = (np.abs(ys - ya) <= r) | (np.abs(ys - yb) <= r)
    on = (near_x & in_y) | (near_y & in_x)
    for cx in (xa, xb):
        for cy in (ya, yb):
            on |= (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r
    _paint(out, ys[on], xs[on], color)


def _clip_segment(p0, p1, lo, hi_x, hi_y):
    """Liang-Barsky: the part of p0 -> p1 inside [lo, hi_x] x [lo, hi_y],
    or None."""
    (x0, y0), (x1, y1) = p0, p1
    dx, dy = x1 - x0, y1 - y0
    t0, t1 = 0.0, 1.0
    for p, q in ((-dx, x0 - lo), (dx, hi_x - x0), (-dy, y0 - lo),
                 (dy, hi_y - y0)):
        if p == 0:
            if q < 0:
                return None
            continue
        t = q / p
        if p < 0:
            t0 = max(t0, t)
        else:
            t1 = min(t1, t)
        if t0 > t1:
            return None
    return ((x0 + t0 * dx, y0 + t0 * dy), (x0 + t1 * dx, y0 + t1 * dy))


def _thick_line(out, p0, p1, color, thickness: int):
    """The pixels whose centres lie within ``thickness / 2 + 1`` of the
    segment p0 -> p1: the band ``cv2.line(..., LINE_AA)`` blends into."""
    h, w = out.shape[:2]
    half = max(thickness, 1) / 2.0 + 1.0
    seg = _clip_segment((float(p0[0]), float(p0[1])),
                        (float(p1[0]), float(p1[1])), -half - 1,
                        w + half, h + half)
    if seg is None:
        return
    (x0, y0), (x1, y1) = seg
    x_lo = max(int(np.floor(min(x0, x1) - half)), 0)
    x_hi = min(int(np.ceil(max(x0, x1) + half)), w - 1)
    y_lo = max(int(np.floor(min(y0, y1) - half)), 0)
    y_hi = min(int(np.ceil(max(y0, y1) + half)), h - 1)
    if x_lo > x_hi or y_lo > y_hi:
        return
    ys, xs = np.mgrid[y_lo:y_hi + 1, x_lo:x_hi + 1].astype(np.float64)
    dx, dy = x1 - x0, y1 - y0
    length2 = dx * dx + dy * dy
    t = (np.clip(((xs - x0) * dx + (ys - y0) * dy) / length2, 0.0, 1.0)
         if length2 > 0 else np.zeros_like(xs))
    dist2 = (xs - x0 - t * dx) ** 2 + (ys - y0 - t * dy) ** 2
    on = dist2 <= half * half
    _paint(out, ys[on].astype(np.int64), xs[on].astype(np.int64), color)


def draw_2d_boxes(image, cam_corners, color=(255, 0, 0), thickness=2):
    """Axis-aligned 2D boxes around the projected corners of the boxes
    :func:`filter_boxes_in_image` keeps (the pixels ``cv2.rectangle``
    draws)."""
    out = np.ascontiguousarray(image).copy()
    kept = filter_boxes_in_image(cam_corners, out.shape[1], out.shape[0])
    for box in kept:
        x0, y0 = box[:, 0].min(), box[:, 1].min()
        x1, y1 = box[:, 0].max(), box[:, 1].max()
        _rectangle(out, (int(x0), int(y0)), (int(x1), int(y1)), color,
                   int(thickness))
    return out


def draw_3d_boxes(image, cam_corners, color=(0, 255, 0), thickness=2):
    """Wireframe 3D boxes: the 12 edges of each kept box (within a pixel
    of ``cv2.line(..., LINE_AA)``'s)."""
    out = np.ascontiguousarray(image).copy()
    kept = filter_boxes_in_image(cam_corners, out.shape[1], out.shape[0])
    for box in kept:
        pts = box[:, :2].astype(int)
        for a, b in BOX_EDGES:
            _thick_line(out, pts[a], pts[b], color, int(thickness))
    return out


def plot_all_agents(draw_image_list, cav_id_list, save_path=None):
    """Grid of every agent's (drawn) camera images: one row per agent,
    one column per camera.  Each row's entries may be plain images or
    ``(camera_key, image)`` pairs (what ``visualize_all_agents_bbx``
    returns); ``None`` leaves a cell blank.

    Returns the matplotlib figure and optionally saves a PNG.  This is
    the one function of the port that needs matplotlib; it switches to
    the Agg backend only when no display is available."""
    import os

    try:
        import matplotlib
    except ImportError as err:
        raise ImportError("plot_all_agents needs matplotlib, which is not "
                          "installed; draw_3d_boxes and the codecs' "
                          "write_png need nothing") from err

    if not os.environ.get("DISPLAY") and not os.environ.get("MPLBACKEND"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def norm(entry, c):
        if isinstance(entry, tuple):
            return entry
        return (f"camera{c}", entry)

    rows = len(draw_image_list)
    cols = max((len(r) for r in draw_image_list), default=1)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                             squeeze=False)
    for r, (images, cav_id) in enumerate(zip(draw_image_list, cav_id_list)):
        for c in range(cols):
            ax = axes[r][c]
            ax.axis("off")
            if c < len(images):
                cam_key, img = norm(images[c], c)
                if img is not None:
                    ax.imshow(img)
                ax.set_title(f"agent {cav_id} {cam_key}", fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=80)
    return fig
