"""OPV2V on-disk dataset (the port of ``hmvit_tpu/data/opv2v.py``, numpy
only): scenario scan, hetero modality assignment, pose reform, ground
truth projection and fixed-shape frame assembly.

No voxelization happens here: a frame carries raw padded point clouds
(the model voxelizes on the device), and every array has a static shape
(``max_cav`` agent slots, ``max_points``, ``max_objects``).  Files are
read through the port's own codecs (:mod:`.codecs`, :mod:`.pcd_io`):
the data path needs no PyYAML, OpenCV or Pillow.

Layout: root/<scenario>/<cav_id>/<timestamp>.yaml / .pcd /
_camera{0..3}.png / _bev_{dynamic,static,lane,visibility_corp}.png.
RSUs have negative cav ids and sort to the end; the ego is the first
CAV.

Besides the intermediate-fusion frame, :meth:`HeteroCooperativeDataset.
early_fusion_frame` merges every agent's cloud into the ego's slot and
:meth:`~HeteroCooperativeDataset.late_fusion_frame` gives one
single-agent frame per agent (``tools/inference.py --fusion_method
early|late``).

With ``add_data_extension`` a frame also carries the ego's BEV map
ground truth (``gt_dynamic``, ``gt_static``, ``has_map_gt``) read from
the rasters beside its yaml, as OpenCV reads them (the grey formula and
the nearest resize of :mod:`.codecs`); :meth:`HeteroCooperativeDataset.
seg_labels` gives the segmentation labels at a head's grid.

The inspection API: :meth:`HeteroCooperativeDataset.get_sample` gives one
(scenario, timestamp) raw, the camera images as OpenCV reads them in
RGB, and :meth:`~HeteroCooperativeDataset.visualize_all_agents_bbx`
draws each agent's ground truth onto its cameras
(:func:`hmvit_tpu_torch.utils.camera.draw_3d_boxes`).
"""
from __future__ import annotations

import os
import re
import threading
from collections import OrderedDict

import numpy as np

from .. import COM_RANGE
from ..utils import transforms as T
from ..utils.boxes import corners_to_boxes, mask_boxes_outside_range_np
from .codecs import read_grey, read_rgb, resize_bilinear, resize_nearest, \
    yaml_load_file
from .pcd_native import read_pcd_padded

# ImageNet normalisation of the camera images (RGB)
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


# the BEV map rasters of a frame
BEV_MAPS = ("bev_dynamic", "bev_static", "bev_lane", "bev_visibility_corp")


def load_frame_yaml(path: str) -> dict:
    """A frame's yaml (the ``!!python/tuple`` tag reads as a tuple)."""
    return yaml_load_file(path)


def create_corner_template(extent) -> np.ndarray:
    """(8, 3) corners of a box with half-extents [ex, ey, ez], ordered to
    match the global corner convention."""
    ex, ey, ez = extent
    return np.array(
        [
            [ex, -ey, -ez], [ex, ey, -ez], [-ex, ey, -ez], [-ex, -ey, -ez],
            [ex, -ey, ez], [ex, ey, ez], [-ex, ey, ez], [-ex, -ey, ez],
        ]
    )


def project_world_objects(vehicles: dict, lidar_pose, lidar_range,
                          order: str = "hwl") -> "OrderedDict":
    """World-frame vehicle dicts -> {id: (7,) box in the lidar frame},
    the boxes inside ``lidar_range``.

    Vehicle schema (per OPV2V frame yaml): location + center offset,
    angle [roll, yaw, pitch] degrees, extent = half dims [l/2, w/2, h/2].
    """
    out = OrderedDict()
    for obj_id, content in vehicles.items():
        loc = content["location"]
        center = content.get("center", [0, 0, 0])
        angle = content["angle"]
        object_pose = [
            loc[0] + center[0], loc[1] + center[1], loc[2] + center[2],
            angle[0], angle[1], angle[2],
        ]
        obj_to_lidar = T.pose_to_pose(object_pose, lidar_pose)
        corners = create_corner_template(content["extent"])
        corners = T.project_points(corners, obj_to_lidar)
        box = corners_to_boxes(corners[None], order)[0]
        if mask_boxes_outside_range_np(box[None], lidar_range, order)[0]:
            out[obj_id] = box
    return out


def mask_ego_points(points: np.ndarray, x_half: float = 1.95,
                    y_half: float = 1.1) -> np.ndarray:
    """Remove the ego vehicle's own body returns."""
    hit = (np.abs(points[:, 0]) <= x_half) & (np.abs(points[:, 1]) <= y_half)
    return points[~hit]


def scan_scenarios(root: str) -> list:
    """[(scenario_name, OrderedDict{cav_id: {timestamp: file dict}})]."""
    scenarios = []
    for scen in sorted(os.listdir(root)):
        scen_dir = os.path.join(root, scen)
        if not os.path.isdir(scen_dir):
            continue
        cav_ids = [c for c in os.listdir(scen_dir)
                   if os.path.isdir(os.path.join(scen_dir, c))]
        # RSUs (negative ids) go last; the ego is the first CAV
        cav_ids = sorted(cav_ids, key=lambda c: (int(c) < 0, int(c)))
        cavs = OrderedDict()
        for cav in cav_ids:
            cav_dir = os.path.join(scen_dir, cav)
            stamps = sorted(
                {m.group(1) for fn in os.listdir(cav_dir)
                 if (m := re.match(r"(\d+)\.yaml$", fn))})
            frames = OrderedDict()
            for ts in stamps:
                frames[ts] = {
                    "yaml": os.path.join(cav_dir, f"{ts}.yaml"),
                    "pcd": os.path.join(cav_dir, f"{ts}.pcd"),
                    "cameras": [os.path.join(cav_dir, f"{ts}_camera{i}.png")
                                for i in range(4)],
                    # the BEV map ground truth (add_data_extension)
                    "bev_maps": {
                        name: os.path.join(cav_dir, f"{ts}_{name}.png")
                        for name in BEV_MAPS},
                }
            cavs[cav] = frames
        scenarios.append((scen, cavs))
    return scenarios


def preprocess_image(path: str, size: int, mean, std) -> np.ndarray:
    """A camera PNG -> (size, size, 3) RGB in [0, 1], normalised by
    ``mean`` and ``std``: OpenCV's colour read (grey replicated, alpha
    dropped) and ``INTER_LINEAR`` resize (:func:`.codecs.resize_bilinear`,
    the image itself when it already has the size)."""
    img = resize_bilinear(read_rgb(path), size).astype(np.float32) / 255.0
    return (img - np.asarray(mean)) / np.asarray(std)


class _Now:
    """An already-finished 'future': the serial decode of one core."""

    __slots__ = ("_v",)

    def __init__(self, fn, *a, **k):
        self._v = fn(*a, **k)

    def result(self):
        return self._v


class _Serial:
    submit = _Now


class HeteroCooperativeDataset:
    """Intermediate-fusion hetero dataset of padded frames.

    params keys used: root_dir / validate_dir, train_params.max_cav,
    camera_to_lidar_ratio, ego_mode, preprocess (camera size, lidar
    range), postprocess (max_num, order), wild_setting (async, loc_err),
    cur_ego_pose_flag, io_workers.  Random draws (modalities, pose noise,
    point shuffles) come from ``numpy.random.default_rng``: in training
    from ``seed`` (None, the default, draws fresh entropy as the JAX
    dataset does), in evaluation from 0."""

    IMAGE_MEAN = IMAGE_MEAN
    IMAGE_STD = IMAGE_STD

    def __init__(self, params: dict, train: bool = True,
                 max_points: int = 60000, seed: int | None = None):
        self.params = params
        self.train = train
        root = params["root_dir"] if train else params["validate_dir"]
        self.scenarios = scan_scenarios(root)
        self.max_cav = params["train_params"]["max_cav"]
        self.max_objects = params["postprocess"].get("max_num", 100)
        self.max_points = max_points
        self.camera_ratio = params.get("camera_to_lidar_ratio", 0.0)
        self.ego_mode = params.get("ego_mode", "lidar")
        self.lidar_range = params["preprocess"]["cav_lidar_range"]
        cam_args = (params["preprocess"]["args"]
                    .get("camera_preprocess", {}).get("args", {}))
        self.image_size = cam_args.get("resize_x", 512)
        self.order = params["postprocess"].get("order", "hwl")
        # the ego's BEV map rasters, when the config asks for them; the
        # dynamic map from bev_visibility_corp when train_params.visible
        self.load_bev_maps = bool(params.get("add_data_extension"))
        self.visible = params["train_params"].get("visible", False)
        self.seg_gt_size = int(params["postprocess"].get("seg_gt_size", 128))

        # communication impairments: 'sim' delays by a fixed number of
        # frames; 'real' derives the delay from payload size / link speed
        # + backbone time, in 100 ms frames
        wild = params.get("wild_setting", {})
        self.async_frames = 0
        if wild.get("async", False):
            if wild.get("async_mode", "sim") == "real":
                data_size = float(wild.get("data_size", 1.06))  # MB
                speed = float(wild.get("transmission_speed", 27.0))  # Mbps
                backbone = float(wild.get("backbone_delay", 10.0))  # ms
                delay_ms = data_size * 8 / speed * 1000 + backbone
                self.async_frames = int(np.ceil(delay_ms / 100.0))
            else:
                self.async_frames = int(wild.get("async_overhead", 0))
        self.loc_err = wild.get("loc_err", False)
        self.xyz_std = float(wild.get("xyz_std", 0.2))
        self.ryp_std = float(wild.get("ryp_std", 0.2))
        # True: transforms map a delayed CAV to the CURRENT ego.  False:
        # to the DELAYED ego pose, and spatial_correction_matrix carries
        # the ego's own motion over the delay
        self.cur_ego_pose_flag = bool(params.get("cur_ego_pose_flag", True))

        # flat index over (scenario, timestamp) on the ego's timeline
        self.index = []
        for si, (_, cavs) in enumerate(self.scenarios):
            for ts in next(iter(cavs.values())):
                self.index.append((si, ts))

        self._rng = np.random.default_rng(seed if train else 0)
        # __getitem__ may run on loader threads; numpy Generators are not
        # thread-safe, so every draw goes through this lock
        self._rng_lock = threading.Lock()
        self._pool = None
        self.reinitialize()

    def reinitialize(self):
        """Re-roll the per-(cav, frame) modalities (1 = lidar); the
        evaluation draws restart from seed 0."""
        if not self.train:
            self._rng = np.random.default_rng(0)
        self.modalities = []
        for _, cavs in self.scenarios:
            n_ts = len(next(iter(cavs.values())))
            draws = (self._rng.uniform(0, 1, (len(cavs), n_ts))
                     >= self.camera_ratio).astype(np.int32)
            if self.ego_mode == "camera":
                draws[0, :] = 0
            elif self.ego_mode == "lidar":
                draws[0, :] = 1
            self.modalities.append(draws)

    def __len__(self):
        return len(self.index)

    def _noisy_pose(self, pose):
        if not self.loc_err:
            return pose
        pose = list(pose)
        with self._rng_lock:
            noise = self._rng.normal(0, 1.0, 3)
        pose[0] += float(noise[0]) * self.xyz_std
        pose[1] += float(noise[1]) * self.xyz_std
        pose[4] += float(noise[2]) * self.ryp_std
        return pose

    def _io_pool(self):
        """The decode pool of the pcd and PNG reads: threads (zlib and
        numpy release the GIL), ``io_workers`` of them (default 8); on
        one core, unless ``io_workers`` is set, the decodes run inline."""
        if self._pool is None:
            if (os.cpu_count() or 1) <= 1 and "io_workers" not in self.params:
                self._pool = _Serial()
            else:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=int(self.params.get("io_workers", 8)))
        return self._pool

    def __getitem__(self, idx: int) -> dict:
        si, ts = self.index[idx]
        _, cavs = self.scenarios[si]
        cav_list = list(cavs.keys())
        ts_index = list(cavs[cav_list[0]].keys()).index(ts)

        ego_pose = load_frame_yaml(cavs[cav_list[0]][ts]["yaml"])["lidar_pose"]
        ego_stamps = list(cavs[cav_list[0]].keys())

        frame = _empty_frame(self.max_cav, self.max_points,
                             self.image_size, self.max_objects)
        objects = OrderedDict()
        # phase 1 walks the fleet (yaml metadata, eligibility, geometry)
        # and submits the decodes (one pcd and up to 4 PNGs an agent);
        # phase 2 puts them into the frame
        io_jobs = []
        slot = 0
        for ci, cav in enumerate(cav_list):
            if slot >= self.max_cav:
                break
            # communication delay: a non-ego agent sends an older frame
            cav_stamps = list(cavs[cav].keys())
            eff_ts = ts
            delay_frames = 0
            if ci > 0 and self.async_frames:
                cur = cav_stamps.index(ts) if ts in cav_stamps else 0
                pos = max(cur - self.async_frames, 0)
                eff_ts = cav_stamps[pos]
                delay_frames = cur - pos
            if eff_ts not in cavs[cav]:
                continue
            meta = load_frame_yaml(cavs[cav][eff_ts]["yaml"])
            pose = meta["lidar_pose"]
            dist = np.hypot(pose[0] - ego_pose[0], pose[1] - ego_pose[1])
            if ci > 0 and dist > COM_RANGE:
                continue
            noisy_pose = self._noisy_pose(pose) if ci > 0 else pose

            # the ground truth always from the true poses
            objects.update(project_world_objects(
                meta.get("vehicles", {}), ego_pose, self.lidar_range,
                self.order))

            with self._rng_lock:
                pcd_seed = int(self._rng.integers(1 << 31))
            pool = self._io_pool()
            pcd_fut = pool.submit(
                read_pcd_padded, cavs[cav][eff_ts]["pcd"],
                self.max_points + 4096, seed=pcd_seed, shuffle=self.train)
            cam_futs = []
            for mi, cam_path in enumerate(cavs[cav][eff_ts]["cameras"]):
                cam_key = f"camera{mi}"
                if cam_key in meta and os.path.exists(cam_path):
                    cam_futs.append((mi, pool.submit(
                        preprocess_image, cam_path, self.image_size,
                        self.IMAGE_MEAN, self.IMAGE_STD)))
                    frame["intrinsics"][slot, mi] = np.asarray(
                        meta[cam_key]["intrinsic"], np.float32)
                    frame["extrinsics"][slot, mi] = T.pose_to_pose(
                        meta[cam_key]["cords"], pose).astype(np.float32)
            io_jobs.append((slot, pcd_fut, cam_futs))

            frame["mode"][slot] = self.modalities[si][
                min(ci, self.modalities[si].shape[0] - 1), ts_index]
            frame["agent_mask"][slot] = 1
            # (v / 30, delay in frames, infrastructure)
            frame["prior_encoding"][slot] = (
                float(meta.get("ego_speed", 0.0)) / 30.0,
                float(delay_frames),
                1.0 if int(cav) < 0 else 0.0,
            )
            if not self.cur_ego_pose_flag and delay_frames and ci > 0:
                # to the ego's DELAYED pose; the correction (delayed ego ->
                # current ego) goes to the model
                d_pos = max(ego_stamps.index(ts) - delay_frames, 0)
                ego_delay_pose = load_frame_yaml(
                    cavs[cav_list[0]][ego_stamps[d_pos]]["yaml"]
                )["lidar_pose"]
                frame["transformation_matrix"][slot] = T.pose_to_pose(
                    noisy_pose, ego_delay_pose).astype(np.float32)
                frame["spatial_correction_matrix"][slot] = T.pose_to_pose(
                    ego_delay_pose, ego_pose).astype(np.float32)
            else:
                frame["transformation_matrix"][slot] = T.pose_to_pose(
                    noisy_pose, ego_pose).astype(np.float32)
            frame["_poses"].append(noisy_pose)
            slot += 1

        for slot_i, pcd_fut, cam_futs in io_jobs:
            raw, raw_mask = pcd_fut.result()
            pts = mask_ego_points(raw[raw_mask > 0])
            n = min(len(pts), self.max_points)
            frame["points"][slot_i, :n] = pts[:n]
            frame["points_mask"][slot_i, :n] = 1
            for mi, fut in cam_futs:
                frame["camera"][slot_i, mi] = fut.result()

        if self.load_bev_maps:
            frame.update(self._load_bev_gt(cavs[cav_list[0]][ts]))

        poses = frame.pop("_poses")
        frame["pairwise_t_matrix"][:] = T.pairwise_transforms(
            poses, self.max_cav).astype(np.float32)
        frame["record_len"] = np.int32(slot)

        boxes = list(objects.values())[: self.max_objects]
        for i, b in enumerate(boxes):
            frame["object_bbx_center"][i] = b
            frame["object_bbx_mask"][i] = 1
        frame["object_ids"] = list(objects.keys())[: self.max_objects]
        return frame

    def _load_bev_gt(self, files: dict) -> dict:
        """The ego-frame BEV map ground truth of a frame's rasters, each
        turned grey and resized (nearest) to ``seg_gt_size``: a nonzero
        pixel is class 1; static is road (1) with lane (2) over it.  A
        missing dynamic raster leaves ``has_map_gt`` 0."""
        s = self.seg_gt_size

        def binarize(name):
            path = files["bev_maps"][name]
            if not os.path.exists(path):
                return None
            return (resize_nearest(read_grey(path), s) > 0).astype(np.uint8)

        dyn = binarize("bev_visibility_corp" if self.visible
                       else "bev_dynamic")
        road = binarize("bev_static")
        lane = binarize("bev_lane")
        out = {"gt_dynamic": np.zeros((s, s), np.uint8),
               "gt_static": np.zeros((s, s), np.uint8),
               "has_map_gt": np.float32(0.0)}
        if dyn is not None:
            out["gt_dynamic"] = dyn
            out["has_map_gt"] = np.float32(1.0)
        if road is not None:
            static = road.copy()
            if lane is not None:
                static[lane == 1] = 2
            out["gt_static"] = static
        return out

    def seg_labels(self, frame: dict, grid_hw) -> dict:
        """The segmentation labels of one frame at a head's grid
        (``grid_hw``): the map rasters subsampled (row ``i * H // h``,
        column ``j * W // w``) when the frame carries them
        (``has_map_gt``), else the dynamic map rasterized from the
        frame's boxes."""
        h, w = grid_hw
        if "gt_dynamic" in frame and float(
                np.asarray(frame.get("has_map_gt", 0))) > 0:
            def down(m):
                yi = np.arange(h) * m.shape[0] // h
                xi = np.arange(w) * m.shape[1] // w
                return m[np.ix_(yi, xi)]

            return {"dynamic_seg": down(np.asarray(frame["gt_dynamic"])),
                    "static_seg": down(np.asarray(frame["gt_static"]))}
        from ..models.seg_head import rasterize_boxes_to_mask

        boxes = frame["object_bbx_center"][frame["object_bbx_mask"] > 0]
        return {"dynamic_seg": rasterize_boxes_to_mask(
            boxes, self.lidar_range, grid_hw, self.order)}

    def early_fusion_frame(self, idx: int) -> dict:
        """Early fusion: every agent's points projected into the ego frame
        and merged into one cloud on agent slot 0, a lidar fleet of one."""
        frame = self[idx]
        n_live = int(frame["record_len"])
        merged = []
        for i in range(n_live):
            m = frame["points_mask"][i] > 0
            pts = frame["points"][i][m]
            pts[:, :3] = T.project_points(
                pts[:, :3], frame["transformation_matrix"][i])
            merged.append(pts)
        merged = np.concatenate(merged) if merged else np.zeros((0, 4))
        out = dict(frame)
        out["points"] = np.zeros_like(frame["points"])
        out["points_mask"] = np.zeros_like(frame["points_mask"])
        n = min(len(merged), out["points"].shape[1])
        out["points"][0, :n] = merged[:n]
        out["points_mask"][0, :n] = 1
        out["agent_mask"] = np.zeros_like(frame["agent_mask"])
        out["agent_mask"][0] = 1
        out["record_len"] = np.int32(1)
        out["mode"] = np.array([1] * len(frame["mode"]), np.int32)
        return out

    def late_fusion_frame(self, idx: int) -> list:
        """Late fusion: one single-agent frame per live agent, each in its
        own frame, with its modality on every slot and its transform to
        the ego (``to_ego``)."""
        frame = self[idx]
        n_live = int(frame["record_len"])
        subs = []
        for i in range(n_live):
            sub = {k: np.array(v, copy=True) for k, v in frame.items()
                   if k != "object_ids"}
            for key in ("points", "points_mask", "camera", "intrinsics",
                        "extrinsics"):
                sub[key][0] = frame[key][i]
                sub[key][1:] = 0
            sub["agent_mask"] = np.zeros_like(frame["agent_mask"])
            sub["agent_mask"][0] = 1
            sub["mode"] = np.array(
                [frame["mode"][i]] * len(frame["mode"]), np.int32)
            sub["record_len"] = np.int32(1)
            sub["pairwise_t_matrix"] = np.tile(
                np.eye(4, dtype=np.float32),
                (*frame["pairwise_t_matrix"].shape[:2], 1, 1))
            sub["transformation_matrix"] = np.tile(
                np.eye(4, dtype=np.float32),
                (frame["transformation_matrix"].shape[0], 1, 1))
            sub["to_ego"] = frame["transformation_matrix"][i]
            sub["object_ids"] = frame.get("object_ids", [])
            subs.append(sub)
        return subs

    def get_sample(self, scenario_idx: int, timestamp_idx: int) -> dict:
        """One (scenario, timestamp) raw: an OrderedDict keyed by cav id
        string, each entry with ``ego`` (the first CAV), ``lidar_pose``,
        ``vehicles`` (the frame yaml's world-frame ground truth) and
        ``camera_params`` = {camera{0..3}: {``camera_coords`` (the
        camera's world pose), ``camera_extrinsic`` (camera -> this agent's
        lidar frame, 4 x 4), ``camera_intrinsic`` (3 x 3), ``image_path``,
        ``image`` (uint8 RGB, unresized; None where the file is
        missing)}}.  The timestamp is the ego's ``timestamp_idx``-th,
        the same for every CAV (a CAV without it is left out).  No
        padding, no preprocessing: the inspection surface."""
        _, cavs = self.scenarios[scenario_idx]
        out = OrderedDict()
        ego_frames = next(iter(cavs.values()))
        ts = list(ego_frames.keys())[timestamp_idx]
        for ci, (cav, frames) in enumerate(cavs.items()):
            if ts not in frames:
                continue
            meta = load_frame_yaml(frames[ts]["yaml"])
            pose = meta["lidar_pose"]
            cam_params = OrderedDict()
            for mi, cam_path in enumerate(frames[ts]["cameras"]):
                cam_key = f"camera{mi}"
                if cam_key not in meta:
                    continue
                cam_params[cam_key] = {
                    "camera_coords": meta[cam_key]["cords"],
                    "camera_extrinsic": T.pose_to_pose(
                        meta[cam_key]["cords"], pose),
                    "camera_intrinsic": np.asarray(
                        meta[cam_key]["intrinsic"], np.float64),
                    "image_path": cam_path,
                    "image": (read_rgb(cam_path) if os.path.exists(cam_path)
                              else None),
                }
            out[str(cav)] = {
                "ego": ci == 0,
                "lidar_pose": pose,
                "vehicles": meta.get("vehicles", {}),
                "camera_params": cam_params,
            }
        return out

    def visualize_all_agents_bbx(self, sample: dict):
        """Each agent's ground-truth boxes (in its own frame) drawn as 3D
        wireframes onto its camera images.  Returns (draw_image_list,
        cav_id_list): per CAV a list of (camera_key, drawn image or None)
        pairs in camera order."""
        from ..utils.boxes import boxes_to_corners_3d_np
        from ..utils.camera import corners_to_camera, draw_3d_boxes

        draw_image_list, cav_id_list = [], []
        for cav_id, content in sample.items():
            boxes = project_world_objects(
                content["vehicles"], content["lidar_pose"],
                self.lidar_range, self.order)
            corners = (boxes_to_corners_3d_np(
                np.stack(list(boxes.values())), self.order)
                if boxes else np.zeros((0, 8, 3)))
            drawn = []
            for cam_key, cam in content["camera_params"].items():
                if cam["image"] is None:
                    drawn.append((cam_key, None))
                    continue
                uvd = corners_to_camera(corners, cam["camera_intrinsic"],
                                        cam["camera_extrinsic"])
                drawn.append((cam_key, draw_3d_boxes(cam["image"], uvd)))
            draw_image_list.append(drawn)
            cav_id_list.append(cav_id)
        return draw_image_list, cav_id_list

    @staticmethod
    def collate_batch(frames: list) -> dict:
        keys = [k for k in frames[0] if not k.startswith("object_ids")]
        batch = {k: np.stack([f[k] for f in frames]) for k in keys}
        batch["object_ids"] = [f["object_ids"] for f in frames]
        return batch


def _empty_frame(max_cav, max_points, image_size, max_objects) -> dict:
    eye4 = np.eye(4, dtype=np.float32)
    return {
        "points": np.zeros((max_cav, max_points, 4), np.float32),
        "points_mask": np.zeros((max_cav, max_points), np.float32),
        "camera": np.zeros((max_cav, 4, image_size, image_size, 3),
                           np.float32),
        "intrinsics": np.tile(np.eye(3, dtype=np.float32),
                              (max_cav, 4, 1, 1)),
        "extrinsics": np.tile(eye4, (max_cav, 4, 1, 1)),
        # padded slots count as lidar: an empty point set is a cheap
        # all-masked pillar pass, and camera buckets stay tight
        "mode": np.ones(max_cav, np.int32),
        "agent_mask": np.zeros(max_cav, np.float32),
        # (velocity / 30, delay in frames, infrastructure) per CAV
        "prior_encoding": np.zeros((max_cav, 3), np.float32),
        "pairwise_t_matrix": np.tile(eye4, (max_cav, max_cav, 1, 1)),
        "transformation_matrix": np.tile(eye4, (max_cav, 1, 1)),
        "spatial_correction_matrix": np.tile(eye4, (max_cav, 1, 1)),
        "object_bbx_center": np.zeros((max_objects, 7), np.float32),
        "object_bbx_mask": np.zeros(max_objects, np.float32),
        "_poses": [],
    }
