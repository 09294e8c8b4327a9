"""The plain reference of the benchmark: a frozen copy of the plain path
of ``hmvit_tpu_torch`` (the PyTorch twins in place of every hand-written
kernel), taken when the benchmark was written and never imported from
the program, cut to what the benchmark's configurations and train step
run.  The benchmark runs it in float32 with TF32 off on the same seeded
weights and requests it hands the program, and compares.

Departures from the program's files, all of them:

* ``ops/__init__.py::use_kernel`` is always False and ``ops/cuda.py`` is
  a stub: every kernel wrapper runs its twin, on any device;
* ``models/hmvit.py`` builds the camera encoder ``encoder`` names from
  ``models/<encoder>.py``'s ``CAMERA_ENCODER`` (``bevformer.py`` and
  ``bevformer_ref.py`` end with it), the H3GAT fusion only (no
  ``fusion_override``), on one device (no spatial partitioning);
* ``models/bevformer.py`` is the planar lift alone, on one ResNet stage
  (no FPN, no deformable lift, no BEV decoder), its window
  self-attention copied in from ``models/fusion/v2xvit.py``;
  ``models/bevformer_ref.py`` has the camera trunk, not the late-fusion
  detector, and ``fax_ref.py``'s ``inv`` / ``mm`` copied in;
* ``models/hetero_fusion.py`` has no fused warp + attention
  (``use_fused_wa``), no spatial partitioning and no tensor
  parallelism; ``nn.py`` and ``models/layers.py`` no tensor or data
  parallelism (one process);
* ``train/losses.py`` is ``point_pillar_loss`` alone;
* ``utils/nms.py`` keeps the device NMS only, ``utils/iou.py`` the
  device IoU and the anchors' axis-aligned one, ``postprocess.py``
  ``decode_detections_device`` only.

A configuration whose camera encoder or fusion is not here adds its own
file under ``models/``, copied from the port's plain path.
"""

# ground-truth / evaluation range [x0, y0, z0, x1, y1, z1] in metres
GT_RANGE = [-102.4, -102.4, -3.0, 102.4, 102.4, 1.0]
