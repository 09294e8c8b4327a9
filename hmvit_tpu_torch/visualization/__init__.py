"""Visualization (port of ``hmvit_tpu/visualization``): BEV images drawn
in numpy (:mod:`.vis`), scenario sequences (:mod:`.sequence`), the
renderer of ``inference --save_npy`` dumps (:mod:`.vis_npy`), the
self-contained 3D HTML viewer (:mod:`.viewer3d`) and side-by-side map
merging (:mod:`.merge_maps`).  None needs matplotlib or OpenCV."""
