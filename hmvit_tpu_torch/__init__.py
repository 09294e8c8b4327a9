"""hmvit_tpu_torch — HM-ViT in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

A port of the JAX package ``hmvit_tpu``: module paths and class names
mirror it (``hmvit_tpu_torch/models/hetero_fusion.py::HeteroFusion`` is
the counterpart of ``hmvit_tpu/models/hetero_fusion.py::HeteroFusion``),
feature maps stay NHWC at every public function, and
:mod:`hmvit_tpu_torch.bridge` loads a flax ``variables`` tree into a
port module.  All nine of the JAX package's Pallas kernels are CUDA
kernels under ``csrc/`` (pair warp, tile and resident; stripe, plain and
typed window attention; fused warp + attention; the lidar encoder's
one-pass segmented max-scan and its two dense-grid expansions), built
with nvcc at first use (:mod:`hmvit_tpu_torch.ops.cuda`).  On CPU tensors every kernel wrapper
runs its plain PyTorch twin.

The package imports ``torch``, ``numpy`` and the standard library:
never ``jax`` or ``flax``, and nothing of ``hmvit_tpu`` or ``bench.py``,
not even their jax-free numpy modules.  What it needs of those
(synthetic batches, the anchor grid, pose math, box constants, the
production configuration) it keeps as its own copies, each pinned to its
original by an equality test in ``tests/test_torch_data.py``.  The JAX
package is the reference the port is tested against, so the two share
no code — a fault in a shared helper would be invisible to every parity
test — and the port runs where ``hmvit_tpu`` is absent.
"""

__version__ = "0.3.0"

# ground-truth / evaluation range [x0, y0, z0, x1, y1, z1] in metres
GT_RANGE = [-102.4, -102.4, -3.0, 102.4, 102.4, 1.0]
# agents farther than this from the ego (metres) send nothing
COM_RANGE = 50.0
