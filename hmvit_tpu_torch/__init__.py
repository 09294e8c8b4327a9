"""hmvit_tpu_torch — the HM-ViT serving path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``hmvit_tpu``: module paths and class names
mirror it (``hmvit_tpu_torch/models/hetero_fusion.py::HeteroFusion`` is
the counterpart of ``hmvit_tpu/models/hetero_fusion.py::HeteroFusion``),
feature maps stay NHWC at every public function, and
:mod:`hmvit_tpu_torch.bridge` loads a flax ``variables`` tree into a
port module.  The three Pallas kernels of the serving path are CUDA
kernels under ``csrc/``, built with nvcc at first use
(:mod:`hmvit_tpu_torch.ops.cuda`).  On CPU tensors every kernel wrapper
runs its plain PyTorch twin.

The package imports ``torch`` and never ``jax`` or ``flax``.  Host-side
numpy code it shares with the JAX package (synthetic batches, the
anchor grid, pose math, box constants) is imported from the jax-free
modules of ``hmvit_tpu`` rather than copied.
"""

__version__ = "0.1.0"
