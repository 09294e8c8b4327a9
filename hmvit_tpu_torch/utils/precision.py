"""Float32 numerics on NVIDIA cards.

cuDNN runs float32 convolutions in TF32 (about three decimal digits) by
default, and a user may have enabled TF32 matmuls too; a float32
reference must turn both off."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_fp32():
    """Disable TF32 for cuDNN convolutions and CUDA matmuls inside the
    block; restore the previous settings after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
