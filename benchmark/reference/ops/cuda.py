"""Stand-in for the port's kernel launcher: the reference launches no
kernel.  The wrappers read :data:`DTYPE_CODES` only on the kernel path,
which :func:`benchmark.reference.ops.use_kernel` never takes."""
import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
