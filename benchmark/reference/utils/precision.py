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


class _DotF32(torch.autograd.Function):
    """bmm of two CUDA tensors into a float32 result (cuBLAS accumulates
    in float32).  torch has no derivative for ``bmm``'s ``out_dtype``
    form, so the backward is written out: float32 products of the
    float32 cotangent with the other operand, each gradient rounded once
    to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def dot_f32(a, b):
    """(N, M, K) @ (N, K, P) -> (N, M, P) float32, the product of JAX's
    ``preferred_element_type=jnp.float32``.  On CUDA the operands enter
    the GEMM in their own dtype (bfloat16: every product exact in
    float32, the sum accumulated in float32); on the CPU both are cast to
    float32 first."""
    if a.is_cuda:
        return _DotF32.apply(a, b)
    return torch.bmm(a.float(), b.float())
