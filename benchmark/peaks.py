"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): the yardstick of every roofline and MFU metric."""

HBM_BYTES_PER_S = 3.35e12
# operations a second by operand type: bf16 on the tensor cores, float32
# on the CUDA cores (a float32 product at full precision)
OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# the dense bf16 peak an MFU is taken against
MFU_PEAK_FLOPS = 989e12
# the port's kernel dtype codes (its ``ops/cuda.py::DTYPE_CODES``)
DTYPE_CODES = {0: ("float32", 4), 1: ("bfloat16", 2)}


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least time the card could take: the bytes once at the memory
    rate or the operations at the type's peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[dtype])
