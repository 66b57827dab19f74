"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
TENSOR_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12}
FP32_FLOPS = 67e12  # outside the tensor cores
MEMORY_BYTES = 80e9


def matmul_flops(dtype: str) -> float:
    """The peak of a matrix product in ``dtype`` (fp32 with TF32 off runs
    on the CUDA cores)."""
    return TENSOR_FLOPS.get(dtype, FP32_FLOPS)
