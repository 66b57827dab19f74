"""Each hand-written kernel's work for one call, and the least time the
card could take for it.

Frozen copies of ``repro_torch.kernels.{rmsnorm,flash_attention,
ssd_scan}.cost`` (as of the benchmark's first version): each input byte
read once and each output byte written once, matrix-product FLOPs at 2
a multiply-add.  ``bound_s`` is the larger of FLOPs over the dtype's
matrix peak and bytes over the HBM bandwidth.
"""

from .peaks import HBM_BYTES_PER_S, matmul_flops

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def rmsnorm(m: int, d: int, dtype: str = "bfloat16") -> dict:
    """(m, d) rows: x read and y written once, the fp32 weight read once;
    4 operations an element, no matrix product."""
    e = BYTES[dtype]
    return {"flops": 0, "operations": 4 * m * d, "bytes": 2 * m * d * e + 4 * d}


def flash_attention(b: int, s: int, h: int, kh: int, d: int, causal: bool = True,
                    dtype: str = "bfloat16") -> dict:
    """The query-key pairs (S(S+1)/2 a row and head when causal), two
    products of ``d`` multiply-adds each; q, k, v read and o written once."""
    e = BYTES[dtype]
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    flops = 4 * pairs * d
    return {"flops": flops, "operations": flops,
            "bytes": e * (2 * b * s * h * d + 2 * b * s * kh * d)}


def ssd_scan(b: int, s: int, h: int, p: int, n: int, chunk: int,
             dtype: str = "bfloat16") -> dict:
    """Per (row, head, chunk) the lower triangles of C B^T and of M X, the
    chunk's state readout and update; x in and y out, B and C in, in the
    dtype; fp32 dt in, fp32 state out, fp32 a_log."""
    e = BYTES[dtype]
    q = chunk
    tri = q * (q + 1) // 2
    flops = 2 * b * h * (s // q) * (tri * n + tri * p + 2 * q * n * p)
    return {"flops": flops, "operations": flops,
            "bytes": (2 * e * b * s * h * p + 4 * b * s * h + 4 * b * h * p * n
                      + 2 * e * b * s * n + 4 * h)}


def bound_s(cost: dict, dtype: str = "bfloat16") -> float:
    return max(cost["flops"] / matmul_flops(dtype), cost["bytes"] / HBM_BYTES_PER_S)


def bound_by(cost: dict, dtype: str = "bfloat16") -> str:
    """Which of the two bounds is the larger: ``"bytes"`` or ``"flops"``."""
    return "flops" if cost["flops"] / matmul_flops(dtype) > cost["bytes"] / HBM_BYTES_PER_S \
        else "bytes"
