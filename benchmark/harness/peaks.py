"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""

FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take for a piece of work: the larger of
    its operations over the peak rate and its bytes over the HBM rate."""
    return max(ops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
