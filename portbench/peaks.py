"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit): the yardstick of every roofline and ``mfu`` share.
A card set below 700 W runs slower under load; the harness prints its limit
beside every share."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory bandwidth and the operations over the peak rate of ``dtype``."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype])
