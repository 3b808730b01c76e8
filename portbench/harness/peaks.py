"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
full 700 W limit).  Kept here, apart from the program's own constants, so that a
change to the program cannot move the yardstick."""

PEAK_FLOPS_BF16 = 989e12   # FLOP/s, bf16 tensor cores, dense
PEAK_FLOPS_F32 = 67e12     # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12           # bytes/s, HBM3


def peak_flops(elt_bytes: int) -> float:
    """The compute peak for inputs of ``elt_bytes`` bytes (2: bf16, 4: float32)."""
    return PEAK_FLOPS_BF16 if elt_bytes == 2 else PEAK_FLOPS_F32


def least_seconds(flops: float, nbytes: float, elt_bytes: int = 2) -> float:
    """The least time the card could take for the work: operations over the compute
    peak or bytes over the HBM rate, whichever is larger."""
    return max(flops / peak_flops(elt_bytes), nbytes / HBM_BW)
