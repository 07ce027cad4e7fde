"""The card's published peaks: NVIDIA H100 SXM5 80 GB data sheet, dense
rates, at its full 700 W power limit."""

#: HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = 3.35e12
#: TF32 tensor-core operations per second
TF32_FLOP_PER_S = 495e12
#: float32-accurate multiply-adds: a float32 product takes three TF32
#: products (high x high, high x low, low x high), the fastest published
#: route to float32 accuracy on this card (its float32 cores give 67e12)
FP32_ACCURATE_FLOP_PER_S = TF32_FLOP_PER_S / 3


def bound_s(flops: float, nbytes: float) -> float:
    """The least time for ``flops`` float32-accurate operations and
    ``nbytes`` of HBM traffic."""
    return max(flops / FP32_ACCURATE_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
