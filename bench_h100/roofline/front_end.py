"""The front end (`csrc/frontend.cu` ``front_end_kernel``): each file's
valid wire bytes read once, the float32 bucket it feeds the SRC written
once; no arithmetic worth counting."""

NAMES = ("front_end_kernel",)


def work(shape: dict) -> tuple[float, float]:
    """``(flops, bytes)`` of one batch."""
    read = sum(shape["valid"]) * shape["channels_in"] * shape["bytes_in"]
    written = shape["files"] * shape["channels"] * shape["bucket"] * 4
    return 0.0, float(read + written)
