"""The epilogue pair (`csrc/epilogue.cu` ``dc_pass`` and ``finish_pass``):
each file's valid outputs read once, the whole payload written once."""

NAMES = ("dc_pass", "finish_pass")


def work(shape: dict) -> tuple[float, float]:
    C = shape["channels"]
    read = 4 * C * sum(shape["out_frames"])
    written = shape["files"] * C * shape["out_total"] * shape["bytes_out"]
    return 0.0, float(read + written)
