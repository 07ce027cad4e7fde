"""The SRC (`csrc/cycle_src.cu`): 2 operations a non-zero tap of each
output a file's samples reach, at float32 accuracy; the valid input read
once, the output written once, the bank's non-zero taps read once."""

NAMES = ("cycle_src",)


def _taps(taps: list, n: int) -> int:
    """Non-zero taps of outputs 0 .. n-1 (phase ``t % L``)."""
    full, rest = divmod(n, len(taps))
    return full * sum(taps) + sum(taps[:rest])


def work(shape: dict) -> tuple[float, float]:
    L, M, C = shape["L"], shape["M"], shape["channels"]
    flops = nbytes = 0.0
    for v in shape["valid"]:
        n = min(-(-v * L // M), shape["src_out"])
        flops += 2.0 * C * _taps(shape["taps"], n)
        nbytes += 4.0 * C * (v + shape["src_out"])
    return flops, nbytes + 4.0 * sum(shape["taps"])
