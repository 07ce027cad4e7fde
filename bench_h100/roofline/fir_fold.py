"""The short FIR (`csrc/fold.cu` ``fir_fold_kernel``), the chain's EQ: 2
operations a tap of each output the file's signal reaches, at float32
accuracy; that input read once, the capture written once, the taps once."""

NAMES = ("fir_fold_kernel",)


def work(shape: dict) -> tuple[float, float] | None:
    stages = shape["chain"]
    fir = [s for s in stages if s["stage"] == "biquad" and s["taps"] <= 1024]
    if not fir:
        return None
    delay = sum(s.get("frames", 0) for s in stages[:stages.index(fir[0])])
    taps, C, T = fir[0]["taps"], shape["channels"], shape["out_total"]
    flops = nbytes = 0.0
    for v in shape["valid"]:
        n = min(T, -(-v * shape["L"] // shape["M"]) + delay + taps - 1)
        flops += 2.0 * taps * C * n
        nbytes += 4.0 * C * (n + T)
    return flops, nbytes + 4.0 * taps
