"""The reverb's frequency-domain multiply-sum (`csrc/upols.cu`
``upols_mac_*``): uniform-partitioned overlap-save with blocks of ``B``
frames (4096, doubled while the IR is over 64 blocks), ``K`` partitions of
the IR and ``B + 1`` bins; each output block sums the complex products of
the ``K`` latest input spectra by the partitions, 8 operations a bin and a
product, counted where the input block holds signal, at float32 accuracy.
Bytes: those input spectra read once, the partitions once, every output
spectrum written once, all complex64."""

NAMES = ("upols_mac",)


def work(shape: dict) -> tuple[float, float] | None:
    stages = shape["chain"]
    rev = [s for s in stages if s["stage"] == "reverb"]
    if not rev:
        return None
    ir = rev[0]
    B = 4096
    while ir["ir_frames"] > 64 * B:
        B *= 2
    K, bins = -(-ir["ir_frames"] // B), B + 1
    before = stages[:stages.index(ir)]
    reach = (sum(s.get("frames", 0) for s in before)
             + sum(s.get("taps", 1) - 1 for s in before if s["stage"] == "biquad"))
    T, C = shape["out_total"], shape["channels"]
    nb = -(-T // B)
    flops = nbytes = 0.0
    for v in shape["valid"]:
        z = min(nb, -(-(-(-v * shape["L"] // shape["M"]) + reach) // B))
        products = sum(min(K, nb - j) for j in range(z))
        flops += 8.0 * bins * C * products
        nbytes += 8.0 * bins * C * (z + nb)
    return flops, nbytes + 8.0 * bins * K * ir["ir_channels"]
