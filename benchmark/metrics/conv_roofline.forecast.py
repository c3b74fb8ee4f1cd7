"""The decode's dense 3x3 convolutions' share of their roofline in a traced
repetition: the least time their work needs over the device time of the
kernels that do it, inside ``bench.decode``.

The work is counted from the cell's shapes (a frozen copy of the K4 bound
of PERF.md's kernel table): per convolution 18 B H W Cin Cout FLOPs, and
its input, output and weight read or written once in bf16; the least time
is the larger of FLOPs over the bf16 peak and bytes over the HBM
bandwidth. The decoder's dense convolutions: ``conv_in`` at the latent's
size, each upsampler's (to 4 x the next width) and each ResBlock's two at
their stage's size, and ``conv_out``."""

from benchmark.work import least_time_s

UNIT = "%"
# today's kernel, and cuDNN's that could take its place (and the pole rows)
PATTERNS = [r"conv_bf16_wgmma_kernel", r"fprop", r"conv2d", r"implicit_gemm",
            r"convolve", r"winograd"]
LATENT_HW = (15, 30)


def dense_convs(dcae):
    """(H, W, Cin, Cout) of every dense 3x3 conv of one frame's decode."""
    widths, layers = dcae["decoder_block_out_channels"], dcae["decoder_layers_per_block"]
    types = dcae["decoder_block_types"]
    n = len(widths)
    hw = lambda i: (LATENT_HW[0] << (n - 1 - i), LATENT_HW[1] << (n - 1 - i))
    out = [(*LATENT_HW, dcae["latent_channels"], widths[-1])]
    for i in reversed(range(n)):
        if i < n - 1 and layers[i] > 0:
            out.append((*hw(i + 1), widths[i + 1], 4 * widths[i]))
        if types[i] == "ResBlock":
            out += [(*hw(i), widths[i], widths[i])] * (2 * layers[i])
    out.append((*hw(0), widths[0], dcae["out_channels"]))
    return out


def rep_least_s(cfg, traffic):
    B = traffic["members"] * traffic["return_seq_len"]
    return sum(least_time_s(18 * B * h * w * ci * co,
                            2 * (B * h * w * (ci + co) + 9 * ci * co))
               for h, w, ci, co in dense_convs(cfg["dcae"]))


def read(r):
    if r.trace is None or not r.counts.get("reps"):
        return None
    s = r.trace.device_s(PATTERNS, within="bench.decode")
    if s <= 0:
        return None
    return 100.0 * r.counts["reps"] * rep_least_s(r.config, r.traffic) / s
