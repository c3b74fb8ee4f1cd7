"""The forecast attention's share of its roofline in a traced repetition:
the least time its work needs over the device time of the kernels that do
it, inside ``bench.rollout``.

The work is counted from the cell's shapes, whatever kernel does it (the
formula is a frozen copy of the K1 bound of PERF.md's kernel table): per
attention 4 B H S^2 D FLOPs and B S H D bytes of each of q, k, v and the
output in bf16, at S = (frames + conditioning frames) x 450 tokens in the
dual- and single-stream blocks and S = conditioning frames x 450 in the
refiner's; the least time is the larger of FLOPs over the bf16 peak and
bytes over the HBM bandwidth, summed over the attentions of each DiT
call."""

from benchmark.work import least_time_s

UNIT = "%"
# today's kernel, and the library kernels that could take its place
PATTERNS = [r"fa_bf16_wgmma_kernel", r"flash_fwd", r"fmha", r"sdpa", r"flash_attn",
            r"attention_forward"]
TOKENS_PER_FRAME = 15 * 30


def attentions(cfg, traffic):
    """(FLOPs, bytes) of each attention of one DiT call."""
    d = cfg["dit"]
    B, H, D = traffic["members"], d["num_attention_heads"], d["attention_head_dim"]
    s_joint = (traffic["return_seq_len"] + traffic["input_seq_len"]) * TOKENS_PER_FRAME
    s_cond = traffic["input_seq_len"] * TOKENS_PER_FRAME
    out = []
    for n, S in ((d["num_layers"] + d["num_single_layers"], s_joint),
                 (d["num_refiner_layers"], s_cond)):
        out += [(4 * B * H * S * S * D, 4 * B * S * H * D * 2)] * n
    return out


def call_least_s(cfg, traffic):
    return sum(least_time_s(f, b) for f, b in attentions(cfg, traffic))


def read(r):
    if r.trace is None or not r.counts.get("dit_calls"):
        return None
    s = r.trace.device_s(PATTERNS, within="bench.rollout")
    if s <= 0:
        return None
    return 100.0 * r.counts["dit_calls"] * call_least_s(r.config, r.traffic) / s
