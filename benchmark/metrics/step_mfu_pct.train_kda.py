"""The whole train step's share of the card's dense TF32 peak, for the
scorer with Kimi-Linear-48B-A3B's hybrid decoder: the step's model FLOPs
(``counts_kda.window_flops``: the dense parts by ``FlopCounterMode`` over
the reference on the meta device, the token recurrence left out; KDA's
chunked core at a chunk of 64; latent attention at its true 192 / 128
widths; the routed experts over the pairs the port computed,
``moe.routed_held``) over the traced window."""

from benchmark import counts, counts_kda


def read(run):
    videos = run.window_result.counts.get("video_shots")
    pairs = run.window_result.counts.get("moe.routed_held")
    if run.trace is None or not videos or pairs is None:
        return None
    flops = counts_kda.window_flops(run.cell.config["program"]["model"],
                                    videos, pairs)
    return 100.0 * flops / run.trace.window_s / counts.PEAKS["tf32_flops"]
