"""The whole train step's share of the card's dense TF32 peak, for the
scorer with Moonlight-16B-A3B's decoder: the step's model FLOPs
(``counts_decoder.window_flops``: the dense parts by ``FlopCounterMode``
over the reference on the meta device, the MLA's attention at its true
192 / 128 widths, the routed experts over the pairs the port computed,
``moe.routed_held``) over the traced window."""

from benchmark import counts, counts_decoder


def read(run):
    videos = run.window_result.counts.get("video_shots")
    pairs = run.window_result.counts.get("moe.routed_held")
    if run.trace is None or not videos or pairs is None:
        return None
    flops = counts_decoder.window_flops(run.cell.config["program"]["model"],
                                        videos, pairs)
    return 100.0 * flops / run.trace.window_s / counts.PEAKS["tf32_flops"]
