"""The whole summarize's share of the card's dense bfloat16 peak: the
backbones' FLOPs per embedded frame (``FlopCounterMode`` over the
reference backbone on the meta device, from the shipped square through
both resizes and both networks) times the frames embedded in the traced
window, over its seconds."""

from benchmark import counts


def read(run):
    frames = run.window_result.counts.get("embedded_frames", 0)
    if run.trace is None or not frames:
        return None
    ship = run.cell.config["program"]["visual"]["ship_size"]
    total = counts.backbone_flops(ship) * frames
    return 100.0 * total / run.trace.window_s / counts.PEAKS["bf16_flops"]
