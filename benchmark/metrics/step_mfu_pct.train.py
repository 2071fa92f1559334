"""The whole train step's share of the card's dense TF32 peak: the
reference scorer's FLOPs (forward, loss, backward; ``FlopCounterMode`` on
the meta device) at each stepped video's real shot count, over the
traced window."""

from benchmark import counts


def read(run):
    videos = run.window_result.counts.get("video_shots")
    if run.trace is None or not videos:
        return None
    model = run.cell.config["program"]["model"]
    flops = counts.video_flops(model)
    total = sum(flops(n) for n in videos)
    return 100.0 * total / run.trace.window_s / counts.PEAKS["tf32_flops"]
