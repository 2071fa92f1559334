"""Device milliseconds a video of the audio front-end: the operations
launched inside ``avsum.audio_embed`` (K1, the spectra and VGGish) or
``avsum.audio_pool`` (the per-shot pooling), over the completed videos;
nothing where ``avsum.audio_embed`` launched nothing, since the pooling
alone is not the front-end."""

from benchmark.spans import device_ms_per, launched_in


def read(run):
    if not launched_in(run.trace, ["avsum.audio_embed"]):
        return None
    return device_ms_per(run, ["avsum.audio_embed", "avsum.audio_pool"],
                         "videos")
