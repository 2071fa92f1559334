"""The media layer, shared with ``avsum_tpu`` (``avsum_tpu.io`` is numpy
and ctypes, no jax): 16 kHz mono audio and seeded synthetic scene videos."""

from avsum_tpu.io.synthetic import write_scene_video
from avsum_tpu.io.wav import load_audio_mono_16k_ship

__all__ = ["load_audio_mono_16k_ship", "write_scene_video"]
