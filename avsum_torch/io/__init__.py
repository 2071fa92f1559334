"""The media layer: numpy, ctypes and struct code, no torch.

The port's own copies of ``avsum_tpu/io/*.py`` (only their imports
changed): WAV read/write and 16 kHz mono loading (``wav``), Y4M
(``y4m``), the native C++ Y4M decoder and shot detector (``native``,
``native/build/libavsumio.so`` built by
:func:`avsum_torch.build.ensure_native_io`), MP4 demux and mux (``mp4``,
``mp4_mux``, ``mp3``), compressed audio through the ffmpeg libraries
(``ffaudio``), OpenCV video (``cv2video``), the reader dispatch
(``video``) and seeded synthetic scene videos (``synthetic``).
"""

from avsum_torch.io.synthetic import write_scene_video
from avsum_torch.io.wav import load_audio_mono_16k_ship

__all__ = ["load_audio_mono_16k_ship", "write_scene_video"]
