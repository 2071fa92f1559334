"""The port's large audio encoder (``audio.encoder: large``) against
``avsum_tpu/audio/vggish.py::LargeAudioEncoder``, weights carried by
``avsum_torch.convert.vggish_from_flax`` (the ``convert --vggish``
route): two log-mel patches; the 296-d ``AudioFrontend`` with it on a
3 s waveform; its channel LayerNorm against a per-pixel reference; the
CLI's pipeline builds it. float32, JAX at "highest" precision: rtol
1e-4, atol 1e-5 on the embedding (ten convolutions deep), the audio
tests' 1e-4 on the pooled features."""

import jax
import numpy as np
import torch

from avsum_tpu.audio.frontend import AudioFrontend as JaxAudioFrontend
from avsum_tpu.audio.vggish import LargeAudioEncoder as JaxLarge
from avsum_tpu.train.config import AudioFeatConfig as JaxAudioFeatConfig
from avsum_tpu.vision.backbone import fast_init
from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.audio.vggish import LargeAudioEncoder, make_audio_encoder
from avsum_torch.cli.main import build_pipeline
from avsum_torch.convert import vggish_from_flax
from avsum_torch.train.config import AudioFeatConfig, load_config

EMBED_TOL = dict(rtol=1e-4, atol=1e-5)
FEATURE_TOL = dict(rtol=1e-4, atol=1e-4)


def _params(seed=3):
    params = fast_init(JaxLarge(), np.zeros((1, 96, 64), np.float32),
                       seed=seed)["params"]
    rng = np.random.default_rng(seed)
    # LayerNorms off their identity init, so the converter's scale / bias
    # mapping is seen
    return {name: ({k: v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
                    for k, v in leaves.items()} if name.startswith("ln")
                   else leaves)
            for name, leaves in params.items()}


def test_large_encoder_matches_jax():
    params = _params()
    patches = np.random.default_rng(4).standard_normal((2, 96, 64))
    patches = patches.astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(JaxLarge().apply)({"params": params},
                                                    patches))
    model = LargeAudioEncoder()
    model.load_state_dict(vggish_from_flax(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(patches))
    assert got.shape == (2, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **EMBED_TOL)


def test_channel_layer_norm_is_per_pixel():
    """The LayerNorm normalizes each pixel's channels (NHWC last axis),
    with epsilon 1e-6, not the whole feature map."""
    model = LargeAudioEncoder()
    conv, ln = model.conv1_1, model.ln1_1
    x = torch.randn(1, 1, 8, 6)
    with torch.no_grad():
        y = conv(x.contiguous(memory_format=torch.channels_last))
        got = ln(y.permute(0, 2, 3, 1))
        ref = torch.nn.functional.layer_norm(
            conv(x).permute(0, 2, 3, 1).contiguous(), (96,), eps=1e-6)
    assert ln.eps == 1e-6
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_frontend_with_large_encoder_matches_jax():
    params = _params(seed=5)
    rng = np.random.default_rng(9)
    t = np.arange(3 * 16000 + 77) / 16000
    wave = (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    bounds = np.array([[0, 9000], [9000, 30000], [30000, 48077]], np.float64)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JaxAudioFrontend(
            JaxAudioFeatConfig(encoder="large"), params,
            use_pallas=False).shot_features(wave, bounds))
    encoder = make_audio_encoder("large")
    encoder.load_state_dict(vggish_from_flax(params))
    got = AudioFrontend(AudioFeatConfig(encoder="large"), encoder,
                        "cpu").shot_features(wave, bounds)
    assert got.shape == (3, 296)
    np.testing.assert_allclose(got.numpy(), ref, **FEATURE_TOL)


def test_cli_pipeline_builds_the_large_encoder():
    cfg = load_config(overrides=["audio.encoder=large", "visual.backbone=tiny",
                                 "visual.dtype=float32",
                                 "audio.dtype=bfloat16"])
    pipeline, _ = build_pipeline(cfg, "cpu", seed=1, with_scorer=False)
    encoder = pipeline.audio.vggish
    assert isinstance(encoder, LargeAudioEncoder)
    assert encoder.conv4_3.weight.dtype == torch.bfloat16
    with torch.inference_mode():
        out = encoder(torch.zeros(1, 96, 64))
    assert out.shape == (1, 128) and out.dtype == torch.float32
