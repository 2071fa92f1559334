"""The port's audio modules against the JAX package on the same inputs:
spectral ops, VGGish and its patch front-end, and the 296-d
AudioFrontend. float32; rtol 1e-4, with an atol of 1e-4 where outputs
cross zero (MFCC coefficients, ReLU outputs) or are dB values summed
over 128 bands."""

import warnings

import jax
import numpy as np
import pytest
import torch

from avsum_tpu.audio.frontend import AudioFrontend as JaxAudioFrontend
from avsum_tpu.audio.vggish import VGGish as JaxVGGish
from avsum_tpu.audio.vggish import vggish_log_mel_patches as jax_patches
from avsum_tpu.ops import spectral as jsp
from avsum_tpu.train.config import AudioFeatConfig as JaxAudioFeatConfig
from avsum_tpu.vision.backbone import fast_init
from avsum_torch.audio import frontend as frontend_mod
from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.audio.vggish import VGGish, vggish_log_mel_patches
from avsum_torch.convert import vggish_from_flax
from avsum_torch.ops import spectral as tsp
from avsum_torch.train.config import AudioFeatConfig

TOL = dict(rtol=1e-4, atol=1e-4)


def _wave(n=24_000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32)


SPECTRAL = {
    "power_spectrogram": lambda m, w: m.power_spectrogram(w),
    "mel_spectrogram": lambda m, w: m.mel_spectrogram(w),
    "mel_vggish_band": lambda m, w: m.mel_spectrogram(
        w, n_fft=400, hop_length=160, n_mels=64, f_min=125.0, f_max=7500.0),
    "mfcc": lambda m, w: m.mfcc(w),
    "amplitude_to_db": lambda m, w: m.amplitude_to_db(m.mel_spectrogram(w)),
}


@pytest.mark.parametrize("name", sorted(SPECTRAL))
def test_spectral_ops_match_jax(name):
    wave = _wave()
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(SPECTRAL[name](jsp, wave))
    got = SPECTRAL[name](tsp, torch.from_numpy(wave)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_amplitude_to_db_clamps_to_whole_tensor_max():
    power = np.array([[1e-12, 1.0], [1e4, 1e-3]], np.float32)
    got = tsp.amplitude_to_db(torch.from_numpy(power)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsp.amplitude_to_db(power)),
                               rtol=1e-6)
    assert got.min() == pytest.approx(40.0 - 80.0)


@pytest.fixture(scope="module")
def vggish_params():
    return fast_init(JaxVGGish(), np.zeros((1, 96, 64), np.float32),
                     seed=3)["params"]


def test_vggish_patch_matches_jax(vggish_params):
    """One 96x64 patch; also pins the NHWC flatten before fc1_1."""
    patch = np.random.default_rng(4).standard_normal((1, 96, 64))
    patch = patch.astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JaxVGGish().apply({"params": vggish_params}, patch))
    model = VGGish()
    model.load_state_dict(vggish_from_flax(vggish_params))
    with torch.inference_mode():
        got = model(torch.from_numpy(patch)).numpy()
    assert got.shape == (1, 128)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [5_000, 40_000])
def test_vggish_patches_match_jax(n):
    wave = _wave(n, seed=n)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_patches(wave))
    got = vggish_log_mel_patches(torch.from_numpy(wave)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_shot_features_match_jax(vggish_params, dtype):
    wave = _wave(3 * 16000 + 77, seed=9)
    if dtype == "int16":
        wave = np.round(wave * 32767).astype(np.int16)
    bounds = np.array([[0, 9000], [9000, 9100], [9100, 30000],
                       [30000, 48077], [47000, 60000]], np.float64)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JaxAudioFrontend(JaxAudioFeatConfig(), vggish_params,
                                          use_pallas=False)
                         .shot_features(wave, bounds))
    vggish = VGGish()
    vggish.load_state_dict(vggish_from_flax(vggish_params))
    got = AudioFrontend(AudioFeatConfig(), vggish, "cpu").shot_features(
        wave, bounds)
    assert got.shape == (5, 296)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("via", ["config", "argument"])
def test_use_pallas_false_keeps_the_kernel_off(monkeypatch, vggish_params,
                                               via):
    """``audio.use_pallas=False`` (in the config, or as the argument) takes
    the plain spectral path: the kernel's wrapper is never called, and the
    features equal the JAX front-end's XLA path."""
    def refuse(*args, **kwargs):
        raise AssertionError("fused_log_mel called with use_pallas=False")

    monkeypatch.setattr(frontend_mod, "fused_log_mel", refuse)
    wave = _wave(2 * 16000 + 301, seed=12)
    bounds = np.array([[0, 12000], [12000, 20000], [20000, 32301]],
                      np.float64)
    flag = False if via == "config" else None
    cfg = AudioFeatConfig(use_pallas=flag)
    kwargs = {"use_pallas": False} if via == "argument" else {}
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JaxAudioFrontend(JaxAudioFeatConfig(use_pallas=flag),
                                          vggish_params, use_pallas=False)
                         .shot_features(wave, bounds))
    vggish = VGGish()
    vggish.load_state_dict(vggish_from_flax(vggish_params))
    front = AudioFrontend(cfg, vggish, "cpu", **kwargs)
    assert front.use_kernel is False
    got = front.shot_features(wave, bounds)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("flag,n_fft,kernel,warns", [
    (None, 400, True, False), (True, 400, True, False),
    (False, 400, False, False), (None, 512, False, False),
    (True, 512, False, True)])
def test_use_pallas_resolves_like_the_jax_front_end(monkeypatch, flag, n_fft,
                                                    kernel, warns):
    """None and True turn the kernel on, False off; an explicit True with
    n_fft != 2 * hop_length warns and takes the plain path, as
    ``avsum_tpu.audio.frontend.AudioFrontend`` does."""
    calls = []
    real = frontend_mod.fused_log_mel

    def spy(*args, **kwargs):
        calls.append(kwargs["n_mels"])
        return real(*args, **kwargs)

    monkeypatch.setattr(frontend_mod, "fused_log_mel", spy)
    cfg = AudioFeatConfig(n_fft=n_fft, hop_length=200, use_pallas=flag)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        front = AudioFrontend(cfg, VGGish(), "cpu")
    refused = [w for w in caught if "n_fft == 2*hop_length" in str(w.message)]
    assert len(refused) == len(caught) == int(warns)
    assert front.use_kernel is kernel
    mf, lm, _ = front.dispatch_full(_wave(16000, seed=2))  # padded to 2^14
    assert lm.shape == (82, 128) and mf.shape == (82, 40)
    assert calls == ([128] if kernel else [])
