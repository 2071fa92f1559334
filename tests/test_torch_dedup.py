"""Frame dedup (``visual.dedup_threshold``) in the port against the JAX
package (``tests/test_dedup.py``'s cases): ``_dedup_select`` equal to
JAX's on seeded blocks; a tiny threshold (every frame its own run) equal
to no dedup; a moderate one equal to JAX's dedup run, with the same
boundaries as no dedup and close features; a run crossing shot
boundaries pooling into every shot it covers; fewer frames embedded.
Tiny backbone and VGGish converted from Flax, float32, batches of 8 so the
kept frames span several dispatches."""

import jax
import numpy as np
import pytest

from avsum_tpu.pipeline import AVPipeline as JaxPipeline
from avsum_tpu.pipeline import _dedup_select as jax_dedup_select
from avsum_tpu.train.config import load_config as jax_load_config
from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.audio.vggish import VGGish
from avsum_torch.convert import tiny_backbone_from_flax, vggish_from_flax
from avsum_torch.io.native import native_available
from avsum_torch.io.synthetic import write_scene_video
from avsum_torch.pipeline import AVPipeline, _dedup_select
from avsum_torch.train.config import load_config
from avsum_torch.vision.backbone import VisualFrontend, make_backbone

SLICE = ["visual.backbone=tiny", "visual.dtype=float32", "audio.dtype=float32",
         "audio.silence_fallback=true"]
TOL = dict(rtol=1e-4, atol=1e-4)
MODERATE = 12.0

needs_native = pytest.mark.skipif(not native_available(),
                                  reason="libavsumio.so not built")


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
def test_dedup_select_equals_jax(density):
    """Whole and in blocks of 16 with the anchor carried across."""
    rng = np.random.default_rng(7)
    n, hw, thr = 97, 64, 10.0
    frames = np.zeros((n, hw), np.int16)
    level = 0
    for i in range(n):
        if rng.random() < density:
            level += 40
        frames[i] = level + rng.integers(0, 3, hw)
    got, anchor = _dedup_select(frames, None, thr)
    want, jax_anchor = jax_dedup_select(frames, None, thr)
    assert got == want
    np.testing.assert_array_equal(anchor, jax_anchor)
    blocks, anc = [], None
    for s in range(0, n, 16):
        k, anc = _dedup_select(frames[s:s + 16], anc, thr)
        blocks.extend(s + j for j in k)
    assert blocks == want


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    stem = str(tmp_path_factory.mktemp("dedup") / "clip")
    write_scene_video(stem, n_scenes=4, seed=17, fps=8.0, height=64, width=96,
                      scene_len_frames=(24, 40))
    return stem + ".y4m"


@pytest.fixture(scope="module")
def make():
    """threshold -> (JAX pipeline, port pipeline) with the same weights."""
    jax_pipe = JaxPipeline(jax_load_config(overrides=SLICE))
    backbone = tiny_backbone_from_flax(jax_pipe.visual.variables)
    vggish = VGGish()
    vggish.load_state_dict(vggish_from_flax(jax_pipe.audio.vggish_params))

    def _make(threshold):
        over = SLICE + [f"visual.dedup_threshold={threshold}",
                        "visual.batch_size=8"]
        jp = JaxPipeline(jax_load_config(overrides=over),
                         visual_frontend=jax_pipe.visual,
                         audio_frontend=jax_pipe.audio)
        cfg = load_config(overrides=over)
        pipe = AVPipeline(
            cfg, VisualFrontend(cfg.visual, make_backbone(
                cfg.visual, state_dict=backbone), "cpu"),
            AudioFrontend(cfg.audio, vggish, "cpu"))
        return jp, pipe

    jax_pipe.visual.batch_size = 8  # several dispatches, as the port's
    return _make


def _process_jax(jp, path):
    with jax.default_matmul_precision("highest"):
        return jp.process_video(path)


@needs_native
def test_tiny_threshold_is_exact(video, make):
    """Per-frame noise exceeds a tiny threshold: every frame is its own
    run, so the features equal no dedup's (identity gather)."""
    _, off = make(0.0)
    _, tiny = make(1e-6)
    a, b = off.process_video(video), tiny.process_video(video)
    np.testing.assert_array_equal(a.boundaries, b.boundaries)
    np.testing.assert_allclose(b.visual, a.visual, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(a.audio, b.audio)


@needs_native
def test_moderate_threshold_matches_jax(video, make):
    jp, pipe = make(MODERATE)
    want = _process_jax(jp, video)
    got = pipe.process_video(video)
    np.testing.assert_array_equal(got.boundaries, want.boundaries)
    np.testing.assert_allclose(got.visual, want.visual, **TOL)
    np.testing.assert_allclose(got.audio, want.audio, **TOL)
    # against no dedup: the same shots, close features
    off = make(0.0)[1].process_video(video)
    np.testing.assert_array_equal(off.boundaries, got.boundaries)
    a = off.visual / np.linalg.norm(off.visual, axis=1, keepdims=True)
    b = got.visual / np.linalg.norm(got.visual, axis=1, keepdims=True)
    assert (a * b).sum(1).min() > 0.98


@needs_native
def test_summarize_with_dedup_matches_jax(video, make):
    """The device-resident summarize with dedup on: boundaries, segments
    and scores against JAX's summarize."""
    import jax.numpy as jnp

    from avsum_tpu.models import make_model as jax_make_model
    from avsum_torch.convert import scorer_from_flax
    from avsum_torch.models.scorer import make_model

    jp, pipe = make(MODERATE)
    jmodel = jax_make_model(jp.config.model)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 4096)),
                         jnp.zeros((1, 8, 296)), jnp.ones((1, 8)))["params"]
    with jax.default_matmul_precision("highest"):
        want = jp.summarize(video, jmodel, params)
    got = pipe.summarize(video, make_model(
        pipe.config.model, state_dict=scorer_from_flax(params)))
    np.testing.assert_array_equal(got["boundaries"], want["boundaries"])
    np.testing.assert_array_equal(got["segments"], want["segments"])
    np.testing.assert_allclose(got["scores"], want["scores"], **TOL)


@needs_native
def test_run_crossing_shot_boundaries_pools_correctly(video, make):
    """A huge threshold merges everything into one run: every shot pools
    that one embedding, as in JAX."""
    jp, pipe = make(1e9)
    got = pipe.process_video(video)
    assert len(got.boundaries) >= 2 and np.isfinite(got.visual).all()
    for row in got.visual:
        np.testing.assert_allclose(row, got.visual[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.visual, _process_jax(jp, video).visual,
                               **TOL)


@needs_native
def test_dedup_embeds_fewer_frames(video, make, monkeypatch):
    shipped = {}
    for key, thr in (("off", 0.0), ("on", MODERATE)):
        _, pipe = make(thr)
        real = pipe.visual.dispatch_yuv
        shipped[key] = 0

        def counting(y, u, v, key=key, real=real):
            shipped[key] += y.shape[0]
            return real(y, u, v)

        monkeypatch.setattr(pipe.visual, "dispatch_yuv", counting)
        pipe.process_video(video)
    assert 0 < shipped["on"] < shipped["off"]
