"""The port's device shot detector against ``avsum_tpu.temporal.shots`` on
the CPU: the HSV conversion within 1e-4, content scores within 1e-3 with
equal cuts on every golden clip (after the 4:2:0 round trip a Y4M write
and read gives), the golden fixture at the JAX test's tolerances (atol
1.0, rtol 0.2; cuts exact), and the detector's own invariants: chunk
size, streaming against whole-video scoring, the weighted form at equal
weights, the empty video."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsum_tpu.io.synthetic import make_scene_video
from avsum_tpu.ops.color import rgb_to_hsv_channels as jax_rgb_to_hsv
from avsum_tpu.temporal import shots as jax_shots
from avsum_torch.ops.color import rgb_to_hsv_channels
from avsum_torch.temporal import shots
from scripts.gen_shot_fixtures import CLIPS, FIXTURE_PATH, roundtrip_420

HSV_TOL = dict(rtol=1e-4, atol=1e-4)
SCORE_TOL = 1e-3  # float32 means over a frame, summed in another order


@pytest.fixture(scope="module")
def clips():
    return {name: roundtrip_420(make_scene_video(**kwargs)[0])
            for name, kwargs in CLIPS}


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(FIXTURE_PATH, allow_pickle=False))


KNOWN = np.array([[0, 0, 0], [255, 255, 255], [128, 128, 128], [255, 0, 0],
                  [0, 255, 0], [0, 0, 255], [255, 255, 0], [0, 255, 255],
                  [255, 0, 255], [10, 200, 120], [200, 10, 121],
                  [37, 38, 37]], np.uint8)


@pytest.mark.parametrize("case", ["known", "noise", "near_gray"])
def test_hsv_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "known":
        rgb = KNOWN[None]
    elif case == "noise":
        rgb = rng.integers(0, 256, (4, 33, 17, 3), dtype=np.uint8)
    else:  # hue is ill-conditioned here: the order of operations matters
        base = rng.integers(60, 200, (4, 33, 17, 1))
        rgb = (base + rng.integers(-2, 3, (4, 33, 17, 3))).astype(np.uint8)
    got = rgb_to_hsv_channels(torch.from_numpy(rgb))
    want = jax_rgb_to_hsv(jnp.asarray(rgb))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **HSV_TOL)
    if case == "known":
        h, s, v = (c.numpy()[0] for c in got)
        np.testing.assert_allclose(h[3:9], [0, 60, 120, 30, 90, 150])
        assert (s[:3] == 0).all() and (v[:2] == [0, 255]).all()


@pytest.mark.parametrize("name", [name for name, _ in CLIPS])
def test_content_scores_match_jax_and_golden(clips, golden, name):
    video = clips[name]
    got = shots.content_scores(torch.from_numpy(video))
    assert got.dtype == torch.float32 and got[0] == 0.0
    got = got.numpy()
    want = np.asarray(jax_shots.content_scores(video))
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
    assert shots.cuts_from_scores(got) == jax_shots.cuts_from_scores(want)
    ref = golden[f"{name}/scores"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1.0, rtol=0.2)
    assert shots.cuts_from_scores(got) == golden[f"{name}/cuts"].tolist()


@pytest.mark.parametrize("chunk", [7, 64, 512])
def test_detect_shots_is_chunk_invariant_and_matches_jax(clips, chunk):
    video = clips["many_short"]
    got = shots.detect_shots(video, chunk_size=chunk, device="cpu")
    np.testing.assert_array_equal(got, shots.detect_shots(
        video, chunk_size=len(video), device="cpu"))
    np.testing.assert_array_equal(got, jax_shots.detect_shots(
        video, chunk_size=chunk))
    assert len(got) == 12 and got[0, 0] == 0 and got[-1, 1] == len(video)


def test_streaming_equals_batch(clips):
    video = clips["easy_6_scenes"]
    chunks = [video[i:i + n] for i, n in
              zip(np.cumsum([0, 50, 1, 100, 0]), [50, 1, 100, 0, 1000])]
    got, total = shots.detect_shots_streaming(iter(chunks), device="cpu")
    assert total == len(video)
    np.testing.assert_array_equal(got, shots.detect_shots(video,
                                                          device="cpu"))
    want, want_total = jax_shots.detect_shots_streaming(iter(chunks))
    np.testing.assert_array_equal(got, want)
    assert total == want_total


def test_weighted_equals_unweighted_at_equal_weights(clips):
    video = torch.from_numpy(clips["long_scenes"][:40])
    plain = shots.content_scores(video)
    for w in (1.0, 2.5):
        cfg = shots.ContentDetectorConfig(weight_hue=w, weight_sat=w,
                                          weight_lum=w)
        torch.testing.assert_close(shots.content_scores_weighted(video, cfg),
                                   plain, rtol=1e-6, atol=1e-5)
    cfg = shots.ContentDetectorConfig(weight_hue=0.0, weight_sat=0.0)
    h, s, v = rgb_to_hsv_channels(video)
    lum = torch.cat([torch.zeros(1), (v[1:] - v[:-1]).abs().mean(dim=(1, 2))])
    torch.testing.assert_close(shots.content_scores_weighted(video, cfg), lum)
    np.testing.assert_allclose(
        shots.content_scores_weighted(video, cfg).numpy(),
        np.asarray(jax_shots.content_scores_weighted(jnp.asarray(
            video.numpy()), jax_shots.ContentDetectorConfig(
                weight_hue=0.0, weight_sat=0.0))), rtol=0, atol=SCORE_TOL)


def test_empty_video():
    empty = np.zeros((0, 8, 8, 3), np.uint8)
    assert shots.detect_shots(empty, device="cpu").shape == (0, 2)
    bounds, total = shots.detect_shots_streaming(iter([empty]), device="cpu")
    assert bounds.shape == (0, 2) and total == 0
    one = shots.detect_shots(np.full((1, 8, 8, 3), 9, np.uint8), device="cpu")
    np.testing.assert_array_equal(one, [[0, 1]])


def test_detector_config_fields_equal_the_jax_packages():
    """A cache's fingerprint hashes these fields: both packages must
    write the same one."""
    import dataclasses

    assert (dataclasses.asdict(shots.ContentDetectorConfig())
            == dataclasses.asdict(jax_shots.ContentDetectorConfig()))
    assert os.path.exists(FIXTURE_PATH)
