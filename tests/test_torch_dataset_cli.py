"""The dataset path through the port's CLI on the CPU at tiny widths:
``preprocess`` -> ``splits --kfold`` -> ``train --splits --fold 0`` ->
``evaluate --splits --fold 0 --canonical``, on SumMe-shaped ground truth
(``scipy.io.savemat``) and on TVSum's (``tests/helpers``). The splits
file equals the JAX CLI's on the same cache; ``Trainer.score_video`` and
``evaluate_videos`` with converted weights equal the JAX trainer's within
1e-5; ``summarize DIR`` writes one JSON per video and ``--render`` the
same frames and audio as ``avsum_tpu.summary.render``."""

import argparse
import json
import os

import jax
import numpy as np
import pytest
import scipy.io

from avsum_tpu.cli.main import cmd_splits as jax_cmd_splits
from avsum_tpu.data.batching import batch_iterator as jax_batch_iterator
from avsum_tpu.data.batching import pad_batch as jax_pad_batch
from avsum_tpu.io.y4m import Y4MReader
from avsum_tpu.io.wav import read_wav
from avsum_tpu.models import make_model as jax_make_model
from avsum_tpu.summary.render import render_summary as jax_render_summary
from avsum_tpu.train.config import load_config as jax_load_config
from avsum_tpu.train.trainer import Trainer as JaxTrainer
from avsum_torch import build
from avsum_torch.cli.main import main
from avsum_torch.convert import scorer_from_flax
from avsum_torch.data.batching import batch_iterator
from avsum_torch.data.cache import FeatureCache
from avsum_torch.data.splits import load_splits
from avsum_torch.io.native import native_available
from avsum_torch.io.synthetic import write_scene_video
from avsum_torch.models.scorer import make_model
from avsum_torch.train.config import load_config
from avsum_torch.train.trainer import Trainer
from tests.helpers import write_fake_tvsum_mat

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="libavsumio.so not built")

MEDIA = ["visual.backbone=tiny", "visual.dtype=float32", "audio.dtype=float32",
         "visual.max_frames_per_shot=8"]
MODEL = ["model.temporal_encoder=bilstm", "model.hidden_dim=16",
         "model.num_heads=2", "model.scorer_hidden=8", "data.max_shots=4",
         "data.batch_videos=2", "data.n_folds=3"]
VIDEOS = {"v0": dict(n_scenes=5, seed=51), "v1": dict(n_scenes=3, seed=52),
          "v2": dict(n_scenes=4, seed=53), "v3": dict(n_scenes=2, seed=54)}


def _sets(items):
    return [a for s in items for a in ("--set", s)]


def write_summe_gt(path, n_frames, rng, n_users=5):
    """A SumMe-shaped .mat: each user keeps ~15% of the frames in runs."""
    users = np.zeros((n_frames, n_users), np.float32)
    for u in range(n_users):
        for start in rng.choice(n_frames - 10, 3, replace=False):
            users[start:start + max(3, n_frames // 20), u] = 1.0
    scipy.io.savemat(path, {"gt_score": users.mean(1, keepdims=True),
                            "user_score": users, "nFrames": n_frames,
                            "FPS": 30.0})


@pytest.fixture(autouse=True)
def _no_rebuild(monkeypatch):
    # the native decoder the test suite already loaded serves these runs
    monkeypatch.setattr(build, "ensure_native_io", lambda: None)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Four videos, their SumMe and TVSum ground truth, and the feature
    cache that ``preprocess`` writes."""
    root = tmp_path_factory.mktemp("dataset")
    videos, gt = root / "videos", root / "summe_gt"
    videos.mkdir()
    gt.mkdir()
    rng = np.random.default_rng(5)
    n_frames = {}
    for vid, kw in VIDEOS.items():
        scenes = write_scene_video(str(videos / vid), height=48, width=64,
                                   **kw)
        n_frames[vid] = scenes[-1][1]
        write_summe_gt(str(gt / f"{vid}.mat"), n_frames[vid], rng)
    write_fake_tvsum_mat(str(root / "tvsum.mat"), list(VIDEOS),
                         [rng.random(n_frames[v]) for v in VIDEOS])
    mp = pytest.MonkeyPatch()
    mp.setattr(build, "ensure_native_io", lambda: None)
    try:
        assert main(["preprocess", "--device", "cpu", "--input-dir",
                     str(videos), "--cache-dir", str(root / "cache"),
                     "--seed", "4", *_sets(MEDIA)]) == 0
    finally:
        mp.undo()
    return root


def _train_sets(root, dataset_name):
    anno = (root / "summe_gt" if dataset_name == "summe"
            else root / "tvsum.mat")
    return _sets(MEDIA + MODEL + [
        f"data.dataset={dataset_name}", f"data.annotation_path={anno}",
        f"data.cache_dir={root / 'cache'}", "train.epochs=2",
        "train.log_every=1", f"train.checkpoint_dir={root / dataset_name}",
        f"train.log_path={root / dataset_name}.jsonl"])


def test_preprocess_fills_the_cache(dataset):
    cache = FeatureCache(str(dataset / "cache"))
    assert cache.video_ids() == sorted(VIDEOS)
    for vid in VIDEOS:
        ex = cache.get(vid)
        assert ex.visual.shape == (len(ex.shot_boundaries), 4096)
        assert ex.audio.shape == (len(ex.shot_boundaries), 296)
        assert np.isfinite(ex.visual).all() and np.isfinite(ex.audio).all()


def test_splits_equal_the_jax_clis(dataset, tmp_path):
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    sets = ["data.n_folds=3", "data.split_seed=2"]
    assert main(["splits", "--device", "cpu", "--cache-dir",
                 str(dataset / "cache"), "--output", str(ours), "--kfold",
                 *_sets(sets)]) == 0
    assert jax_cmd_splits(argparse.Namespace(
        config=None, overrides=sets, cache_dir=str(dataset / "cache"),
        output=str(theirs), kfold=True)) == 0
    assert load_splits(str(ours)) == load_splits(str(theirs))
    assert len(load_splits(str(ours))) == 3
    assert main(["splits", "--device", "cpu", "--cache-dir",
                 str(tmp_path / "empty"), "--output", str(ours)]) == 1


@pytest.mark.parametrize("dataset_name", ["summe", "tvsum"])
def test_journey_train_then_evaluate(dataset, dataset_name, capsys):
    splits = dataset / f"splits_{dataset_name}.json"
    sets = _train_sets(dataset, dataset_name)
    assert main(["splits", "--device", "cpu", "--kfold", "--output",
                 str(splits), *sets]) == 0
    assert main(["train", "--device", "cpu", "--splits", str(splits),
                 "--fold", "0", *sets]) == 0
    records = [json.loads(x) for x in open(f"{dataset / dataset_name}.jsonl")]
    # two train videos in batches of two: one step an epoch
    assert len(records) == 2 and np.isfinite([r["loss"] for r in records]).all()
    capsys.readouterr()
    assert main(["evaluate", "--device", "cpu", "--splits", str(splits),
                 "--fold", "0", "--canonical", *sets]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"f1", "spearman", "kendall", "canonical_f1",
                        "n_videos"}
    assert out["n_videos"] == len(load_splits(str(splits))[0]["test"]) == 2
    assert 0.0 <= out["f1"] <= 1.0 and 0.0 <= out["canonical_f1"] <= 1.0
    assert -1.0 <= out["spearman"] <= 1.0 and -1.0 <= out["kendall"] <= 1.0
    # without --canonical: the JAX CLI's three keys
    assert main(["evaluate", "--device", "cpu", *sets]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"f1", "spearman", "kendall"}


def test_evaluate_warns_without_a_checkpoint(dataset, capsys, caplog):
    sets = _sets(MEDIA + MODEL + [
        "data.dataset=summe", f"data.annotation_path={dataset / 'summe_gt'}",
        f"data.cache_dir={dataset / 'cache'}",
        f"train.checkpoint_dir={dataset / 'none'}",
        f"train.log_path={dataset / 'none.jsonl'}"])
    assert main(["evaluate", "--device", "cpu", "--canonical", *sets]) == 0
    assert "no checkpoint found" in caplog.text
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_videos"] == len(VIDEOS)


def test_scoring_matches_the_jax_trainer(dataset):
    """Converted weights: ``score_video`` (the power-of-two ladder from
    ``max_shots`` 4) and ``evaluate_videos`` within 1e-5."""
    over = [o for o in MEDIA + MODEL]
    jcfg, cfg = jax_load_config(overrides=over), load_config(overrides=over)
    examples = [FeatureCache(str(dataset / "cache")).get(v) for v in VIDEOS]
    for ex in examples:  # targets from a seed, as a loader would attach
        ex.targets = np.random.default_rng(len(ex.visual)).random(
            len(ex.visual)).astype(np.float32)
    assert max(ex.n_shots for ex in examples) > 4  # the ladder climbs
    with jax.default_matmul_precision("highest"):
        jax_trainer = JaxTrainer(jax_make_model(jcfg.model), jcfg)
        jax_trainer.init_state(jax_pad_batch(examples[:2], 4))
        want_scores = [jax_trainer.score_video(ex, 4) for ex in examples]
        want = jax_trainer.evaluate_videos(jax_batch_iterator(
            examples, 2, 4, shuffle=False))
    model = make_model(cfg.model, state_dict=scorer_from_flax(
        jax_trainer.state.params))
    trainer = Trainer(model, cfg, device="cpu")
    trainer.init_state()
    for ex, w in zip(examples, want_scores):
        got = trainer.score_video(ex, 4)
        assert got.shape == (ex.n_shots,)
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)
    got = trainer.evaluate_videos(batch_iterator(examples, 2, 4,
                                                 shuffle=False))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5)


def test_score_video_climbs_to_the_kernel_for_533_shots(dataset, monkeypatch):
    """A 533-shot video at ``max_shots`` 128 pads to 1024, so the fusion
    attention takes the flash route (K2 on the card)."""
    from avsum_tpu.data.synthetic import make_synthetic_videos
    from avsum_torch.models import attention

    cfg = load_config(overrides=MODEL)
    trainer = Trainer(make_model(cfg.model), cfg, device="cpu")
    trainer.init_state()
    seen = []
    real = attention.flash_attention

    def spy(q, k, v, mask):
        seen.append(tuple(q.shape))
        return real(q, k, v, mask)

    monkeypatch.setattr(attention, "flash_attention", spy)
    ex = make_synthetic_videos(1, min_shots=533, max_shots=533,
                               visual_dim=4096, audio_dim=296, seed=3)[0]
    scores = trainer.score_video(ex, 128)
    assert scores.shape == (533,) and np.isfinite(scores).all()
    assert seen and all(s[:2] == (1, 1024) for s in seen)


def test_summarize_dir_and_render(dataset, tmp_path, capsys):
    videos = dataset / "videos"
    sets = ["--device", "cpu", "--random-init", "--seed", "2",
            *_sets(MEDIA + MODEL)]
    out_dir = tmp_path / "summaries"
    assert main(["summarize", str(videos), "--output", str(out_dir),
                 *sets]) == 0
    assert sorted(os.listdir(out_dir)) == [f"{v}.json" for v in sorted(VIDEOS)]
    for v in VIDEOS:
        got = json.load(open(out_dir / f"{v}.json"))
        assert got["video_id"] == v and got["segments"]

    capsys.readouterr()
    video = str(videos / "v0.y4m")
    stem = str(tmp_path / "rendered")
    assert main(["summarize", video, "--render", stem, *sets]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_render_summary(video, summary["segments"], str(tmp_path / "jax"))
    frames = {}
    for name in ("rendered", "jax"):
        with Y4MReader(str(tmp_path / f"{name}.y4m")) as reader:
            frames[name] = reader.read_frames(range(reader.n_frames))
    n = sum(b - a for a, b in summary["segments"])
    assert frames["rendered"].shape[0] == n > 0
    np.testing.assert_array_equal(frames["rendered"], frames["jax"])
    np.testing.assert_array_equal(read_wav(str(tmp_path / "rendered.wav"))[0],
                                  read_wav(str(tmp_path / "jax.wav"))[0])

    assert main(["summarize", video, "--render", stem + ".mp4", *sets]) == 0
    assert os.path.getsize(stem + ".mp4") > 0


def test_summarize_dir_without_a_video_fails(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "notes.txt").write_text("no video")
    assert main(["summarize", str(empty), "--device", "cpu", "--output",
                 str(tmp_path / "out"), *_sets(MEDIA)]) == 1
