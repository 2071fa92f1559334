"""The port's training path (``avsum_torch.train``) against the JAX package
on the CPU: masked MSE, the learning-rate schedule and the optimizer
chain against optax, and three train steps from the same init on the
same batches against ``avsum_tpu.train.steps`` for both temporal
encoders (dropout 0; the attention encoder at a padded S >= 512, so the
port runs the differentiable attention's plain route). float32, JAX at
"highest" precision. Tolerances: 1e-5 on the loss, the parameters and
the trained models' outputs (the pattern of
docs/pp_param_equality_r05.log, max |d| 3e-6), 1e-4 relative on the
gradient norm, 1e-6 relative on the schedule, 1e-6 on the optimizer's
parameters.

Also: EMA on and off, the loss falling on synthetic videos, scoring past
the bucket, checkpoints and ``--resume``, dropout in train mode, the
mesh and precision settings, and ``summarize --checkpoint``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avsum_tpu.data.synthetic import make_synthetic_videos
from avsum_tpu.models import make_model as jax_make_model
from avsum_tpu.train import steps as jax_steps
from avsum_tpu.train.config import ModelConfig as JaxModelConfig
from avsum_tpu.train.config import TrainConfig as JaxTrainConfig
from avsum_torch.convert import scorer_from_flax
from avsum_torch.data.batching import batch_iterator, pad_batch
from avsum_torch.data.cache import FeatureCache
from avsum_torch.io.native import native_available
from avsum_torch.io.synthetic import write_scene_video
from avsum_torch.models.scorer import make_model
from avsum_torch.train import steps
from avsum_torch.train.checkpoint import CheckpointManager
from avsum_torch.train.config import (
    MeshShape,
    ModelConfig,
    TrainConfig,
    load_config,
)
from avsum_torch.train.trainer import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _restore_precision():
    """Trainer applies train.matmul_precision process-wide."""
    before = (torch.get_float32_matmul_precision(),
              torch.backends.cudnn.allow_tf32)
    yield
    torch.set_float32_matmul_precision(before[0])
    torch.backends.cudnn.allow_tf32 = before[1]


def test_masked_mse_matches_jax():
    rng = np.random.default_rng(0)
    pred, target = rng.random((2, 2, 9)).astype(np.float32)
    mask = np.ones((2, 9), np.float32)
    mask[1, 4:] = 0.0
    want = float(jax_steps.masked_mse(pred, target, mask))
    got = steps.masked_mse(*(torch.from_numpy(a) for a in (pred, target,
                                                           mask)))
    assert float(got) == pytest.approx(want, rel=1e-6)
    empty = steps.masked_mse(torch.ones(3), torch.zeros(3), torch.zeros(3))
    assert float(empty) == 0.0


@pytest.mark.parametrize("warmup,total", [(5, 40), (0, 12), (10, 6)])
def test_schedule_matches_optax(warmup, total):
    """Against the schedule ``avsum_tpu.train.steps.make_optimizer``
    builds, at every count of a short run and past its end."""
    cfg = TrainConfig(lr=3e-4, warmup_steps=warmup)
    want = optax.warmup_cosine_decay_schedule(
        0.0, cfg.lr, warmup, max(total, warmup + 1), cfg.lr * 0.1)
    ours = steps.lr_schedule(cfg, total)
    for count in range(total + 5):
        assert ours(count) == pytest.approx(float(want(count)), rel=1e-6,
                                            abs=1e-12)


def test_optimizer_matches_optax():
    """Four updates of a hand-made parameter tree, the third with a
    gradient whose global norm is above grad_clip."""
    fields = dict(lr=1e-2, warmup_steps=1, grad_clip=1.0, weight_decay=1e-2)
    cfg = TrainConfig(**fields)
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    scales = [0.05, 0.1, 5.0, 0.1]
    grads = [{k: s * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for s in scales]
    tx = jax_steps.make_optimizer(JaxTrainConfig(**fields), total_steps=10)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("w", "b")]
    opt = steps.AdamW(tp, cfg, total_steps=10)
    clipped = 0
    for g in grads:
        norm = float(optax.global_norm(g))
        clipped += norm >= cfg.grad_clip
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        got_norm = opt.step([torch.from_numpy(g[k]) for k in ("w", "b")])
        assert float(got_norm) == pytest.approx(norm, rel=1e-6)
        for k, t in zip(("w", "b"), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
    assert clipped == 1 and opt.count == 4


def _parity_batches(s, n_batches=3, b=2):
    rng = np.random.default_rng(s)
    out = []
    for i in range(n_batches):
        mask = np.ones((b, s), np.float32)
        mask[0, s - 7 - i:] = 0.0  # padded tails
        mask[1, s // 2:] = 0.0
        out.append({
            "visual": rng.standard_normal((b, s, 48)).astype(np.float32),
            "audio": rng.standard_normal((b, s, 24)).astype(np.float32),
            "targets": rng.random((b, s)).astype(np.float32) * mask,
            "mask": mask,
        })
    return out


def _without_key_bias(name, value):
    """The key third of an attention's qkv bias has a zero gradient in
    exact arithmetic (a softmax does not see a shift shared by all
    keys), so Adam turns each side's rounding noise there into steps of
    up to the learning rate; those entries are held by the outputs
    instead, which they cannot move."""
    if name.endswith("qkv.bias"):
        q, _, v = value.view(3, -1)
        return torch.cat([q, v])
    return value


@pytest.mark.parametrize("encoder,s", [("attention", 520), ("bilstm", 40)])
def test_train_steps_match_jax(encoder, s):
    model_fields = dict(visual_dim=48, audio_dim=24, hidden_dim=32,
                        num_heads=2, scorer_hidden=16, dropout=0.0,
                        temporal_encoder=encoder)
    train_fields = dict(lr=3e-3, warmup_steps=2, seed=3)
    mcfg, tcfg = ModelConfig(**model_fields), TrainConfig(**train_fields)
    batches = _parity_batches(s)
    jm = jax_make_model(JaxModelConfig(**model_fields))
    with jax.default_matmul_precision("highest"):
        state = jax_steps.create_train_state(jm, JaxTrainConfig(**train_fields),
                                             batches[0], total_steps=20)
        init = scorer_from_flax(jax.device_get(state.params))
        model = make_model(mcfg, state_dict=init)
        jstep = jax_steps.make_train_step(jm, mesh=None, seed=tcfg.seed)
        ours = steps.create_train_state(model, tcfg, total_steps=20)
        tstep = steps.make_train_step(model, seed=tcfg.seed)
        for batch in batches:
            state, jmetrics = jstep(state, batch)
            ours, metrics = tstep(ours, steps.batch_to_device(batch, "cpu"))
            assert float(metrics["loss"]) == pytest.approx(
                float(jmetrics["loss"]), rel=1e-5, abs=1e-5)
            assert float(metrics["grad_norm"]) == pytest.approx(
                float(jmetrics["grad_norm"]), rel=1e-4)
        want = scorer_from_flax(jax.device_get(state.params))
        probe = batches[0]
        ref_out = np.asarray(jm.apply({"params": state.params},
                                      probe["visual"], probe["audio"],
                                      probe["mask"]))
    got = model.state_dict()
    assert set(got) == set(want) and ours.step == 3
    for name, value in got.items():
        np.testing.assert_allclose(_without_key_bias(name, value).numpy(),
                                   _without_key_bias(name, want[name]).numpy(),
                                   err_msg=name, **TOL)
    model.eval()
    with torch.no_grad():
        out = model(*(torch.from_numpy(probe[k])
                      for k in ("visual", "audio", "mask")))
    np.testing.assert_allclose(out.numpy(), ref_out, **TOL)
    moved = max(float((got[k] - init[k]).abs().max()) for k in got)
    assert moved > 1e-3  # three steps did move the parameters


def _tiny_config(tmp_path, *extra):
    return load_config(overrides=[
        "model.visual_dim=16", "model.audio_dim=8", "model.hidden_dim=16",
        "model.num_heads=2", "model.scorer_hidden=8", "model.dropout=0.1",
        "data.max_shots=24", "data.batch_videos=4", "train.lr=3e-3",
        "train.warmup_steps=5", "train.eval_every_epochs=100",
        f"train.checkpoint_dir={tmp_path}/ckpt", *extra])


def _videos(n=8, seed=0):
    return make_synthetic_videos(n, min_shots=8, max_shots=20, visual_dim=16,
                                 audio_dim=8, seed=seed)


def test_loss_decreases_on_synthetic_data(tmp_path):
    cfg = _tiny_config(tmp_path, "train.epochs=10")
    vids = _videos()
    trainer = Trainer(make_model(cfg.model), cfg, total_steps=200)
    trainer.init_state()
    losses = []
    for epoch in range(10):
        for batch in batch_iterator(vids, 4, 24, seed=epoch):
            _, metrics = trainer.train_step(
                trainer.state, steps.batch_to_device(batch, "cpu"))
            losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


def test_ema_weight_averaging(tmp_path):
    """train.ema_decay keeps an average used for eval; 0 keeps none."""
    vids = _videos(4)

    def batches(epoch):
        return batch_iterator(vids, 2, 24, seed=epoch)

    off = Trainer(make_model(_tiny_config(tmp_path).model),
                  _tiny_config(tmp_path / "off", "train.epochs=2"))
    off.fit(batches)
    assert off.state.ema is None
    assert off.eval_params == dict(off.model.named_parameters())

    on = Trainer(make_model(_tiny_config(tmp_path).model),
                 _tiny_config(tmp_path / "on", "train.epochs=2",
                              "train.ema_decay=0.9"))
    on.fit(batches)
    assert on.eval_params is on.state.ema
    raw = dict(on.model.named_parameters())
    gaps = [float((on.state.ema[k] - raw[k].detach()).abs().max())
            for k in raw]
    assert max(gaps) > 0  # the average lags the trained weights
    batch = steps.batch_to_device(pad_batch(vids[:1], 24), "cpu")
    ema_preds = on.eval_step(on.eval_params, batch)["preds"]
    raw_preds = on.eval_step(raw, batch)["preds"]
    assert not torch.equal(ema_preds, raw_preds)


def test_score_video_past_the_bucket(tmp_path):
    cfg = _tiny_config(tmp_path)
    trainer = Trainer(make_model(cfg.model), cfg)
    trainer.init_state()
    long = make_synthetic_videos(1, min_shots=70, max_shots=70, visual_dim=16,
                                 audio_dim=8, seed=2)[0]
    scores = trainer.score_video(long, base_bucket=24)
    assert scores.shape == (70,) and np.isfinite(scores).all()
    full = trainer.eval_step(trainer.eval_params, steps.batch_to_device(
        pad_batch([long], 96), "cpu"))["preds"].numpy()[0, :70]
    np.testing.assert_allclose(scores, full, rtol=1e-6, atol=1e-6)


def test_checkpoint_round_trip_and_resume(tmp_path):
    """A run of 2 epochs, then a fresh trainer that restores the latest
    checkpoint, continues at the saved epoch and ends where an
    uninterrupted 4-epoch run does."""
    vids = _videos()

    def batches(epoch):
        return batch_iterator(vids, 4, 24, seed=1 + epoch)

    cfg = _tiny_config(tmp_path / "a", "train.epochs=2",
                       "train.keep_checkpoints=1")
    first = Trainer(make_model(cfg.model, seed=1), cfg, total_steps=8)
    first.fit(batches)
    ckpt = CheckpointManager(cfg.train.checkpoint_dir)
    assert ckpt.steps() == [4] and first.state.step == 4

    cfg4 = _tiny_config(tmp_path / "a", "train.epochs=4")
    resumed = Trainer(make_model(cfg4.model, seed=9), cfg4, total_steps=8)
    resumed.init_state()
    assert resumed.maybe_restore() == 4
    assert resumed.last_meta == {"epoch": 1}
    for k, v in first.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v,
                                   rtol=0, atol=0)
    resumed.fit(batches, start_epoch=resumed.last_meta["epoch"] + 1)

    straight_cfg = _tiny_config(tmp_path / "b", "train.epochs=4")
    straight = Trainer(make_model(straight_cfg.model, seed=1), straight_cfg,
                       total_steps=8)
    straight.fit(batches)
    assert resumed.state.step == straight.state.step == 8
    for k, v in straight.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v,
                                   rtol=1e-6, atol=1e-6)


def test_dropout_active_in_train_mode_and_reproducible():
    cfg = ModelConfig(visual_dim=16, audio_dim=8, hidden_dim=16, num_heads=2,
                      scorer_hidden=8, dropout=0.3,
                      temporal_encoder="attention", remat=True)
    model = make_model(cfg, seed=0)
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal((2, 12, d)).astype(
        np.float32)) for d in (16, 8)] + [torch.ones(2, 12)]

    def run(seed, step):
        out = model(*args, generator=steps.dropout_generator(seed, step))
        grads = torch.autograd.grad(out.sum(), list(model.parameters()))
        return out.detach(), grads

    model.train()
    a, ga = run(0, 5)
    b, gb = run(0, 5)
    c, _ = run(0, 6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for x, y in zip(ga, gb):  # remat redraws the same masks
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a, c)
    model.eval()
    with torch.no_grad():
        e1 = model(*args, generator=steps.dropout_generator(0, 5))
        e2 = model(*args)
    torch.testing.assert_close(e1, e2, rtol=0, atol=0)
    assert not torch.equal(e1, a)


def test_multi_device_mesh_and_precision_settings():
    with pytest.raises(ValueError, match="A10"):
        steps.check_single_device(MeshShape(seq=4, auto_data=False))
    with pytest.raises(ValueError, match="A10"):
        steps.check_single_device(MeshShape(data=2, auto_data=False))
    steps.check_single_device(MeshShape(data=2, auto_data=True))
    steps.apply_matmul_precision("highest")
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cudnn.allow_tf32 is False
    steps.apply_matmul_precision("tensorfloat32")
    assert torch.get_float32_matmul_precision() == "high"
    assert torch.backends.cudnn.allow_tf32 is True
    with pytest.raises(ValueError, match="matmul_precision"):
        steps.apply_matmul_precision("fastest")


def _write_cache(cache_dir, n, dims=(16, 8), seed=1):
    cache = FeatureCache(cache_dir)
    for ex in make_synthetic_videos(n, min_shots=10, max_shots=20,
                                    visual_dim=dims[0], audio_dim=dims[1],
                                    seed=seed):
        cache.put(ex.video_id, ex.visual, ex.audio, ex.shot_boundaries,
                  ex.fps, ex.n_frames)


def _cli_sets(tmp_path, epochs, dims=(16, 8)):
    sets = ["data.dataset=synthetic", f"data.cache_dir={tmp_path}/cache",
            "data.max_shots=24", "data.batch_videos=2",
            f"model.visual_dim={dims[0]}", f"model.audio_dim={dims[1]}",
            "model.hidden_dim=16", "model.num_heads=2",
            "model.scorer_hidden=8", f"train.epochs={epochs}",
            "train.log_every=1", f"train.checkpoint_dir={tmp_path}/ckpt",
            f"train.log_path={tmp_path}/log.jsonl"]
    return [a for s in sets for a in ("--set", s)]


def test_cli_train_resumes_at_the_saved_epoch(tmp_path):
    from avsum_torch.cli.main import main

    _write_cache(f"{tmp_path}/cache", 4)
    assert main(["train", "--device", "cpu", *_cli_sets(tmp_path, 2)]) == 0
    assert CheckpointManager(f"{tmp_path}/ckpt").steps() == [2, 4]
    assert main(["train", "--device", "cpu", "--resume",
                 *_cli_sets(tmp_path, 3)]) == 0
    records = [json.loads(line) for line in open(f"{tmp_path}/log.jsonl")]
    assert [(r["step"], r["epoch"]) for r in records] == [
        (1, 0), (2, 0), (3, 1), (4, 1), (5, 2), (6, 2)]
    assert all(np.isfinite(r["loss"]) for r in records)


@pytest.mark.skipif(not native_available(), reason="libavsumio.so not built")
def test_summarize_from_a_trained_checkpoint(tmp_path, monkeypatch, capsys):
    from avsum_torch import build
    from avsum_torch.cli.main import main

    monkeypatch.setattr(build, "ensure_native_io", lambda: None)
    sets = ["--set", "visual.backbone=tiny", "--set", "visual.dtype=float32",
            "--set", "audio.dtype=float32", "--set",
            "model.temporal_encoder=bilstm"]
    train = _cli_sets(tmp_path, 1, dims=(4096, 296))
    _write_cache(f"{tmp_path}/cache", 2, dims=(4096, 296))
    assert main(["train", "--device", "cpu", *train, *sets]) == 0
    stem = str(tmp_path / "v")
    write_scene_video(stem, n_scenes=3, seed=8, height=72, width=96)
    capsys.readouterr()
    dims = train[train.index("model.hidden_dim=16") - 1:]
    assert main(["summarize", stem + ".y4m", "--device", "cpu",
                 "--checkpoint", f"{tmp_path}/ckpt", *sets, *dims]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    scores = np.asarray(out["shot_scores"])
    assert len(scores) >= 2 and ((scores >= 0) & (scores <= 1)).all()
    assert not np.allclose(scores, 1.0)  # a scorer ran
    payload, _ = CheckpointManager(f"{tmp_path}/ckpt").load()
    assert payload["model"]["visual_fc.dense.weight"].shape == (16, 4096)
    assert main(["summarize", stem + ".y4m", "--device", "cpu",
                 "--checkpoint", os.fspath(tmp_path / "none"), *sets]) == 1


def test_evaluate_videos_averages_per_video_metrics(tmp_path):
    from avsum_torch.summary.metrics import evaluate_scores

    cfg = _tiny_config(tmp_path)
    trainer = Trainer(make_model(cfg.model, seed=2), cfg)
    trainer.init_state()
    vids = _videos(5, seed=4)
    vids[0].visual = vids[0].visual[:1]  # one valid shot: left out
    vids[0].audio, vids[0].targets = vids[0].audio[:1], vids[0].targets[:1]
    got = trainer.evaluate_videos(batch_iterator(vids, 2, 24, shuffle=False))
    per_video = [evaluate_scores(trainer.score_video(v, 24), v.targets)
                 for v in vids[1:]]
    for key in ("f1", "spearman", "kendall"):
        assert got[key] == pytest.approx(
            np.mean([m[key] for m in per_video]), abs=1e-6)


def test_cli_train_with_splits_evaluates_the_test_videos(tmp_path):
    from avsum_torch.cli.main import main
    from avsum_torch.data.splits import create_split, save_splits

    _write_cache(f"{tmp_path}/cache", 5)
    ids = FeatureCache(f"{tmp_path}/cache").video_ids()
    save_splits(create_split(ids, seed=0), f"{tmp_path}/splits.json")
    assert main(["train", "--device", "cpu", "--splits",
                 f"{tmp_path}/splits.json", *_cli_sets(tmp_path, 2),
                 "--set", "train.eval_every_epochs=1"]) == 0
    records = [json.loads(line) for line in open(f"{tmp_path}/log.jsonl")]
    evals = [r for r in records if "kendall" in r]
    assert len(evals) == 2 and [r["epoch"] for r in evals] == [0, 1]
    assert len([r for r in records if "loss" in r]) == 2 * (4 // 2)
