"""The port's own spans on the CPU, without the JAX package: the train
step's ``avsum.place_batch``, ``avsum.forward``, ``avsum.backward`` and
``avsum.optimizer``, once each a step, in that order, on the caller's
thread, with the step's numbers those of a step run without a profiler;
the fast path's ``avsum.frame_read``, ``avsum.frame_upload``,
``avsum.embed_enqueue``, ``avsum.detect_join``, ``avsum.audio_embed``,
``avsum.scorer_launch`` and ``avsum.device_wait``, each inside the stage
that holds it, and the stage clocks' ``avsum.<stage>``; the stage seconds
keep their keys."""

import copy

import numpy as np
import pytest
import torch

from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.audio.vggish import VGGish
from avsum_torch.io.native import native_available
from avsum_torch.io.synthetic import write_scene_video
from avsum_torch.models.scorer import make_model
from avsum_torch.parallel.mesh import build_mesh, mesh_config
from avsum_torch.pipeline import AVPipeline
from avsum_torch.train import steps
from avsum_torch.train.config import (
    MeshShape,
    ModelConfig,
    TrainConfig,
    load_config,
)
from avsum_torch.utils.profiling import collect_stages
from avsum_torch.utils.transfer import HostCopy
from avsum_torch.vision import backbone as tbb

SLICE = ["visual.backbone=tiny", "visual.dtype=float32", "audio.dtype=float32",
         "model.hidden_dim=64", "visual.batch_size=16"]
STEP_SPANS = ["avsum.place_batch", "avsum.forward", "avsum.backward",
              "avsum.optimizer"]
CALLER = "test.caller"
needs_native = pytest.mark.skipif(not native_available(),
                                  reason="libavsumio.so not built")


def _spans(prof, prefix="avsum.") -> list:
    """[(name, start ns, end ns, thread)] of the profile's spans whose
    name starts with ``prefix``, by start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(prefix)), key=lambda x: x[1])


def _train_setup(encoder: str, ema: float):
    cfg = ModelConfig(visual_dim=16, audio_dim=8, hidden_dim=16, num_heads=2,
                      scorer_hidden=8, dropout=0.3, temporal_encoder=encoder)
    model = make_model(cfg, seed=0)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(2):
        mask = np.ones((2, 12), np.float32)
        mask[1, 7:] = 0.0
        batches.append({
            "visual": rng.standard_normal((2, 12, 16)).astype(np.float32),
            "audio": rng.standard_normal((2, 12, 8)).astype(np.float32),
            "targets": rng.random((2, 12)).astype(np.float32),
            "mask": mask})
    train = TrainConfig(lr=1e-3, warmup_steps=0, ema_decay=ema)
    return model, train, batches


def _steps(model, train, batches, ema):
    """Two steps of a fresh state over ``batches`` -> (losses, state)."""
    mesh = build_mesh(mesh_config(MeshShape()), "cpu")
    state = steps.create_train_state(model, train, total_steps=4)
    step = steps.make_train_step(model, mesh, seed=5, ema_decay=ema)
    losses = []
    for b in batches:
        state, metrics = step(state, steps.shard_batch_dict(b, mesh))
        losses.append(metrics["loss"])
    return losses, state


@pytest.mark.parametrize("encoder,ema", [("attention", 0.0),
                                         ("bilstm", 0.99)])
def test_train_step_spans_in_order_on_the_caller_thread(encoder, ema):
    model, train, batches = _train_setup(encoder, ema)
    plain_losses, plain = _steps(copy.deepcopy(model), train, batches, ema)
    with collect_stages() as stages, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(CALLER):
            losses, state = _steps(model, train, batches, ema)
    (caller,) = [t for n, _, _, t in _spans(prof, CALLER)]
    spans = _spans(prof)
    assert [n for n, *_ in spans] == STEP_SPANS * len(batches)
    assert {t for *_, t in spans} == {caller}
    for a, b in zip(spans, spans[1:]):  # one after the other
        assert a[2] <= b[1]
    assert set(stages) == set(STEP_SPANS)
    for got, want in zip(losses, plain_losses):
        assert float(got) == float(want)
    for p, q in zip(state.optimizer.params, plain.optimizer.params):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    if ema:
        for k, v in state.ema.items():
            torch.testing.assert_close(v, plain.ema[k], rtol=0, atol=0)


def test_place_batch_span_holds_the_placement():
    _, _, batches = _train_setup("attention", 0.0)
    mesh = build_mesh(mesh_config(MeshShape()), "cpu")
    with collect_stages() as stages, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        placed = steps.shard_batch_dict(batches[0], mesh)
    assert set(stages) == {"avsum.place_batch"}
    ((_, start, end, _),) = _spans(prof)
    copies = [e for e in prof.profiler.kineto_results.events()
              if e.name() in ("aten::to", "aten::_to_copy")]
    assert all(start <= e.start_ns() <= end for e in copies)
    for k, v in batches[0].items():
        np.testing.assert_array_equal(placed[k].numpy(), v)


def test_dispatch_yuv_opens_an_upload_and_an_embed_a_batch():
    cfg = load_config(overrides=SLICE)
    front = tbb.VisualFrontend(cfg.visual, tbb.make_backbone(cfg.visual),
                               "cpu")
    rng = np.random.default_rng(0)
    f = 40  # three batches of 16, the last a bucket of 8 frames padded
    y = rng.integers(0, 255, (f, 32, 48), dtype=np.uint8)
    u, v = (rng.integers(0, 255, (f, 16, 24), dtype=np.uint8)
            for _ in range(2))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pending, n = front.dispatch_yuv(y, u, v)
    names = [name for name, *_ in _spans(prof)]
    assert n == f and len(pending) == 3
    assert names == ["avsum.frame_upload", "avsum.embed_enqueue"] * 3


def test_host_copy_waits_inside_device_wait():
    class Event:
        waited = 0

        def synchronize(self):
            Event.waited += 1

    copy_ = HostCopy(torch.arange(4.0))
    with collect_stages() as stages:
        assert copy_.numpy().tolist() == [0.0, 1.0, 2.0, 3.0]
    assert stages == {}  # a CPU tensor: nothing to wait for
    copy_._event = Event()
    with collect_stages() as stages:
        copy_.numpy()
    assert Event.waited == 1 and set(stages) == {"avsum.device_wait"}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    stem = str(tmp_path_factory.mktemp("spans") / "v")
    write_scene_video(stem, n_scenes=4, seed=23, height=48, width=64)
    return stem + ".y4m"


def _pipeline(overrides):
    cfg = load_config(overrides=SLICE + list(overrides))
    pipe = AVPipeline(
        cfg, tbb.VisualFrontend(cfg.visual, tbb.make_backbone(cfg.visual),
                                "cpu"),
        AudioFrontend(cfg.audio, VGGish(), "cpu"))
    return pipe, make_model(cfg.model)


# each new span of the fast path and the stage that holds it
INSIDE = {"avsum.frame_read": "avsum.visual_dispatch",
          "avsum.frame_upload": "avsum.visual_dispatch",
          "avsum.embed_enqueue": "avsum.visual_dispatch",
          "avsum.detect_join": "avsum.shot_detect_host",
          "avsum.audio_embed": "avsum.audio_dispatch",
          "avsum.scorer_launch": "avsum.score",
          "avsum.device_wait": "avsum.score",
          "avsum.prep": "avsum.prep", "avsum.pool": "avsum.pool",
          "avsum.score": "avsum.score_select",
          "avsum.select": "avsum.score_select"}


@needs_native
@pytest.mark.parametrize("overrides", [
    [], ["visual.ship_size=32"], ["visual.dedup_threshold=1.0"]],
    ids=["planes", "packed", "dedup"])
def test_fast_summarize_opens_each_new_span(clip, overrides):
    pipe, model = _pipeline(overrides)
    with collect_stages() as stages, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = pipe.summarize(clip, model)
    assert len(out["boundaries"]) >= 2
    assert set(INSIDE) | {"avsum.audio_load"} <= set(stages)
    by_name = {}
    for name, start, end, thread in _spans(prof):
        by_name.setdefault(name, []).append((start, end, thread))
    ((_, _, caller),) = by_name["avsum.visual_dispatch"]
    for name, outer in INSIDE.items():
        ((o_start, o_end, o_thread),) = by_name[outer]
        assert o_thread == caller
        for start, end, thread in by_name[name]:
            assert o_start <= start <= end <= o_end, (name, outer)
            assert thread == caller
    stride = max(1, round(out["fps"] / pipe.config.visual.sample_fps))
    sampled = len(range(0, out["n_frames"], stride))
    assert len(by_name["avsum.frame_read"]) == -(-sampled // 16)


@needs_native
@pytest.mark.parametrize("path,keys", [
    ("fast", {"visual_dispatch", "shot_detect", "audio_load", "prep", "pool",
              "score", "select", "finish"}),
    ("classic", {"shot_detect", "visual_features", "audio_features", "score",
                 "select"})])
def test_stage_seconds_keep_their_keys_and_each_is_a_span(clip, path, keys):
    pipe, model = _pipeline(["visual.sample_fps=0"] if path == "classic"
                            else [])
    with collect_stages() as stages:
        pipe.summarize(clip, model)
    assert set(pipe.stage_seconds) == keys
    named = {"shot_detect": ("avsum.detect_thread" if path == "fast"
                             else "avsum.shot_detect")}
    for key in keys - {"finish"}:
        assert named.get(key, f"avsum.{key}") in stages, key
