"""Tracing (``avsum_torch/utils/profiling.py``) against the JAX package's
``avsum_tpu/utils/profiling.py``: ``tests/test_utils.py``'s cases
(``annotate`` under ``collect_stages``, the JSONL logger, ``trace_to``),
and a summarize of one tiny synthetic video in both packages at the same
narrow config on the CPU, through the fast path (the native reader) and
the classic path (``visual.sample_fps=0``): ``collect_stages`` sees every
span name of the JAX package's in the port's, and beside them exactly the
port's own spans of that path; ``trace_to`` writes a Chrome trace holding
every one of them, the detect and wav threads' too. The stage seconds
keep their keys."""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsum_tpu.models import make_model as jax_make_model
from avsum_tpu.pipeline import AVPipeline as JaxPipeline
from avsum_tpu.train.config import load_config as jax_load_config
from avsum_tpu.utils.profiling import collect_stages as jax_collect_stages
from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.audio.vggish import VGGish
from avsum_torch.convert import (
    scorer_from_flax,
    tiny_backbone_from_flax,
    vggish_from_flax,
)
from avsum_torch.io.native import native_available
from avsum_torch.io.synthetic import write_scene_video
from avsum_torch.models.scorer import make_model
from avsum_torch.pipeline import AVPipeline
from avsum_torch.train.config import load_config
from avsum_torch.utils import JsonlLogger, annotate
from avsum_torch.utils.profiling import collect_stages, trace_to
from avsum_torch.vision import backbone as tbb

SLICE = ["visual.backbone=tiny", "visual.dtype=float32", "audio.dtype=float32",
         "model.hidden_dim=64", "visual.batch_size=16"]
FAST_SPANS = {"avsum.detect_thread", "avsum.visual_dispatch",
              "avsum.audio_dispatch", "avsum.shot_detect_host",
              "avsum.visual_pool", "avsum.audio_pool", "avsum.score_select"}
CLASSIC_SPANS = {"avsum.shot_detect", "avsum.visual_features",
                 "avsum.audio_features", "avsum.score_select"}
# the port's own spans, which the JAX package does not open: the dispatch
# loop's parts, the waits, the scorer's launches and the stage clocks
# that had no span
FAST_NEW = {"avsum.frame_read", "avsum.frame_upload", "avsum.embed_enqueue",
            "avsum.detect_join", "avsum.audio_embed", "avsum.scorer_launch",
            "avsum.device_wait", "avsum.audio_load", "avsum.prep",
            "avsum.pool", "avsum.score", "avsum.select"}
CLASSIC_NEW = {"avsum.frame_upload", "avsum.embed_enqueue",
               "avsum.scorer_launch", "avsum.score", "avsum.select"}


def test_annotate_and_timed_passthrough():
    """Nested spans each add their own seconds to every open collector,
    and a span passes its block's result and exceptions through."""
    with collect_stages() as outer:
        with annotate("region"):
            with collect_stages() as inner, annotate("inner"):
                x = 1 + 1
        with pytest.raises(KeyError), annotate("inner"):
            raise KeyError("raised inside a span")
    assert x == 2
    assert set(outer) == {"region", "inner"} and set(inner) == {"inner"}
    assert outer["region"] >= inner["inner"] >= 0
    assert outer["inner"] >= inner["inner"]


def test_jsonl_logger_writes_records(tmp_path):
    path = str(tmp_path / "log.jsonl")
    with JsonlLogger(path) as logger:
        logger.log(1, loss=0.5, tag="a")
        logger.log(2, loss=np.float32(0.25))
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["step"] == 1 and lines[0]["loss"] == 0.5
    assert lines[0]["tag"] == "a"
    assert lines[1]["loss"] == 0.25
    assert "time" in lines[1]


def test_jsonl_logger_no_path_is_noop():
    logger = JsonlLogger(None)
    rec = logger.log(0, loss=1.0)
    assert rec["loss"] == 1.0
    logger.close()


def _trace_names(log_dir) -> set:
    (path,) = glob.glob(f"{log_dir}/*.trace.json")
    with open(path) as fh:
        return {e.get("name") for e in json.load(fh)["traceEvents"]}


def test_trace_to_produces_files(tmp_path):
    with trace_to(str(tmp_path)):
        with annotate("region"):
            torch.sum(torch.ones(64))
    assert "region" in _trace_names(tmp_path)


def _both(overrides=()):
    """-> (JAX pipeline, Flax scorer, params, port pipeline, port scorer)
    with the same weights."""
    jcfg = jax_load_config(overrides=SLICE + list(overrides))
    jax_pipe = JaxPipeline(jcfg)
    jmodel = jax_make_model(jcfg.model)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 4096)),
                         jnp.zeros((1, 8, 296)), jnp.ones((1, 8)))["params"]
    cfg = load_config(overrides=SLICE + list(overrides))
    vggish = VGGish()
    vggish.load_state_dict(vggish_from_flax(jax_pipe.audio.vggish_params))
    pipe = AVPipeline(
        cfg, tbb.VisualFrontend(cfg.visual, tbb.make_backbone(
            cfg.visual, state_dict=tiny_backbone_from_flax(
                jax_pipe.visual.variables)), "cpu"),
        AudioFrontend(cfg.audio, vggish, "cpu"))
    model = make_model(cfg.model, state_dict=scorer_from_flax(params))
    return jax_pipe, jmodel, params, pipe, model


@pytest.mark.parametrize("path,spans,new", [
    ("fast", FAST_SPANS, FAST_NEW), ("classic", CLASSIC_SPANS, CLASSIC_NEW)])
def test_summarize_spans_equal_jax(tmp_path, path, spans, new):
    if not native_available():
        pytest.skip("libavsumio.so not built")
    overrides = ["visual.sample_fps=0"] if path == "classic" else []
    jax_pipe, jmodel, params, pipe, model = _both(overrides)
    stem = str(tmp_path / "v")
    write_scene_video(stem, n_scenes=4, seed=23, height=48, width=64)
    with jax.default_matmul_precision("highest"), jax_collect_stages() as want:
        jax_pipe.summarize(stem + ".y4m", jmodel, params)
    with collect_stages() as got, trace_to(str(tmp_path / "trace")):
        out = pipe.summarize(stem + ".y4m", model)
    assert set(want) == spans
    assert set(want) <= set(got)
    assert set(got) == set(want) | new
    assert all(v >= 0 for v in got.values())
    assert set(got) <= _trace_names(tmp_path / "trace")
    assert np.all((out["scores"] >= 0) & (out["scores"] <= 1))
    keys = ({"visual_dispatch", "shot_detect", "audio_load", "prep", "pool",
             "score", "select", "finish"} if path == "fast" else
            {"shot_detect", "visual_features", "audio_features", "score",
             "select"})
    assert set(pipe.stage_seconds) == keys
