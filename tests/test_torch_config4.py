"""BASELINE config 4, the upgraded encoders, on the port against the JAX
package: the whole scorer for every temporal encoder (bilstm, attention,
the staged attention encoder at pp_stages 4, tcn, moe) with self and
cross fusion, and with chunk_size 512; the ResNet50-only backbone;
``AVPipeline.summarize`` with ViT s16 + the large audio encoder + cross
fusion + the MoE encoder on a small synthetic video against
``avsum_tpu``'s pipeline (all weights from JAX through
``avsum_torch.convert``); and ``train`` through the CLI with
``configs/moe_ep.yaml`` and ``configs/deep_pp.yaml`` at small widths,
at ``--set mesh.data=1 --set mesh.model=1`` (their 2 x 4 meshes need
eight processes, and in one they raise, naming ``torchrun``). float32, JAX at "highest" precision: scores 1e-5,
backbone features and the pipeline 1e-4 (ResNet50 and 12 ViT blocks
deep)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsum_tpu.models import make_model as jax_make_model
from avsum_tpu.pipeline import AVPipeline as JaxPipeline
from avsum_tpu.train.config import ModelConfig as JaxModelConfig
from avsum_tpu.train.config import load_config as jax_load_config
from avsum_tpu.vision.backbone import make_visual_frontend
from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.audio.vggish import make_audio_encoder
from avsum_torch.cli.main import main
from avsum_torch.convert import (
    backbone_from_flax,
    scorer_from_flax,
    vggish_from_flax,
)
from avsum_torch.data.cache import FeatureCache
from avsum_torch.io.native import native_available
from avsum_torch.io.synthetic import write_scene_video
from avsum_torch.models.scorer import make_model
from avsum_torch.pipeline import AVPipeline
from avsum_torch.train.config import ModelConfig, load_config
from avsum_torch.vision.backbone import VisualFrontend, make_backbone

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)

ENCODERS = {"bilstm": dict(temporal_encoder="bilstm"),
            "attention": dict(temporal_encoder="attention"),
            "staged": dict(temporal_encoder="attention", temporal_layers=4,
                           pp_stages=4),
            "tcn": dict(temporal_encoder="tcn"),
            "moe": dict(temporal_encoder="moe", moe_experts=4, moe_topk=2)}


def _scorer_case(fields, s=40, seed=0):
    """-> (JAX scores, the port's scores) with the JAX init's weights."""
    fields = dict(visual_dim=48, audio_dim=24, hidden_dim=32, num_heads=4,
                  scorer_hidden=16, **fields)
    rng = np.random.default_rng(seed)
    visual = rng.standard_normal((2, s, 48)).astype(np.float32)
    audio = rng.standard_normal((2, s, 24)).astype(np.float32)
    mask = np.ones((2, s), np.float32)
    mask[1, s - 9:] = 0.0
    jm = jax_make_model(JaxModelConfig(**fields))
    with jax.default_matmul_precision("highest"):
        params = jax.jit(jm.init)(jax.random.PRNGKey(seed), visual[:, :8],
                                  audio[:, :8], mask[:, :8])["params"]
        ref = np.asarray(jax.jit(jm.apply)({"params": params}, visual,
                                           audio, mask))
    model = make_model(ModelConfig(**fields),
                       state_dict=scorer_from_flax(jax.device_get(params)))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in (visual, audio, mask)))
    assert not got.numpy()[mask == 0].any()
    return ref, got.numpy()


@pytest.mark.parametrize("fusion", ["self", "cross"])
@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_scorer_matches_jax(encoder, fusion):
    ref, got = _scorer_case({**ENCODERS[encoder], "fusion": fusion})
    np.testing.assert_allclose(got, ref, **SCORE_TOL)


@pytest.mark.parametrize("encoder", ["attention", "moe"])
def test_scorer_with_chunked_fusion_matches_jax(encoder):
    """chunk_size 512 > S pads the one query chunk; with the kernel off
    the fusion attention takes the chunked path."""
    ref, got = _scorer_case({**ENCODERS[encoder], "chunk_size": 512,
                             "use_pallas": False}, s=40, seed=1)
    np.testing.assert_allclose(got, ref, **SCORE_TOL)


def test_resnet50_backbone_matches_jax():
    jcfg = jax_load_config(overrides=["visual.backbone=resnet50",
                                      "visual.dtype=float32"])
    assert jcfg.visual.feature_dim == 2048
    jax_front = make_visual_frontend(jcfg.visual, batch_size=2)
    cfg = load_config(overrides=["visual.backbone=resnet50",
                                 "visual.dtype=float32"])
    assert (cfg.visual.feature_dim, cfg.model.visual_dim) == (2048, 2048)
    frames = np.random.default_rng(3).integers(0, 256, (2, 40, 48, 3),
                                               dtype=np.uint8)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jax_front.model.apply)(jax_front.variables,
                                                        frames))
    model = make_backbone(cfg.visual,
                          state_dict=backbone_from_flax(jax_front.variables))
    with torch.inference_mode():
        got = model(torch.from_numpy(frames))
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    with pytest.raises(ValueError, match="2048"):
        make_backbone(load_config(overrides=[
            "visual.backbone=resnet50", "visual.feature_dim=1024"]).visual)


CONFIG4 = ["visual.backbone=vit", "visual.vit_variant=s16",
           "visual.resnet_size=32", "visual.dtype=float32",
           "audio.encoder=large", "audio.dtype=float32",
           "model.fusion=cross", "model.temporal_encoder=moe",
           "model.hidden_dim=32", "model.moe_experts=4", "model.moe_topk=2"]


@pytest.mark.skipif(not native_available(), reason="libavsumio.so not built")
def test_summarize_config4_matches_jax(tmp_path):
    stem = str(tmp_path / "four")
    write_scene_video(stem, n_scenes=4, seed=21, height=72, width=96)
    jcfg = jax_load_config(overrides=CONFIG4)
    jax_pipe = JaxPipeline(jcfg)
    jax_model = jax_make_model(jcfg.model)
    with jax.default_matmul_precision("highest"):
        params = jax_model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, jcfg.model.visual_dim)),
            jnp.zeros((1, 8, jcfg.model.audio_dim)), jnp.ones((1, 8)))[
                "params"]
        ref = jax_pipe.summarize(stem + ".y4m", jax_model, params)
    cfg = load_config(overrides=CONFIG4)
    backbone = make_backbone(
        cfg.visual, state_dict=backbone_from_flax(jax_pipe.visual.variables))
    encoder = make_audio_encoder("large")
    encoder.load_state_dict(vggish_from_flax(jax_pipe.audio.vggish_params))
    pipe = AVPipeline(cfg, VisualFrontend(cfg.visual, backbone, "cpu"),
                      AudioFrontend(cfg.audio, encoder, "cpu"))
    model = make_model(cfg.model, state_dict=scorer_from_flax(params))
    got = pipe.summarize(stem + ".y4m", model)
    np.testing.assert_array_equal(got["boundaries"], ref["boundaries"])
    assert len(got["boundaries"]) >= 3
    np.testing.assert_allclose(got["scores"], ref["scores"], **TOL)
    np.testing.assert_array_equal(got["segments"], ref["segments"])


def _write_cache(path, dims, n=4, seed=0):
    rng = np.random.default_rng(seed)
    cache = FeatureCache(path)
    for i in range(n):
        s = int(rng.integers(10, 30))
        ends = np.cumsum(rng.integers(20, 60, s))
        bounds = np.stack([np.concatenate([[0], ends[:-1]]), ends], 1)
        cache.put(f"v{i}", rng.standard_normal((s, dims[0]), np.float32),
                  rng.standard_normal((s, dims[1]), np.float32), bounds,
                  30.0, int(ends[-1]))


@pytest.mark.parametrize("config", ["moe_ep", "deep_pp"])
def test_cli_trains_the_config_on_one_device(tmp_path, config):
    """The published config with its widths cut (hidden 16, 2 heads) and
    its mesh set to one device; its own mesh, in one process, raises
    naming the torchrun command."""
    _write_cache(f"{tmp_path}/cache", (16, 8))
    path = os.path.join(REPO, "configs", f"{config}.yaml")
    sets = [f"data.cache_dir={tmp_path}/cache", "data.max_shots=32",
            "data.batch_videos=2", "model.visual_dim=16", "model.audio_dim=8",
            "model.hidden_dim=16", "model.num_heads=2",
            "model.scorer_hidden=8", "train.epochs=1", "train.log_every=1",
            f"train.checkpoint_dir={tmp_path}/ckpt",
            f"train.log_path={tmp_path}/log.jsonl"]
    args = ["train", "--config", path, "--device", "cpu",
            *[a for s in sets for a in ("--set", s)]]
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 8"):
        main(args)
    assert main([*args, "--set", "mesh.data=1", "--set", "mesh.model=1"]) == 0
    records = [json.loads(line) for line in open(f"{tmp_path}/log.jsonl")]
    assert len(records) == 2 and all(np.isfinite(r["loss"]) for r in records)
    model = make_model(load_config(path).model)  # the published widths
    if config == "moe_ep":
        assert len(model.visual_temporal.blocks) == 2
        assert model.visual_temporal.blocks[0].moe_ffn.w1.shape == (8, 512,
                                                                    2048)
    else:
        assert len(model.visual_temporal.stages) == 4
        assert all(len(stage.layers) == 3
                   for stage in model.visual_temporal.stages)


@pytest.mark.parametrize("variant", [
    dict(temporal_encoder="tcn"),
    dict(temporal_encoder="attention", temporal_layers=4, pp_stages=4),
    dict(temporal_encoder="attention", chunk_size=32, use_pallas=False)],
    ids=["tcn", "staged", "chunked"])
def test_variant_export_round_trip(tmp_path, variant):
    """The artifact (symbolic batch and shot axes) against the eager
    scorer at two shot counts; a symbolic S takes the chunked math as one
    chunk."""
    from avsum_torch.serve.export import export_scorer, load_scorer

    cfg = ModelConfig(visual_dim=40, audio_dim=24, hidden_dim=32,
                      num_heads=4, scorer_hidden=8, **variant)
    model = make_model(cfg, seed=6)
    path = tmp_path / "scorer.pt2"
    path.write_bytes(export_scorer(model, 40, 24, device="cpu"))
    scorer = load_scorer(str(path), "cpu")
    rng = np.random.default_rng(9)
    for b, s in ((1, 40), (2, 72)):
        v = rng.standard_normal((b, s, 40)).astype(np.float32)
        a = rng.standard_normal((b, s, 24)).astype(np.float32)
        m = np.ones((b, s), np.float32)
        m[-1, s - s // 4:] = 0.0
        with torch.no_grad():
            want = model(*(torch.from_numpy(x) for x in (v, a, m)))
        np.testing.assert_allclose(scorer(v, a, m).numpy(), want.numpy(),
                                   **SCORE_TOL)
