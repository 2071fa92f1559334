"""The port's scorer modules against the JAX package: BiLSTM with padded
masks and the AVScorer (bilstm encoder, self fusion, hidden 64) with a
padded mask, on both sides of the attention's 512-position threshold.
float32; rtol 1e-4, atol 1e-5 (sigmoid and tanh outputs near zero)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from avsum_tpu.models import make_model as jax_make_model
from avsum_tpu.models.temporal import BiLSTM as JaxBiLSTM
from avsum_tpu.train.config import ModelConfig as JaxModelConfig
from avsum_torch.convert import bilstm_from_flax, scorer_from_flax
from avsum_torch.models.scorer import make_model
from avsum_torch.models.temporal import BiLSTM
from avsum_torch.train.config import MeshShape, ModelConfig
from avsum_torch.parallel.mesh import build_mesh, mesh_config

TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _padded_mask(b, s):
    mask = np.ones((b, s), np.float32)
    mask[0, s - 3:] = 0.0  # trailing padding
    if b > 1:
        mask[1, s // 2:] = 0.0
    return mask


def test_bilstm_padded_masks_match_jax():
    b, s, f, hidden = 2, 17, 12, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, s, f)).astype(np.float32)
    mask = _padded_mask(b, s)
    jm = JaxBiLSTM(hidden)
    with jax.default_matmul_precision("highest"):
        params = jm.init(jax.random.PRNGKey(1), x, mask)["params"]
        params = jax.tree_util.tree_map(  # a non-zero bias for the test
            lambda p: p + 0.1 if p.ndim == 1 else p, params)
        ref = np.asarray(jm.apply({"params": params}, x, mask))
    ours = BiLSTM(f, hidden)
    ours.load_state_dict(bilstm_from_flax(params))
    with torch.inference_mode():
        got = ours(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    # padded steps neither move the state nor leak into real steps
    assert not got[0, s - 3:].any()


@pytest.mark.parametrize("s", [40, 520])
def test_avscorer_matches_jax(s):
    fields = dict(hidden_dim=64, temporal_encoder="bilstm", visual_dim=48,
                  audio_dim=24)
    rng = np.random.default_rng(s)
    visual = rng.standard_normal((2, s, 48)).astype(np.float32)
    audio = rng.standard_normal((2, s, 24)).astype(np.float32)
    mask = _padded_mask(2, s)
    jm = jax_make_model(JaxModelConfig(**fields))
    with jax.default_matmul_precision("highest"):
        params = jm.init(jax.random.PRNGKey(2), jnp.asarray(visual[:, :8]),
                         jnp.asarray(audio[:, :8]), jnp.asarray(mask[:, :8]))[
                             "params"]
        ref = np.asarray(jax.jit(jm.apply)({"params": params}, visual, audio,
                                           mask))
    model = make_model(ModelConfig(**fields),
                       state_dict=scorer_from_flax(params))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in (visual, audio, mask)))
    assert got.shape == (2, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert not got.numpy()[mask == 0].any()


@pytest.mark.parametrize("change", [
    dict(temporal_encoder="moe"), dict(temporal_encoder="tcn"),
    dict(fusion="cross"), dict(pp_stages=4, temporal_layers=4)])
def test_unported_scorer_variants_raise(change):
    """Each variant builds and scores on one device; its mesh-parallel
    form (sharded experts, GPipe stages) needs one process per rank, and
    a mesh larger than the world raises, naming the torchrun command."""
    cfg = ModelConfig(visual_dim=8, audio_dim=4, hidden_dim=16, **change)
    with torch.inference_mode():
        scores = make_model(cfg)(torch.ones(1, 6, 8), torch.ones(1, 6, 4))
    assert scores.shape == (1, 6) and torch.isfinite(scores).all()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        build_mesh(mesh_config(MeshShape(model=4, auto_data=False)), "cpu")
    with pytest.raises(ValueError, match="unknown temporal encoder"):
        make_model(ModelConfig(temporal_encoder="gru"))


def test_convert_cli_from_npz_matches_jax(tmp_path):
    """The JAX scorer's params (attention encoder) flattened to ``/``-joined
    paths in an .npz, through ``python -m avsum_torch.convert``."""
    fields = dict(hidden_dim=32, num_heads=2, temporal_encoder="attention",
                  visual_dim=48, audio_dim=24, scorer_hidden=16)
    rng = np.random.default_rng(9)
    visual = rng.standard_normal((2, 40, 48)).astype(np.float32)
    audio = rng.standard_normal((2, 40, 24)).astype(np.float32)
    mask = _padded_mask(2, 40)
    jm = jax_make_model(JaxModelConfig(**fields))
    with jax.default_matmul_precision("highest"):
        params = jm.init(jax.random.PRNGKey(4), visual[:, :8], audio[:, :8],
                         mask[:, :8])["params"]
        ref = np.asarray(jm.apply({"params": params}, visual, audio, mask))
    flat = traverse_util.flatten_dict(params, sep="/")
    np.savez(tmp_path / "scorer.npz",
             **{path: np.asarray(value) for path, value in flat.items()})
    res = subprocess.run(
        [sys.executable, "-m", "avsum_torch.convert", "--params",
         str(tmp_path / "scorer.npz"), "--out", str(tmp_path / "w.pt")],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    state_dict = torch.load(tmp_path / "w.pt")["scorer"]
    model = make_model(ModelConfig(**fields), state_dict=state_dict)
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in (visual, audio, mask)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
