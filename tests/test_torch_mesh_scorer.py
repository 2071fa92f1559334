"""The scorer on a mesh (``avsum_torch/models/scorer.py``, ``AVScorer(config,
mesh)`` via ``to_mesh``) on a world of 4 gloo CPU ranks, each scoring its
block [B / data, S / seq], against the one-process scorer and JAX's
``make_model(cfg, mesh=...)`` on the host CPU mesh, with JAX's weights
(``avsum_torch.convert``), float32, JAX at "highest" precision: 2e-5.

The meshes: the attention encoder and self fusion with ring attention at
seq 2 (data 2 x seq 2) and seq 4; the BiLSTM and the TCN at seq 2
(gathered shot axis); the MoE encoder (4 experts) with cross fusion at
model 2 (data 2 x model 2: expert parallelism, cross fusion gathered);
the staged encoder (4 layers in 2 stages) at model 2 (GPipe).

The rank functions import no JAX: each rank imports this module."""

import numpy as np
import pytest
import torch

from avsum_torch.models.scorer import AVScorer, to_mesh
from avsum_torch.parallel.mesh import MeshConfig, block_slices, host_cpu_mesh
from avsum_torch.parallel.multihost import Ranks
from avsum_torch.train.config import ModelConfig

B, S = 4, 16
BASE = dict(visual_dim=12, audio_dim=6, hidden_dim=16, num_heads=2,
            scorer_hidden=8, dropout=0.0)
CASES = {
    "attention_seq2": (dict(temporal_encoder="attention"), dict(seq=2)),
    "attention_seq4": (dict(temporal_encoder="attention"), dict(seq=4)),
    "bilstm_seq2": (dict(temporal_encoder="bilstm"), dict(seq=2)),
    "tcn_seq2": (dict(temporal_encoder="tcn"), dict(seq=2)),
    "moe_cross_model2": (dict(temporal_encoder="moe", moe_experts=4,
                              fusion="cross"), dict(model=2)),
    "staged_model2": (dict(temporal_encoder="attention", temporal_layers=4,
                           pp_stages=2), dict(model=2)),
}
TOL = dict(rtol=2e-5, atol=2e-5)


def _batch(seed: int = 5):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, S), np.float32)
    mask[0, S - 3:] = 0.0
    mask[2, 5:] = 0.0
    return {"visual": rng.standard_normal((B, S, 12)).astype(np.float32),
            "audio": rng.standard_normal((B, S, 6)).astype(np.float32),
            "mask": mask}


def _scorer(fields, weights) -> AVScorer:
    model = AVScorer(ModelConfig(**BASE, **fields))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return model.eval()


def _scorer_rank(fields, mesh_fields, weights):
    mesh = host_cpu_mesh(MeshConfig(**mesh_fields))
    model = to_mesh(_scorer(fields, weights), mesh)
    batch = _batch()
    idx = block_slices(batch["mask"].shape, mesh.config, mesh.coords)
    with torch.no_grad():
        out = model(*(torch.from_numpy(batch[k][idx].copy())
                      for k in ("visual", "audio", "mask")))
    return idx, out.numpy()


def _jax(fields, mesh_fields):
    """-> (JAX's scores on its mesh, its weights as a state_dict)."""
    import jax

    from avsum_tpu.models import make_model as jax_make_model
    from avsum_tpu.parallel import MeshConfig as JaxMeshConfig, build_mesh
    from avsum_tpu.train.config import ModelConfig as JaxModelConfig
    from avsum_torch.convert import scorer_from_flax

    cfg = JaxModelConfig(**BASE, **fields)
    batch = _batch()
    args = (batch["visual"], batch["audio"], batch["mask"])
    params = jax_make_model(cfg).init(jax.random.PRNGKey(3), *args)["params"]
    mesh = build_mesh(JaxMeshConfig(**mesh_fields), jax.devices()[:4])
    with jax.default_matmul_precision("highest"):
        scores = np.asarray(jax_make_model(cfg, mesh=mesh).apply(
            {"params": params}, *args))
    weights = {k: v.numpy() for k, v in
               scorer_from_flax(jax.device_get(params)).items()}
    return scores, weights


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4) as r:
        yield r


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_scorer_matches_one_process_and_jax(ranks, case):
    fields, mesh_fields = CASES[case]
    want, weights = _jax(fields, mesh_fields)
    batch = _batch()
    with torch.no_grad():
        one = _scorer(fields, weights)(*(torch.from_numpy(batch[k]) for k in
                                         ("visual", "audio", "mask"))).numpy()
    np.testing.assert_allclose(one, want, **TOL)
    got = np.full((B, S), np.nan, np.float32)
    for idx, out in ranks.run(_scorer_rank, fields, mesh_fields, weights):
        got[idx] = out
    np.testing.assert_allclose(got, one, **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[batch["mask"] == 0] == 0.0)
