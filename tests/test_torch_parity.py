"""The port's F1-parity harness (``python -m avsum_torch.bench parity``,
``avsum_torch/bench/parity.py``) against the JAX package's
``scripts/parity_reference.py``, on the CPU at the ``--quick`` world's
size (6 videos of 5 scenes at 48x64, hidden 64, 8 epochs, 2 folds; 2
seeds).

- The counterparts of ``tests/test_parity_reference.py``: the reference
  model's contract (and its outputs equal to the JAX harness's model from
  one seed), its training, the TVSum and SumMe runs end to end, the
  seed-level CI and the §7.8 verdicts.
- The world against the JAX harness's ``build_world``: the y4m and wav
  bytes equal; the in-memory TVSum annotations equal ``load_tvsum`` of the
  JAX harness's ``ydata.mat``, array for array; the SumMe ``.mat`` arrays
  equal; the features within rtol = atol = 1e-4 when the port's pipeline
  gets the JAX pipeline's encoder weights (converted by
  ``avsum_torch.convert``).
- On the cache the JAX harness built, the port's run gives the reference
  arm's per-video canonical F1 (and its fold means) equal to the JAX
  harness's within 1e-6: the same torch CPU code, seeds, splits and
  protocol.
- The report's JSON keys are the JAX report's; ``_summarize`` and the
  verdicts give the JAX harness's numbers on the same raw data.
- ``parity --quick --device cpu`` through the CLI in a process without
  JAX writes ``PARITY_F1_TORCH.{json,md}``; without ``--device`` it raises
  with no card.
"""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.io
import torch

import scripts.parity_reference as jax_parity
from avsum_tpu.data.cache import FeatureCache as JaxFeatureCache
from avsum_tpu.data.tvsum import load_tvsum as jax_load_tvsum
from avsum_tpu.pipeline import AVPipeline as JaxPipeline
from avsum_tpu.train.config import load_config as jax_load_config
from avsum_torch.bench import parity
from avsum_torch.convert import tiny_backbone_from_flax, vggish_from_flax
from avsum_torch.data.batching import VideoExample
from avsum_torch.data.tvsum import load_tvsum

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
F1_TOL = 1e-6
ST = parity.ParitySettings(**dict(parity.QUICK, n_seeds=2))
BLOCKED = ("avsum_tpu", "jax", "flax", "optax", "scripts")
NO_JAX = f"""
import runpy, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
sys.argv = ["avsum_torch.bench", *sys.argv[1:]]
try:
    runpy.run_module("avsum_torch.bench", run_name="__main__")
finally:
    assert not [m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in {BLOCKED!r}]
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: its work is many small CPU steps,
    and the suite's parallel workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_settings(**kw):
    return jax_parity.ParitySettings(**{**dataclasses.asdict(ST), **kw})


@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """The JAX harness's TVSum world at ST, with its reference arm run
    (no contenders) -> its root."""
    root = str(tmp_path_factory.mktemp("jax") / "tvsum")
    jax_parity.run_parity(root, _jax_settings(), variants=())
    return root


@pytest.fixture(scope="module")
def jax_weights(jax_world):
    """The JAX world pipeline's encoder weights as the port's state dicts."""
    cfg = jax_load_config(overrides=[
        "visual.backbone=tiny", "visual.dtype=float32",
        "audio.silence_fallback=true", "data.dataset=tvsum"])
    pipe = JaxPipeline(cfg)
    return {"visual": tiny_backbone_from_flax(pipe.visual.variables),
            "vggish": vggish_from_flax(pipe.audio.vggish_params)}


@pytest.fixture(scope="module")
def port_world(tmp_path_factory, jax_weights):
    """The port's TVSum world at ST, with the JAX pipeline's weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    root = str(tmp_path_factory.mktemp("port") / "tvsum")
    cfg, cache, anno = parity.build_world(root, ST, "cpu",
                                          weights=jax_weights)
    return root, cfg, cache, anno


@pytest.fixture(scope="module")
def tvsum_run(port_world):
    """The port's whole run on its TVSum world: (result, progress, info)."""
    root = port_world[0]
    info = {}
    result = parity.run_parity(root, ST, device="cpu", info=info)
    with open(os.path.join(root, "progress.json")) as fh:
        return result, json.load(fh), info


@pytest.fixture(scope="module")
def summe_run(tmp_path_factory):
    """The port's whole run on a SumMe world (4 users, 1 seed)."""
    root = str(tmp_path_factory.mktemp("summe") / "summe")
    st = dataclasses.replace(ST, dataset="summe", n_users_summe=4, n_seeds=1)
    result = parity.run_parity(root, st, device="cpu")
    with open(os.path.join(root, "progress.json")) as fh:
        return root, st, result, json.load(fh)


# ---------------------------------------------------------------------------
# The counterparts of tests/test_parity_reference.py
# ---------------------------------------------------------------------------


def test_reference_model_semantics():
    """[1, S, Dv] x [1, S, Da] -> [S] sigmoid scores; the same weights and
    outputs as the JAX harness's model from one seed."""
    dv, da, s = 32, 12, 9
    torch.manual_seed(0)
    model = parity.build_reference_model(dv, da, hidden_dim=16).eval()
    torch.manual_seed(0)
    theirs = jax_parity.build_reference_model(dv, da, hidden_dim=16).eval()
    v = torch.randn(1, s, dv)
    a = torch.randn(1, s, da)
    with torch.no_grad():
        out = model(v, a)
        want = theirs(v, a)
    assert out.shape == (s,)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    # the §8.5 quirk: the attention sees [B, S, E] as S batches of
    # length-1 sequences, so each shot attends only to itself
    fused = torch.randn(1, s, 32)
    with torch.no_grad():
        attn, weights = model.attention(fused, fused, fused)
    assert weights.shape == (s, 1, 1)


def test_reference_training_reduces_loss():
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    examples = []
    for i in range(3):
        visual = rng.standard_normal((8, 24)).astype(np.float32)
        examples.append(VideoExample(
            video_id=f"v{i}", visual=visual,
            audio=rng.standard_normal((8, 10)).astype(np.float32),
            targets=(visual[:, 0] > 0).astype(np.float32)))
    model = parity.build_reference_model(24, 10, hidden_dim=32)

    def total_loss():
        return sum(float(F.mse_loss(
            torch.from_numpy(parity.score_with_reference(model, ex)),
            torch.from_numpy(ex.targets))) for ex in examples)

    before = total_loss()
    parity.train_reference_model(model, examples, epochs=60, lr=1e-3)
    after = total_loss()
    assert after < before * 0.5, (before, after)


def test_parity_run_summe(summe_run, tmp_path):
    """The SumMe side: per-user binary ~15% selections, the canonical
    max-over-users F1; one report with both datasets' sections."""
    _, _, result, _ = summe_run
    assert result["dataset"] == "summe"
    assert "max over 4 user summaries" in result["protocol"]
    assert set(result["models"]) == set(parity.KEYS)
    for r in result["models"].values():
        assert 0.0 <= r["canonical_f1"] <= 1.0
    tvsum_like = dict(result, dataset="tvsum")
    parity.write_reports([tvsum_like, result], str(tmp_path),
                         {"reference": "cpu", "contenders": "cpu",
                          "card": None})
    md = (tmp_path / "PARITY_F1_TORCH.md").read_text()
    assert "## tvsum" in md and "## summe" in md
    assert "python -m avsum_torch.bench parity" in md
    assert "contenders trained and scored on cpu" in md
    loaded = json.loads((tmp_path / "PARITY_F1_TORCH.json").read_text())
    assert set(loaded["datasets"]) == {"tvsum", "summe"}
    assert not (tmp_path / "PARITY_F1.json").exists()


def test_parity_run_end_to_end(tvsum_run, tmp_path):
    result, progress, info = tvsum_run
    models = result["models"]
    assert set(models) == set(parity.KEYS)
    for r in models.values():
        assert 0.0 <= r["canonical_f1"] <= 1.0
        assert len(r["per_seed_canonical_f1"]) == 2
    att = models["avsum_attention"]
    assert "delta_canonical_f1_pts" in att
    lo, hi = att["paired_ci95_pts"]
    assert lo <= att["paired_delta_pts"] <= hi
    assert info["reference"] == "cpu" and info["contenders"] == "cpu"
    assert progress["arms"] == {"reference": "cpu", "contenders": "cpu",
                                "card": None}
    parity.write_reports(result, str(tmp_path), info)
    loaded = json.loads((tmp_path / "PARITY_F1_TORCH.json").read_text())
    assert loaded["models"].keys() == models.keys()


def _ci_world(offsets_a, offsets_b, seed=7):
    """video_f1 / fold_means over 4 videos and 3 seeds with controlled
    per-seed deltas of the two contenders."""
    vids = [f"v{i}" for i in range(4)]
    rng = np.random.default_rng(seed)
    base = {s: {v: float(rng.uniform(0.4, 0.6)) for v in vids}
            for s in range(3)}
    video_f1 = {
        "reference_torch_bilstm": base,
        "avsum_bilstm": {s: {v: base[s][v] + offsets_a[s] for v in vids}
                         for s in range(3)},
        "avsum_attention": {s: {v: base[s][v] + offsets_b[s] for v in vids}
                            for s in range(3)},
    }
    fold_means = {
        k: [[{"canonical_f1": float(np.mean(list(video_f1[k][s].values())))}]
            for s in range(3)]
        for k in video_f1
    }
    return fold_means, video_f1, vids


def test_seed_level_paired_ci_math():
    """The seed-level paired t CI against a hand computation, the verdict
    on both sides of the 2-pt half-width, and the JAX harness's numbers."""
    from scipy import stats as sps

    st = parity.ParitySettings(n_videos=4, n_seeds=3, n_folds=2, epochs=1)
    fold_means, video_f1, vids = _ci_world([0.01, 0.02, 0.015],
                                           [-0.03, 0.05, 0.01])
    result = parity._summarize(st, 3, fold_means, video_f1, vids, 0.0)
    r = result["models"]["avsum_bilstm"]
    d = np.array([1.0, 2.0, 1.5])
    se = d.std(ddof=1) / np.sqrt(3)
    tcrit = sps.t.ppf(0.975, 2)
    np.testing.assert_allclose(
        r["seed_paired_ci95_pts"],
        [round(d.mean() - tcrit * se, 2), round(d.mean() + tcrit * se, 2)],
        atol=0.015)
    assert parity._model_verdict(r) == "PASS"
    r2 = result["models"]["avsum_attention"]
    assert parity._model_verdict(r2) == "FAIL-POWER"
    assert r2["paired_delta_pts"] >= -0.5
    assert parity._dataset_verdict(result["models"]) == "FAIL-POWER"
    want = jax_parity._summarize(
        jax_parity.ParitySettings(**dataclasses.asdict(st)), 3, fold_means,
        video_f1, vids, 0.0)
    _assert_same_result(result, want)


def test_noninferiority_clause_passes_wide_positive_ci():
    """PARITY_PROCEDURE.md §7.8: a CI whose lower bound clears -0.5 passes
    whatever its width; wide and straddling fails on power; a point
    estimate below -0.5 is inferior. Each as the JAX harness decides."""
    cases = [({"paired_delta_pts": 6.0, "seed_paired_ci95_pts": [2.08, 9.92]},
              "PASS"),
             ({"paired_delta_pts": 1.12,
               "seed_paired_ci95_pts": [-1.73, 3.96]}, "FAIL-POWER"),
             ({"paired_delta_pts": -0.9,
               "seed_paired_ci95_pts": [-1.9, 0.1]}, "FAIL-INFERIOR"),
             ({"paired_delta_pts": 0.2, "paired_ci95_pts": [-1.0, 1.4]},
              "PASS")]
    for r, want in cases:
        assert parity._model_verdict(r) == jax_parity._model_verdict(r) == want


# ---------------------------------------------------------------------------
# The world against the JAX harness's
# ---------------------------------------------------------------------------


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_world_media_bytes_equal_jax(jax_world, port_world):
    names = sorted(os.listdir(os.path.join(jax_world, "videos")))
    assert names == sorted(os.listdir(os.path.join(port_world[0], "videos")))
    assert len(names) == 2 * ST.n_videos
    for name in names:
        assert _read(os.path.join(jax_world, "videos", name)) == _read(
            os.path.join(port_world[0], "videos", name)), name


def _assert_same_tvsum(got, want):
    assert [v.video_id for v in got] == [v.video_id for v in want]
    for g, w in zip(got, want):
        assert (g.title, g.category, g.length, g.n_frames) == (
            w.title, w.category, w.length, w.n_frames)
        assert g.user_scores.dtype == w.user_scores.dtype == np.float32
        np.testing.assert_array_equal(g.user_scores, w.user_scores)


def test_tvsum_annotations_equal_jax_mat(jax_world, port_world):
    """The in-memory annotations are load_tvsum of the JAX harness's
    ydata.mat, array for array; the port's own .mat (h5py imports here)
    reads back the same."""
    _, cfg, _, anno = port_world
    want = jax_load_tvsum(os.path.join(jax_world, "ydata.mat"))
    _assert_same_tvsum(anno, want)
    _assert_same_tvsum(load_tvsum(cfg.data.annotation_path), want)


def test_summe_gt_equal_jax(summe_run, tmp_path):
    root, st, _, _ = summe_run
    _, ids, frame_scores, scene_lists = parity.write_world_media(
        str(tmp_path / "media"), st)
    jax_gt = str(tmp_path / "jax_gt")
    jax_parity._write_summe_gt(jax_gt, ids, frame_scores, scene_lists,
                               _jax_settings(**dataclasses.asdict(st)))
    assert sorted(os.listdir(jax_gt)) == sorted(os.listdir(f"{root}/GT"))
    for name in sorted(os.listdir(jax_gt)):
        got = scipy.io.loadmat(f"{root}/GT/{name}")
        want = scipy.io.loadmat(f"{jax_gt}/{name}")
        for key in ("gt_score", "user_score", "nFrames", "FPS"):
            assert got[key].dtype == want[key].dtype, (name, key)
            np.testing.assert_array_equal(got[key], want[key])


def test_world_features_match_jax(jax_world, port_world):
    cache = port_world[2]
    theirs = JaxFeatureCache(os.path.join(jax_world, "cache"))
    assert cache.video_ids() == theirs.video_ids() == [
        f"pv{i:02d}" for i in range(ST.n_videos)]
    for vid in cache.video_ids():
        got, want = cache.get(vid), theirs.get(vid)
        np.testing.assert_array_equal(got.shot_boundaries,
                                      want.shot_boundaries)
        assert (got.fps, got.n_frames) == (want.fps, want.n_frames)
        np.testing.assert_allclose(got.visual, want.visual, **TOL)
        np.testing.assert_allclose(got.audio, want.audio, **TOL)
        assert cache.meta(vid)["fingerprint"] == theirs.meta(vid)[
            "fingerprint"]


# ---------------------------------------------------------------------------
# Results against the JAX harness's
# ---------------------------------------------------------------------------


def test_reference_arm_on_jax_cache_equals_jax(jax_world, tmp_path):
    """The port's run over a copy of the JAX harness's work directory (its
    progress.json removed): the cache is reused, not rebuilt, and the
    reference arm's per-video canonical F1 and fold means are the JAX
    harness's within 1e-6."""
    root = str(tmp_path / "tvsum")
    shutil.copytree(jax_world, root)
    os.remove(os.path.join(root, "progress.json"))
    cached = {vid: _read(os.path.join(root, "cache", vid, "meta.json"))
              for vid in JaxFeatureCache(os.path.join(root,
                                                      "cache")).video_ids()}
    parity.run_parity(root, ST, variants=(), device="cpu")
    for vid, meta in cached.items():  # not re-extracted
        assert _read(os.path.join(root, "cache", vid, "meta.json")) == meta
    with open(os.path.join(root, "progress.json")) as fh:
        got = json.load(fh)
    with open(os.path.join(jax_world, "progress.json")) as fh:
        want = json.load(fh)
    key = "reference_torch_bilstm"
    assert got["cells"] == want["cells"]
    for s in range(ST.n_seeds):
        assert sorted(got["video_f1"][key][s]) == sorted(
            want["video_f1"][key][s])
        assert len(got["video_f1"][key][s]) == ST.n_videos
        for vid, f1 in want["video_f1"][key][s].items():
            assert abs(got["video_f1"][key][s][vid] - f1) <= F1_TOL, (s, vid)
        for g, w in zip(got["fold_means"][key][s], want["fold_means"][key][s]):
            assert set(g) == set(w)
            for m in w:
                assert abs(g[m] - w[m]) <= F1_TOL, (s, m)


def _assert_same_result(got, want):
    """Two results equal, NaN for NaN, but for the wall clock."""
    got, want = dict(got, wall_s=None), dict(want, wall_s=None)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def _keys(x, prefix=""):
    """Every key path of a JSON value."""
    if isinstance(x, dict):
        out = set()
        for k, v in x.items():
            out |= {f"{prefix}/{k}"} | _keys(v, f"{prefix}/{k}")
        return out
    return set()


def test_report_json_keys_equal_jax(tvsum_run, summe_run, tmp_path):
    result = tvsum_run[0]
    summe = summe_run[2]
    for results in (result, [result, summe]):
        parity.write_reports(results, str(tmp_path / "port"))
        jax_parity.write_reports(results, str(tmp_path / "jax"))
        got = json.loads((tmp_path / "port" / "PARITY_F1_TORCH.json")
                         .read_text())
        want = json.loads((tmp_path / "jax" / "PARITY_F1.json").read_text())
        assert _keys(got) == _keys(want)


def test_summarize_and_verdicts_equal_jax(tvsum_run, summe_run):
    """_summarize and the verdicts on the port runs' raw data (from
    progress.json) equal the JAX harness's on the same data."""
    for st, prog in ((ST, tvsum_run[1]), (summe_run[1], summe_run[3])):
        vids = sorted(prog["video_f1"]["reference_torch_bilstm"][0])
        got = parity._summarize(st, st.n_seeds, prog["fold_means"],
                                prog["video_f1"], vids, 0.0)
        want = jax_parity._summarize(_jax_settings(**dataclasses.asdict(st)),
                                     st.n_seeds, prog["fold_means"],
                                     prog["video_f1"], vids, 0.0)
        _assert_same_result(got, want)
        assert parity._dataset_verdict(got["models"]) == \
            jax_parity._dataset_verdict(want["models"])
        for key in ("avsum_bilstm", "avsum_attention"):
            assert parity._model_verdict(got["models"][key]) == \
                jax_parity._model_verdict(want["models"][key])


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------


def test_cli_quick_cpu_writes_the_torch_report(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", NO_JAX, "parity", "--quick", "--device",
         "cpu", "--dataset", "summe", "--out-dir", str(tmp_path / "out"),
         "--work-dir", str(tmp_path / "work")],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-4000:]
    (line,) = [json.loads(x) for x in res.stdout.strip().splitlines()]
    assert line["dataset"] == "summe" and line["device"] == "cpu"
    assert line["reference_device"] == "cpu" and line["card"] is None
    assert set(line["models"]) == set(parity.KEYS)
    assert all(0.0 <= r["canonical_f1"] <= 1.0
               for r in line["models"].values())
    assert line["world_launches"] == {"melspec": 0}  # the CPU's plain path
    report = json.loads((tmp_path / "out" / "PARITY_F1_TORCH.json")
                        .read_text())
    assert report["settings"] == dict(dataclasses.asdict(
        parity.ParitySettings(**parity.QUICK)), dataset="summe")
    assert math.isfinite(report["models"]["avsum_bilstm"]["paired_delta_pts"])
    assert os.path.exists(tmp_path / "out" / "PARITY_F1_TORCH.md")
    assert os.path.exists(tmp_path / "work" / "summe" / "progress.json")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_defaults_to_the_card(tmp_path):
    from avsum_torch.bench.__main__ import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["parity", "--quick", "--work-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
