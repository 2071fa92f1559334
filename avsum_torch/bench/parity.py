"""F1 parity against the reference as re-run, the counterpart of the JAX
package's ``scripts/parity_reference.py``: ``python -m avsum_torch.bench
parity [--quick] [--dataset tvsum|summe|both] [--device cuda|cpu]``.

1. A seeded synthetic TVSum- or SumMe-shaped world (:func:`build_world`):
   scene-structured videos written as Y4M + WAV, whose true importance is
   a scene's brightness rank mixed with a latent rank not in the pixels;
   TVSum's 20 noisy annotators (kept in memory as ``TVSumVideo`` records,
   and written as ``ydata.mat`` only where h5py imports) or SumMe's
   per-user binary ~15% selections (``GT/*.mat``). The same numpy draws,
   and the same bytes, as the JAX harness's world.
2. One preprocess of the world into a feature cache through the port's
   pipeline on ``--device`` (tiny backbone and VGGish, float32, seeded
   random weights from ``--seed`` or ``--weights``).
3. Per seed and cross-validation fold, three contenders on the same
   features, targets, splits and protocol:

   a. the reference's AVBiLSTMModel rebuilt in torch, with its training
      recipe (AdamW lr 1e-4, MSE, shuffled, batch 1, ``epochs``), in
      float32 **on the CPU** always: the pairing arm, not part of the
      port; on one world and one CPU its numbers are the JAX harness's;
   b. the port's AVScorer with the BiLSTM encoder and (c) with the
      attention encoder, through the port's ``Trainer`` on ``--device``
      (the card unless ``--device cpu``; TF32 off) with EMA 0.98, the
      final state only, seed ``seed + 1000 * s + fold``.
4. Each scored by the dataset's canonical knapsack F1 (mean over the 20
   users for TVSum, max over the users for SumMe) and the keyframe
   F1 / rho / tau, then the paired per-video deltas against the
   reference, the seed-level t CI, the bootstrap and the verdict of
   PARITY_PROCEDURE.md §7.8 (:func:`_summarize`, :func:`_model_verdict`:
   the JAX harness's arithmetic).
5. ``PARITY_F1_TORCH.{json,md}`` in ``--out-dir`` (the JAX report's JSON
   keys), rewritten after every complete seed; the raw per-video numbers
   go to ``<work>/<dataset>/progress.json`` after every cell.

Seeds run outermost, so every finished seed is a complete 5-fold result.
A run resumes from ``progress.json`` when its settings are equal, and
``--seed-indices`` runs a subset of seeds, whose report
``python -m avsum_torch.bench parity-merge`` assembles. Both rest on every
cell being a function of (settings, seed, fold) on one world: the world's
feature cache is reused from the work directory (the sweep skips a video
cached under the same configuration fingerprint) and never rebuilt,
because two preprocesses on the card agree only to ~6e-8 (the per-shot
pooling sums with atomics) and a knapsack near-tie can flip on less.
A work directory must therefore keep its encoder weights between runs.

Every stdout line is one JSON object per dataset: its verdict, the
models' rows, where each arm ran and K1's launches during the world's
preprocess. Logs go to stderr.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np

from avsum_torch.bench import (
    REPO,
    card,
    emit,
    launches,
    log,
    require_device,
)

REPORT = "PARITY_F1_TORCH"
KEYS = ("reference_torch_bilstm", "avsum_bilstm", "avsum_attention")
WORLD_SETS = ["visual.backbone=tiny", "visual.dtype=float32",
              "audio.silence_fallback=true"]


# ---------------------------------------------------------------------------
# The reference model, rebuilt in torch (CPU)
# ---------------------------------------------------------------------------


def build_reference_model(visual_dim: int, audio_dim: int, hidden_dim: int):
    """The reference's AVBiLSTMModel (av_model.py:6-46): per-modality
    Linear(d, H) + ReLU + Dropout(0.3); per-modality BiLSTM H -> H/2 x 2
    directions, batch_first; the concatenation through
    ``nn.MultiheadAttention(2H, 4 heads)`` WITHOUT batch_first, fed
    [B, S, E] (the reference's §8.5 quirk: torch reads dim 0 as the
    sequence, so with B = 1 each shot is its own length-1 batch and the
    attention is a per-shot linear map; re-running the reference means
    re-running that); Linear(2H, 64) + ReLU + Linear(64, 1) + Sigmoid,
    squeezed."""
    import torch.nn as tnn

    class ReferenceAVBiLSTM(tnn.Module):
        def __init__(self):
            super().__init__()
            h = hidden_dim
            self.visual_fc = tnn.Sequential(
                tnn.Linear(visual_dim, h), tnn.ReLU(), tnn.Dropout(0.3)
            )
            self.audio_fc = tnn.Sequential(
                tnn.Linear(audio_dim, h), tnn.ReLU(), tnn.Dropout(0.3)
            )
            self.visual_bilstm = tnn.LSTM(
                h, h // 2, bidirectional=True, batch_first=True
            )
            self.audio_bilstm = tnn.LSTM(
                h, h // 2, bidirectional=True, batch_first=True
            )
            # batch_first intentionally unset: the reference's semantics
            self.attention = tnn.MultiheadAttention(2 * h, num_heads=4)
            self.scorer = tnn.Sequential(
                tnn.Linear(2 * h, 64), tnn.ReLU(), tnn.Linear(64, 1),
                tnn.Sigmoid(),
            )

        def forward(self, visual, audio):
            import torch

            v = self.visual_fc(visual)
            a = self.audio_fc(audio)
            v, _ = self.visual_bilstm(v)
            a, _ = self.audio_bilstm(a)
            fused = torch.cat([v, a], dim=-1)
            attn, _ = self.attention(fused, fused, fused)
            return self.scorer(attn).squeeze()

    return ReferenceAVBiLSTM()


def train_reference_model(model, train_examples, epochs: int = 100,
                          lr: float = 1e-4, seed: int = 0):
    """The reference's loop (train_av_model.py:64-96): shuffled, effective
    batch 1, AdamW(lr=1e-4), MSE against the aligned shot scores."""
    import torch
    import torch.nn.functional as F

    torch.manual_seed(seed)
    opt = torch.optim.AdamW(model.parameters(), lr=lr)
    rng = np.random.default_rng(seed)
    tensors = [
        (
            torch.from_numpy(np.ascontiguousarray(ex.visual)[None]),
            torch.from_numpy(np.ascontiguousarray(ex.audio)[None]),
            torch.from_numpy(np.ascontiguousarray(ex.targets)),
        )
        for ex in train_examples
    ]
    model.train()
    for _ in range(epochs):
        for i in rng.permutation(len(tensors)):
            visual, audio, target = tensors[i]
            preds = model(visual, audio)
            loss = F.mse_loss(preds, target)
            opt.zero_grad()
            loss.backward()
            opt.step()
    return model


def score_with_reference(model, example) -> np.ndarray:
    import torch

    model.eval()
    with torch.no_grad():
        preds = model(
            torch.from_numpy(np.ascontiguousarray(example.visual)[None]),
            torch.from_numpy(np.ascontiguousarray(example.audio)[None]),
        )
    return np.atleast_1d(preds.numpy().astype(np.float32))


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ParitySettings:
    """The JAX harness's settings, fields and defaults alike."""

    n_videos: int = 40
    # 16 scenes a video: with ~10 coarse shots the 15% knapsack often has
    # two near-equal but disjoint packings, and a <2% value tie decides
    # the F1; finer shots let the metric measure ranking
    n_scenes: int = 16
    height: int = 48
    width: int = 64
    epochs: int = 100
    hidden_dim: int = 512
    n_folds: int = 5
    seed: int = 0
    # independent init / training seeds a contender; the reference's own
    # spread across them is the noise floor a delta is read against
    n_seeds: int = 5
    # EMA of the port's contenders (the reference keeps its recipe)
    ema_decay: float = 0.98
    # world hardness: the share of a scene's importance its brightness
    # rank predicts (the rest is a latent rank not in the pixels), and
    # each user's per-scene disagreement; together they put the
    # protocol's ceiling near canonical F1 0.68 (random ~0.13)
    signal_alpha: float = 0.85
    scene_noise: float = 0.08
    # "tvsum": 20 noisy frame-score users, mean-user knapsack F1;
    # "summe": per-user binary ~15% selections, max-over-users F1
    dataset: str = "tvsum"
    n_users_summe: int = 15


QUICK = dict(n_videos=6, n_scenes=5, epochs=8, hidden_dim=64, n_folds=2,
             n_seeds=1)


def tvsum_user_scores(frame_scores_per_video, seed: int = 0,
                      scene_lists=None, scene_noise: float = 0.0
                      ) -> List[np.ndarray]:
    """The 20 users' [20, n_frames] float64 scores (TVSum's 1-5 range) of
    each video: noisy copies of its base scores, each user shifting each
    scene by an independent N(0, ``scene_noise``) (disagreement that does
    not average out). The draws of the JAX tests' ``write_fake_tvsum_mat``,
    in its order."""
    rng = np.random.default_rng(seed)
    out = []
    for i, base in enumerate(frame_scores_per_video):
        base = np.asarray(base, np.float64)
        users = base[None] + 0.08 * rng.standard_normal((20, len(base)))
        if scene_lists is not None and scene_noise > 0:
            for start, end in scene_lists[i]:
                users[:, start:end] += scene_noise * rng.standard_normal(
                    (20, 1))
        out.append(1.0 + 4.0 * np.clip(users, 0, 1))
    return out


def tvsum_videos(video_ids: Sequence[str], user_scores: Sequence[np.ndarray]):
    """The ``TVSumVideo`` records ``load_tvsum`` reads back from
    :func:`write_tvsum_mat`'s file, without the file."""
    from avsum_torch.data.tvsum import TVSumVideo

    return [TVSumVideo(video_id=vid, title=f"Title {vid}", category="VT",
                       length=float(np.float64(s.shape[1]) / 30.0),
                       n_frames=int(s.shape[1]),
                       user_scores=np.asarray(s, np.float32))
            for vid, s in zip(video_ids, user_scores)]


def write_tvsum_mat(path: str, video_ids: Sequence[str],
                    user_scores: Sequence[np.ndarray]) -> None:
    """A ydata-tvsum50.mat-shaped HDF5 file (the layout
    train_av_model.py:13-58 decodes): object-reference arrays of uint16
    char codes for title, video and category; ``user_anno`` an (N, 1)
    reference array to [20, n_frames] matrices. Needs h5py."""
    import h5py

    n = len(video_ids)
    with h5py.File(path, "w") as f:
        grp = f.create_group("tvsum50")

        def make_str_refs(strings, name):
            refs = []
            for i, s in enumerate(strings):
                codes = np.array([[ord(c)] for c in s], np.uint16)
                refs.append(f.create_dataset(f"/refs/{name}_{i}",
                                             data=codes).ref)
            grp.create_dataset(
                name, data=np.array(refs, h5py.ref_dtype).reshape(1, -1))

        make_str_refs([f"Title {v}" for v in video_ids], "title")
        make_str_refs(list(video_ids), "video")
        make_str_refs(["VT"] * n, "category")
        nframes = np.array([s.shape[1] for s in user_scores], np.float64)
        grp.create_dataset("length", data=(nframes / 30.0).reshape(1, -1))
        grp.create_dataset("nframes", data=nframes.reshape(1, -1))
        refs = [f.create_dataset(f"/refs/anno_{i}", data=s).ref
                for i, s in enumerate(user_scores)]
        grp.create_dataset(
            "user_anno", data=np.array(refs, h5py.ref_dtype).reshape(-1, 1))


def h5py_available() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def write_world_media(root: str, st: ParitySettings):
    """The world's videos as ``<root>/videos/pvNN.{y4m,wav}`` -> (video dir,
    ids, per-frame true importance, scene lists). A scene's importance is
    ``signal_alpha`` x its brightness rank + (1 - ``signal_alpha``) x a
    latent rank (editorial preference: in no pixel, so it lowers every
    contender's ceiling alike)."""
    from avsum_torch.io.synthetic import make_scene_video
    from avsum_torch.io.wav import write_wav
    from avsum_torch.io.y4m import write_y4m

    video_dir = os.path.join(root, "videos")
    os.makedirs(video_dir, exist_ok=True)
    ids, frame_scores, scene_lists = [], [], []
    for i in range(st.n_videos):
        vid = f"pv{i:02d}"
        video, audio, scenes = make_scene_video(
            n_scenes=st.n_scenes, seed=1000 + i, height=st.height,
            width=st.width)
        stem = os.path.join(video_dir, vid)
        write_y4m(stem + ".y4m", video, fps=30.0)
        write_wav(stem + ".wav", audio, 16000)
        world_rng = np.random.default_rng(5000 + i)
        luma = np.asarray([float(video[s:e].mean()) for (s, e) in scenes],
                          np.float64)
        n_sc = len(scenes)
        rank_luma = (np.argsort(np.argsort(luma)) + 0.5) / n_sc
        rank_latent = (np.argsort(np.argsort(
            world_rng.standard_normal(n_sc))) + 0.5) / n_sc
        imp = st.signal_alpha * rank_luma + (1.0 - st.signal_alpha) * rank_latent
        scores = np.zeros(scenes[-1][1], np.float32)
        for (start, end), w in zip(scenes, imp):
            scores[start:end] = w
        ids.append(vid)
        frame_scores.append(scores)
        scene_lists.append(scenes)
    return video_dir, ids, frame_scores, scene_lists


def write_summe_gt(gt_dir: str, ids, frame_scores, scene_lists,
                   st: ParitySettings) -> None:
    """Per-video SumMe-format .mat files (``gt_score`` the true frame
    importance; each of ``n_users_summe`` users takes scenes in the order
    of its noisy importance until ~15% of the frames are covered, as
    SumMe's recorded binary user summaries)."""
    from scipy.io import savemat

    os.makedirs(gt_dir, exist_ok=True)
    rng = np.random.default_rng(st.seed + 77)
    for vid, gt, scenes in zip(ids, frame_scores, scene_lists):
        total = len(gt)
        users = np.zeros((total, st.n_users_summe), np.float32)
        scene_imp = np.asarray([gt[s] for (s, _) in scenes], np.float64)
        budget = 0.15 * total
        for u in range(st.n_users_summe):
            noisy = scene_imp + rng.normal(0.0, st.scene_noise,
                                           size=len(scenes))
            taken = 0.0
            for j in np.argsort(-noisy):
                start, end = scenes[j]
                if taken + (end - start) > budget and taken > 0:
                    continue
                users[start:end, u] = 1.0
                taken += end - start
        savemat(os.path.join(gt_dir, f"{vid}.mat"), {
            "gt_score": np.asarray(gt, np.float32).reshape(-1, 1),
            "user_score": users, "nFrames": total, "FPS": 30.0})


def build_world(root: str, st: ParitySettings, device: str = "cuda",
                seed: int = 0, weights: Optional[dict] = None,
                overrides=()):
    """The world and ONE shared feature cache -> (config, cache,
    annotations): the TVSum ``TVSumVideo`` list, or the SumMe GT
    directory. The encoders are the port's, from ``weights`` (state dicts
    under "visual" and "vggish") or drawn from ``seed``; the preprocess
    runs on ``device`` and skips every video already cached under the
    configuration's fingerprint. The config is the JAX harness's
    overrides, then ``overrides``."""
    from avsum_torch.cli.main import build_pipeline
    from avsum_torch.data.cache import FeatureCache
    from avsum_torch.train.config import load_config

    if st.dataset not in ("tvsum", "summe"):
        raise ValueError(f"unknown dataset {st.dataset!r}")
    video_dir, ids, frame_scores, scene_lists = write_world_media(root, st)
    anno_path = (os.path.join(root, "ydata.mat") if st.dataset == "tvsum"
                 else os.path.join(root, "GT"))
    cfg = load_config(overrides=WORLD_SETS + [
        f"data.dataset={st.dataset}",
        f"data.annotation_path={anno_path}",
        f"data.cache_dir={root}/cache",
        f"model.hidden_dim={st.hidden_dim}",
        f"train.epochs={st.epochs}",
    ] + list(overrides))
    if st.dataset == "tvsum":
        scores = tvsum_user_scores(frame_scores, seed=st.seed,
                                   scene_lists=scene_lists,
                                   scene_noise=st.scene_noise)
        anno = tvsum_videos(ids, scores)
        if h5py_available():
            write_tvsum_mat(anno_path, ids, scores)
    else:
        anno = anno_path
        write_summe_gt(anno, ids, frame_scores, scene_lists, st)
    cache = FeatureCache(cfg.data.cache_dir)
    pipeline, _ = build_pipeline(cfg, device, seed, weights,
                                 with_scorer=False)
    pipeline.preprocess_dataset(video_dir, cache)
    return cfg, cache, anno


# ---------------------------------------------------------------------------
# Evaluation and training
# ---------------------------------------------------------------------------


def evaluate_model(score_fn, test_examples, canon_fn):
    """One protocol for every contender: the dataset's canonical knapsack
    F1 (``canon_fn``) and the reference's keyframe metrics on the shot
    targets -> (fold means, {video id: canonical F1}), the latter for the
    paired deltas."""
    from avsum_torch.summary.metrics import evaluate_scores

    canon, keyframe = {}, []
    for ex in test_examples:
        preds = np.asarray(score_fn(ex), np.float32)[: ex.n_shots]
        canon[ex.video_id] = float(canon_fn(ex, preds))
        keyframe.append(evaluate_scores(preds, ex.targets))
    vals = list(canon.values())
    out = {
        "canonical_f1": float(np.mean(vals)),
        "f1": float(np.mean([k["f1"] for k in keyframe])),
        "spearman": float(np.mean([k["spearman"] for k in keyframe])),
        "kendall": float(np.mean([k["kendall"] for k in keyframe])),
    }
    return out, canon


def train_avsum(cfg, train_examples, temporal_encoder: str, max_shots: int,
                ckpt_dir: str, seed: int = 0, ema_decay: float = 0.0,
                device: str = "cuda"):
    """The port's AVScorer trained by its ``Trainer`` on ``device`` over
    the shared examples (weights drawn from ``seed``, as ``train``
    draws them from ``train.seed``)."""
    from avsum_torch.data.batching import batch_iterator
    from avsum_torch.models.scorer import make_model
    from avsum_torch.train.config import load_config
    from avsum_torch.train.trainer import Trainer

    fold_cfg = load_config(overrides=[
        f"model.temporal_encoder={temporal_encoder}",
        f"model.hidden_dim={cfg.model.hidden_dim}",
        f"data.max_shots={max_shots}",
        f"train.epochs={cfg.train.epochs}",
        f"train.checkpoint_dir={ckpt_dir}",
        f"train.seed={seed}",
        f"train.ema_decay={ema_decay}",
        "train.save_every_epochs=1000000",  # the final state only
        "visual.dtype=float32",
    ])
    trainer = Trainer(make_model(fold_cfg.model, seed=fold_cfg.train.seed),
                      fold_cfg, device=device)

    def batches(epoch=0):
        return batch_iterator(
            train_examples,
            batch_size=max(len(train_examples) // 2, 1),
            max_shots=max_shots,
            shuffle=True,
            seed=fold_cfg.train.seed + epoch,
        )

    trainer.fit(batches, epochs=fold_cfg.train.epochs)
    return trainer


def _examples(st: ParitySettings, cache, anno):
    """({video id: example}, canonical F1 of (example, predictions))."""
    from avsum_torch.data.datasets import load_summe_examples, tvsum_examples
    from avsum_torch.data.summe import load_summe_dir
    from avsum_torch.data.tvsum import tvsum_index
    from avsum_torch.summary.protocol import (
        canonical_f1_summe,
        canonical_f1_tvsum,
    )

    if st.dataset == "tvsum":
        examples = {ex.video_id: ex for ex in tvsum_examples(cache, anno)}
        index = tvsum_index(anno)

        def canon_fn(ex, preds):
            return canonical_f1_tvsum(preds, ex.shot_boundaries, ex.n_frames,
                                      index[ex.video_id].user_scores, 0.15)
    else:
        examples = {ex.video_id: ex
                    for ex in load_summe_examples(cache, anno)}
        gt = {v.video_id: v for v in load_summe_dir(anno)}

        def canon_fn(ex, preds):
            return canonical_f1_summe(preds, ex.shot_boundaries, ex.n_frames,
                                      gt[ex.video_id].user_score, 0.15)
    return examples, canon_fn


def run_parity(root: str, st: ParitySettings, report_cb=None,
               seed_indices=None, variants=("bilstm", "attention"),
               device: str = "cuda", encoder_seed: int = 0,
               weights: Optional[dict] = None, overrides=(),
               info: Optional[dict] = None) -> Optional[dict]:
    """The parity run over the world in ``root`` -> the report's result
    for the complete seeds (None before the first). ``variants``: the
    port's contenders that train (the reference always does: it is the
    pairing arm); a limited run keeps every key in progress.json, so it
    extends, never drops, what a full run restored. ``info``, when
    given, receives where each arm ran and K1's launches during the
    world's preprocess."""
    import torch

    from avsum_torch.data.splits import create_kfold_splits

    t0 = time.time()
    k1 = launches("melspec")["melspec"]
    cfg, cache, anno = build_world(root, st, device, encoder_seed, weights,
                                   overrides)
    arms = {"reference": "cpu", "contenders": device, "card": card(device),
            "world_s": round(time.time() - t0, 1),
            "world_launches": {"melspec": launches("melspec")["melspec"]
                               - k1}}
    if info is not None:
        info.update(arms)
    log(f"{st.dataset} world in {arms['world_s']} s; K1 launches "
        f"{arms['world_launches']['melspec']}")
    examples, canon_fn = _examples(st, cache, anno)

    max_shots = 1
    while max_shots < max(ex.n_shots for ex in examples.values()):
        max_shots *= 2

    folds = create_kfold_splits(sorted(examples), st.n_folds, seed=st.seed)
    # fold_means[key][s]: fold-mean dicts; video_f1[key][s][video id]
    fold_means = {k: [[] for _ in range(st.n_seeds)] for k in KEYS}
    video_f1 = {k: [{} for _ in range(st.n_seeds)] for k in KEYS}
    vids = sorted(examples)
    # resume: every cell is a function of (settings, s, fold) on this
    # world, so the cells of a progress.json with the same settings are
    # what this process would compute
    progress_path = os.path.join(root, "progress.json")
    done_cells = set()
    n_prefix = 0
    if os.path.exists(progress_path):
        with open(progress_path) as fh:
            prev = json.load(fh)
        if (prev.get("settings") == dataclasses.asdict(st)
                and "fold_means" in prev):
            if "cells" in prev:
                done_cells = {(ss, ff) for ss, ff in prev["cells"]}
            else:
                pf, ps = prev["done_through"]
                done_cells = {
                    (ss, ff)
                    for ss in range(ps + 1)
                    for ff in range(len(folds))
                    if ss < ps or ff <= pf
                }
            for k in KEYS:
                for ss in range(st.n_seeds):
                    fold_means[k][ss] = list(prev["fold_means"][k][ss])
                    video_f1[k][ss] = dict(prev["video_f1"][k][ss])
            log(f"resuming: {len(done_cells)}/{st.n_seeds * len(folds)} "
                "cells restored from progress.json")
        elif "settings" in prev:
            log("progress.json settings mismatch: starting fresh")
    # seeds outermost: each finished seed is a complete n-fold result
    for s in (range(st.n_seeds) if seed_indices is None else seed_indices):
        for f_idx, fold in enumerate(folds):
            if (s, f_idx) in done_cells:
                continue
            tc = time.time()
            train_ex = [examples[v] for v in fold["train"]]
            test_ex = [examples[v] for v in fold["test"]]
            dv = train_ex[0].visual.shape[-1]
            da = train_ex[0].audio.shape[-1]
            run_seed = st.seed + 1000 * s + f_idx
            torch.manual_seed(run_seed)  # the model's init, and the loop's
            ref = build_reference_model(dv, da, st.hidden_dim)
            train_reference_model(ref, train_ex, epochs=st.epochs,
                                  seed=run_seed)
            mean, per_vid = evaluate_model(
                lambda ex: score_with_reference(ref, ex), test_ex, canon_fn)
            fold_means["reference_torch_bilstm"][s].append(mean)
            video_f1["reference_torch_bilstm"][s].update(per_vid)
            t_ref = time.time() - tc

            trained_keys = ["reference_torch_bilstm"]
            for encoder, key in (("bilstm", "avsum_bilstm"),
                                 ("attention", "avsum_attention")):
                if encoder not in variants:
                    continue
                trained_keys.append(key)
                trainer = train_avsum(
                    cfg, train_ex, encoder, max_shots,
                    os.path.join(root, f"ckpt_{encoder}_f{f_idx}_s{s}"),
                    seed=run_seed, ema_decay=st.ema_decay, device=device)
                mean, per_vid = evaluate_model(
                    lambda ex: trainer.score_video(ex, max_shots), test_ex,
                    canon_fn)
                fold_means[key][s].append(mean)
                video_f1[key][s].update(per_vid)
            log(f"fold {f_idx} seed {s}: " + " ".join(
                f"{k}={fold_means[k][s][-1]['canonical_f1']:.4f}"
                for k in trained_keys)
                + f" ({time.time() - tc:.1f} s, the reference {t_ref:.1f} s)")
            # the raw per-video numbers after every cell
            done_cells.add((s, f_idx))
            tmp_path = progress_path + ".tmp"
            with open(tmp_path, "w") as fh:
                json.dump({
                    "done_through": [f_idx, s],
                    "cells": sorted(done_cells),
                    "settings": dataclasses.asdict(st),
                    "video_f1": video_f1,
                    "fold_means": fold_means,
                    "fold_canonical": {
                        k: [[m["canonical_f1"] for m in fold_means[k][ss]]
                            for ss in range(st.n_seeds)]
                        for k in KEYS
                    },
                    "arms": {k: arms[k] for k in ("reference", "contenders",
                                                  "card")},
                }, fh)
            os.replace(tmp_path, progress_path)
        # complete seeds that form a prefix of 0..n_seeds-1 are a valid
        # n-seed result; a seed subset is reported by parity-merge
        n_prefix = 0
        while n_prefix < st.n_seeds and all(
                (n_prefix, ff) in done_cells for ff in range(len(folds))):
            n_prefix += 1
        if report_cb is not None and n_prefix > 0:
            report_cb(_summarize(st, n_prefix, fold_means, video_f1, vids,
                                 t0))

    if n_prefix == 0:
        return None
    return _summarize(st, n_prefix, fold_means, video_f1, vids, t0)


# ---------------------------------------------------------------------------
# Statistics and verdicts (the JAX harness's arithmetic)
# ---------------------------------------------------------------------------


def _summarize(st, n_done, fold_means, video_f1, vids, t0) -> dict:
    """Statistics over the first ``n_done`` complete seeds."""
    from scipy import stats as sps

    # a variants-limited run leaves untrained contenders without folds
    keys = tuple(
        k for k in fold_means
        if all(len(fold_means[k][s]) > 0 for s in range(n_done))
    )
    result = {
        "settings": dataclasses.asdict(st),
        "dataset": st.dataset,
        "seeds_done": n_done,
        "protocol": (
            "synthetic TVSum, canonical per-annotator knapsack F1 "
            "(mean over 20 users)"
            if st.dataset == "tvsum"
            else "synthetic SumMe, canonical knapsack F1 "
            f"(max over {st.n_users_summe} user summaries)"
        )
        + f", {st.n_folds}-fold CV x {n_done} seeds, "
        f"paired per-video deltas; avsum EMA decay {st.ema_decay}; "
        f"world hardness: signal_alpha={st.signal_alpha}, "
        f"scene_noise={st.scene_noise}",
        "wall_s": round(time.time() - t0, 1),
        "models": {},
    }
    # per-video F1 averaged over seeds: one vector a model over the
    # held-out videos (each video is tested in exactly one fold)
    seed_avg = {
        k: np.asarray([np.mean([video_f1[k][s][v] for s in range(n_done)])
                       for v in vids])
        for k in keys
    }
    for key in keys:
        per_seed_means = [
            float(np.mean([f["canonical_f1"] for f in fold_means[key][s]]))
            for s in range(n_done)
        ]
        result["models"][key] = {
            m: float(np.mean([f[m] for s in range(n_done)
                              for f in fold_means[key][s]]))
            for m in fold_means[key][0][0]
        }
        result["models"][key]["per_seed_canonical_f1"] = [
            round(v, 4) for v in per_seed_means
        ]
        result["models"][key]["seed_std_pts"] = round(
            100.0 * float(np.std(per_seed_means)), 2
        )
    ref_vec = seed_avg["reference_torch_bilstm"]
    ref_f1 = result["models"]["reference_torch_bilstm"]["canonical_f1"]
    for key in ("avsum_bilstm", "avsum_attention"):
        if key not in keys:
            continue
        # paired: both contenders scored the same videos with the same
        # seeds, so the per-video deltas cancel a video's difficulty
        diffs = seed_avg[key] - ref_vec
        se = float(np.std(diffs, ddof=1) / np.sqrt(len(diffs)))
        r = result["models"][key]
        r["delta_canonical_f1_pts"] = round(
            100.0 * (r["canonical_f1"] - ref_f1), 2
        )
        r["paired_delta_pts"] = round(100.0 * float(np.mean(diffs)), 2)
        r["paired_se_pts"] = round(100.0 * se, 2)
        r["paired_ci95_pts"] = [
            round(100.0 * (float(np.mean(diffs)) - 1.96 * se), 2),
            round(100.0 * (float(np.mean(diffs)) + 1.96 * se), 2),
        ]
        # the knapsack F1 is discrete a video: a small score change can
        # flip between near-equal disjoint packings (PARITY_PROCEDURE.md
        # §6.2), which bounds the video-level CI at a fixed n_videos
        per_seed_delta = [
            100.0 * float(np.mean(
                [video_f1[key][s][v] - video_f1["reference_torch_bilstm"][s][v]
                 for v in vids]
            ))
            for s in range(n_done)
        ]
        r["per_seed_paired_delta_pts"] = [round(d, 2) for d in per_seed_delta]
        # the seed-level paired t CI, the decision statistic: each seed's
        # delta averages over every video (fully crossed), so the
        # independent training seeds are the replications
        dseed = np.asarray(per_seed_delta, np.float64)
        if len(dseed) > 1:
            se_seed = float(dseed.std(ddof=1) / np.sqrt(len(dseed)))
            tcrit = float(sps.t.ppf(0.975, len(dseed) - 1))
        else:
            se_seed, tcrit = float("nan"), float("inf")
        r["seed_paired_se_pts"] = round(se_seed, 2)
        r["seed_paired_ci95_pts"] = [
            round(float(dseed.mean()) - tcrit * se_seed, 2),
            round(float(dseed.mean()) + tcrit * se_seed, 2),
        ]
        davg = 100.0 * diffs
        r["videos_abs_delta_gt10"] = int((np.abs(davg) > 10.0).sum())
        sd = float(np.std(davg, ddof=1))
        r["videos_needed_for_ci2pts"] = int(np.ceil((1.96 * sd / 2.0) ** 2))
        # one-sided noninferiority: P(mean paired delta >= -0.5) under a
        # 10k-resample paired bootstrap of the seed-averaged deltas
        rng = np.random.default_rng(0)
        boot = rng.choice(davg, size=(10_000, len(davg)), replace=True)
        r["p_noninferior_bootstrap"] = round(
            float((boot.mean(axis=1) >= -0.5).mean()), 4
        )
    return result


def _model_verdict(r: dict) -> str:
    """PARITY_PROCEDURE.md §7.8 on the seed-level paired t CI
    (``seed_paired_ci95_pts``; the video-level one when absent):

    - PASS: the CI's lower bound clears the -0.5 pt margin (standard
      noninferiority), or the paired delta is >= -0.5 with a half-width
      <= 2 pts;
    - FAIL-POWER: a noninferior point estimate, the CI too wide;
    - FAIL-INFERIOR: the paired delta itself is below -0.5 pts.
    """
    ci = r.get("seed_paired_ci95_pts") or r["paired_ci95_pts"]
    half_width = (ci[1] - ci[0]) / 2.0
    if r["paired_delta_pts"] < -0.5:
        return "FAIL-INFERIOR"
    if ci[0] >= -0.5:
        return "PASS"
    return "PASS" if half_width <= 2.0 else "FAIL-POWER"


def _dataset_verdict(models: dict) -> str:
    vs = [_model_verdict(models[k])
          for k in ("avsum_bilstm", "avsum_attention") if k in models]
    if any(v == "FAIL-INFERIOR" for v in vs):
        return "FAIL-INFERIOR"
    if any(v == "FAIL-POWER" for v in vs):
        return "FAIL-POWER"
    return "PASS"


def _verdict_line(m: dict) -> str:
    return ("; ".join(f"{k} {_model_verdict(m[k])}"
                      for k in ("avsum_bilstm", "avsum_attention")
                      if "paired_delta_pts" in m.get(k, {}))
            or _dataset_verdict(m))


def _arms_sentence(arms: Optional[dict]) -> str:
    if not arms:
        return ("Where the port's contenders ran is not recorded in the "
                "progress data this report was assembled from.")
    where = arms.get("contenders", "cuda")
    if arms.get("card"):
        where = f"{where} ({arms['card']})"
    return (f"The reference arm trained and scored on the CPU in float32; "
            f"the port's contenders trained and scored on {where} with "
            "TF32 off.")


def write_reports(results, out_dir: str, arms: Optional[dict] = None
                  ) -> None:
    """``PARITY_F1_TORCH.{json,md}`` in ``out_dir`` from one
    :func:`run_parity` result or a list of them (one a dataset). ``arms``:
    where each arm ran (``run_parity``'s ``info``)."""
    if isinstance(results, dict):
        results = [results]
    os.makedirs(out_dir, exist_ok=True)
    payload = results[0] if len(results) == 1 else {
        "datasets": {r["dataset"]: r for r in results}
    }
    with open(os.path.join(out_dir, f"{REPORT}.json"), "w") as fh:
        json.dump(payload, fh, indent=1)

    lines = [
        f"# {REPORT}: measured F1 parity of the PyTorch port against the "
        "reference as re-run",
        "",
        "Produced by `python -m avsum_torch.bench parity` "
        "(`avsum_torch/bench/parity.py`; its docstring gives the protocol). "
        "The reference side is its model and training recipe run in torch "
        "(av_model.py:6-46, train_av_model.py:64-96) on the SAME cached "
        "features, targets, splits and evaluation code as the port's "
        "AVScorer contenders. " + _arms_sentence(arms),
    ]
    verdicts = []
    for result in results:
        m = result["models"]
        lines += [
            "",
            f"## {result.get('dataset', 'tvsum')}",
            "",
            f"Protocol: {result['protocol']}; "
            f"settings: {result['settings']}",
            "",
            f"Seeds run: 0-{result['seeds_done'] - 1} (each cell's "
            "run_seed = seed + 1000 x seed index + fold).",
            "",
            "| model | canonical F1 | paired Δ (pts) | seed-level 95% CI "
            "| video-level 95% CI | seed σ (pts) | keyframe F1 | ρ | τ |",
            "|---|---|---|---|---|---|---|---|---|",
        ]
        for key, r in m.items():
            delta = r.get("paired_delta_pts", "—")
            sci = r.get("seed_paired_ci95_pts")
            sci_s = f"[{sci[0]}, {sci[1]}]" if sci else "—"
            ci = r.get("paired_ci95_pts")
            ci_s = f"[{ci[0]}, {ci[1]}]" if ci else "—"
            lines.append(
                f"| {key} | {r['canonical_f1']:.4f} | {delta} | {sci_s} | "
                f"{ci_s} | {r.get('seed_std_pts', '—')} | "
                f"{r['f1']:.4f} | {r['spearman']:.4f} | {r['kendall']:.4f} |"
            )
        for key in ("avsum_bilstm", "avsum_attention"):
            if key not in m or "per_seed_paired_delta_pts" not in m[key]:
                continue
            r = m[key]
            lines += [
                "",
                f"`{key}` paired-delta diagnostics: per-seed overall Δ = "
                f"{r['per_seed_paired_delta_pts']} pts; "
                f"{r['videos_abs_delta_gt10']}/"
                f"{result['settings']['n_videos']} videos with |Δ|>10 pts "
                "(knapsack packing flips, both directions); CI ≤ ±2 pts "
                f"would need ~{r['videos_needed_for_ci2pts']} videos at "
                "this per-video σ; bootstrap P(mean Δ ≥ −0.5) = "
                f"{r['p_noninferior_bootstrap']}.",
            ]
        if result.get("merge_note"):
            lines += ["", f"Merge provenance: {result['merge_note']}."]
        xh = result.get("cross_host_reproduction")
        if xh:
            parts = []
            for s, mm in xh["drift_by_seed"].items():
                bits = []
                for k, v in mm.items():
                    if "abs_diff_pts" in v:
                        bits.append(f"{k} F1 {v['abs_diff_pts']} pts")
                    if "paired_delta" in v:
                        bits.append(
                            f"{k} δ {v['paired_delta']['abs_diff_pts']} pts")
                parts.append(f"seed {s}: " + ", ".join(bits))
            drifted = sorted({k for mm in xh["drift_by_seed"].values()
                              for k in mm})
            exact = sorted(set(m) - set(drifted))
            lines += [
                "",
                f"Cross-host reproduction probe ({xh['reason']}): "
                f"{'; '.join(parts)}. "
                + (f"Bit-exact cross-host reproduction held for "
                   f"{', '.join(exact)}; " if exact else "")
                + f"{', '.join(drifted)} shifted with the host "
                "(a CPU's matmul reduction order depends on the host, and "
                "the drifted contenders' recorded deltas are above). "
                "Paired deltas are computed within one host a seed, so "
                "host effects cancel inside each replication.",
            ]
        verdicts.append(_verdict_line(m))
    lines += [
        "",
        "Paired Δ = mean over held-out videos of (avsum − reference) "
        "canonical F1, seed-averaged; both contenders score the SAME videos "
        "with the SAME seeds, so video difficulty cancels. Seed σ = spread "
        "of a model's overall F1 across independent init/training seeds "
        "(the noise floor).",
        "",
        "Two CIs, two questions. The **seed-level** paired t CI takes the "
        "fixed, fully crossed video set as given and the independent "
        "training seeds as the replications; it is the acceptance "
        "statistic. The **video-level** CI also treats the videos as "
        "sampled (parity on videos this study never saw) and is bounded "
        "by the knapsack metric's discreteness (the diagnostics lines give "
        "the n_videos it would need); it stays as a generalization "
        "diagnostic.",
        "",
        "Acceptance (seed-level 95% CI lower bound ≥ −0.5 pts — standard "
        "noninferiority at that margin — or paired Δ ≥ −0.5 pts with CI "
        "half-width ≤ 2 pts, PARITY_PROCEDURE.md §7.8): "
        + (verdicts[0] if len(results) == 1 else ", ".join(
            f"{r.get('dataset', 'tvsum')}: {v}"
            for r, v in zip(results, verdicts))),
        "",
        "FAIL-POWER means the point estimate is noninferior but the "
        "seed-level CI half-width exceeds 2 pts: the contender's per-seed "
        "deltas spread too widely for the seeds run to pin the mean within "
        "±2 (the per-seed values are in the diagnostics lines). The "
        "mechanism is the knapsack's discreteness: near-equal disjoint "
        "packings flip on small score changes (PARITY_PROCEDURE.md §6.2).",
        "",
        "Caveats: synthetic media and seeded random encoders (the port's "
        "own draws, not the JAX package's), so the absolute F1 values are "
        "not comparable row by row with `PARITY_F1.md`; what compares is "
        "each contender's paired Δ against the reference on the same "
        "features: trainer, model and protocol parity end to end.",
    ]
    with open(os.path.join(out_dir, f"{REPORT}.md"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------


def add_arguments(ap) -> None:
    ap.add_argument("--out-dir", default=REPO,
                    help=f"where {REPORT}.{{json,md}} are written")
    ap.add_argument("--work-dir", default=None,
                    help="the worlds, caches, checkpoints and progress.json "
                         "(default: a new temporary directory)")
    ap.add_argument("--quick", action="store_true",
                    help="a small world (a smoke run, not the reportable "
                         "one)")
    ap.add_argument("--n-seeds", type=int, default=None)
    ap.add_argument("--seed-indices", default=None,
                    help="comma-separated seed indices to run; the report "
                         "is then assembled by parity-merge from "
                         "progress.json")
    ap.add_argument("--dataset", choices=("tvsum", "summe", "both"),
                    default="tvsum",
                    help="the protocol(s); 'both' writes one report")
    ap.add_argument("--variants", default="bilstm,attention",
                    help="the port's contenders that train (the reference "
                         "always does)")


def run(args) -> int:
    from avsum_torch.cli.main import _media_setup

    require_device(args.device)
    weights = _media_setup(args)
    if args.config:
        raise SystemExit("parity: the world's config is the harness's own; "
                         "use --set for an override")
    st = ParitySettings(**QUICK) if args.quick else ParitySettings()
    if args.n_seeds is not None:
        st = dataclasses.replace(st, n_seeds=args.n_seeds)
    work = args.work_dir or tempfile.mkdtemp(prefix="parity_")
    names = ("tvsum", "summe") if args.dataset == "both" else (args.dataset,)
    seed_indices = None
    if args.seed_indices is not None:
        seed_indices = [int(x) for x in args.seed_indices.split(",") if x]
    variants = tuple(v for v in args.variants.split(",") if v)
    if not set(variants) <= {"bilstm", "attention"}:
        raise SystemExit(f"--variants: unknown {variants}")
    log(f"parity: work {work}, contenders on {card(args.device) or args.device}"
        f", the reference on the CPU")
    results, infos = [], []
    for name in names:
        info: dict = {}
        result = run_parity(
            os.path.join(work, name), dataclasses.replace(st, dataset=name),
            variants=variants, device=args.device, encoder_seed=args.seed,
            weights=weights, overrides=args.overrides, info=info,
            # reports after every complete seed
            report_cb=(None if seed_indices is not None else
                       lambda r: write_reports(results + [r], args.out_dir,
                                               info)),
            seed_indices=seed_indices)
        results.append(result)
        infos.append(info)
        line = {"dataset": name, "device": args.device, "card": info["card"],
                "reference_device": "cpu",
                "world_launches": info["world_launches"]}
        if seed_indices is not None:
            emit({**line, "seed_indices": seed_indices,
                  "progress": os.path.join(work, name, "progress.json")})
            continue
        if result is None:
            raise RuntimeError(f"{name}: no seed completed")
        write_reports(results, args.out_dir, info)
        emit({**line, "seeds_done": result["seeds_done"],
              "verdict": _verdict_line(result["models"]),
              "models": result["models"],
              "report": os.path.join(args.out_dir, f"{REPORT}.json")})
    if seed_indices is not None:
        log(f"seed-subset run complete; raw data in {work}/*/progress.json: "
            "assemble the report with python -m avsum_torch.bench "
            "parity-merge")
    return 0
