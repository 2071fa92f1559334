"""Numerical-safety tools (``avsum_torch/utils/debug.py``) against the
JAX package's ``avsum_tpu/utils/debug.py``: ``tests/test_debug_bilstm.py``'s
three cases (``checked`` catches a NaN, ``assert_all_finite`` names the
bad leaves, ``debug_nans`` restores the previous state), a NaN made
inside a forward and one made inside a backward raising under
``debug_nans`` and not without it, and the trainer's ``train.debug_nans``
(JAX's trainer turns on ``jax_debug_nans``) raising on a NaN in the
forward, where without the flag the step goes on."""

import numpy as np
import pytest
import torch

from avsum_tpu.utils.debug import assert_all_finite as jax_assert_all_finite
from avsum_torch.models.scorer import make_model
from avsum_torch.train.config import load_config
from avsum_torch.train.trainer import Trainer
from avsum_torch.utils.debug import (
    assert_all_finite,
    checked,
    debug_nans,
    debug_nans_enabled,
)


def test_checked_catches_nan():
    f = checked(torch.log)
    f(torch.ones(4))  # fine
    with pytest.raises(FloatingPointError, match="nan"):
        f(-torch.ones(4))
    with pytest.raises(FloatingPointError, match=r"\['b'\]"):
        checked(lambda x: {"a": x, "b": 1 / x})(torch.zeros(2))


def test_assert_all_finite_names_paths_as_jax():
    assert_all_finite({"a": np.ones(3), "b": {"c": np.zeros(2)}})
    assert_all_finite(make_model().state_dict(), "state_dict")
    with pytest.raises(FloatingPointError, match="non-finite"):
        assert_all_finite({"a": np.array([1.0, np.nan])})
    tree = {"a": np.ones(2), "b": [np.zeros(1), {"c": np.array([np.inf])}],
            "d": (np.array([np.nan]),)}
    torch_tree = {"a": torch.ones(2),
                  "b": [torch.zeros(1), {"c": torch.tensor([np.inf])}],
                  "d": (torch.tensor([np.nan]),)}
    with pytest.raises(FloatingPointError) as want:
        jax_assert_all_finite(tree)
    for t in (tree, torch_tree):
        with pytest.raises(FloatingPointError) as got:
            assert_all_finite(t)
        assert str(got.value) == str(want.value)


def test_debug_nans_context_restores():
    prev = debug_nans_enabled()
    with debug_nans(True):
        assert debug_nans_enabled()
        with debug_nans(False):
            assert not debug_nans_enabled()
            torch.log(-torch.ones(2))  # the checks are off in here
        assert debug_nans_enabled()
    assert debug_nans_enabled() == prev


def test_debug_nans_catches_a_nan_made_in_a_forward():
    x = torch.tensor([-1.0, 1.0])
    torch.log(x)  # no check outside
    with debug_nans():
        torch.log(x.abs())
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(x)


def test_debug_nans_catches_a_nan_made_in_a_backward():
    def run():
        a = torch.zeros(3, requires_grad=True)
        (torch.sqrt(a) * 0).sum().backward()  # 0 / (2 sqrt(0)): a NaN
        return a.grad

    assert torch.isnan(run()).all()  # no check outside
    with debug_nans():
        with pytest.raises(FloatingPointError, match="NaN"):
            run()


def _nan_batch(cfg):
    rng = np.random.default_rng(0)
    b, s = 2, 8
    visual = rng.standard_normal((b, s, cfg.model.visual_dim)).astype(
        np.float32)
    visual[0, 3, 5] = np.nan
    return {"visual": visual,
            "audio": rng.standard_normal((b, s, cfg.model.audio_dim)).astype(
                np.float32),
            "targets": rng.random((b, s)).astype(np.float32),
            "mask": np.ones((b, s), np.float32)}


@pytest.mark.parametrize("flag", [False, True])
def test_trainer_debug_nans_raises_on_a_forward_nan(tmp_path, flag):
    cfg = load_config(overrides=[
        "model.visual_dim=12", "model.audio_dim=6", "model.hidden_dim=16",
        "model.num_heads=2", "model.scorer_hidden=8",
        f"train.debug_nans={str(flag).lower()}",
        f"train.checkpoint_dir={tmp_path}/ckpt"])
    trainer = Trainer(make_model(cfg.model, seed=0), cfg, device="cpu")
    batch = _nan_batch(cfg)
    try:
        if flag:
            with pytest.raises(FloatingPointError, match="NaN"):
                trainer.fit(lambda epoch: [batch], epochs=1)
        else:
            state = trainer.fit(lambda epoch: [batch], epochs=1)
            assert state.step == 1
            assert not debug_nans_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert not debug_nans_enabled()
