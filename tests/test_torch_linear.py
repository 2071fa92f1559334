"""The Linear products' wrapper (``avsum_torch/ops/linear.py``) on the CPU:
the route each product takes (kernel, cuBLAS or the plain product) from
its device, dtype, torch's float32 matmul precision and shape; the plain
version against ``F.linear``; the autograd Function's forward, dX, dW and
db, each a product in its own layout, against autograd of the plain
version (an expert routed no shot included); ``Linear`` as ``nn.Linear``
to ``state_dict``, ``fast_init_`` and tensor parallelism; and the
counters, which no CPU product moves. The kernel itself runs on the card
alone (``tests/test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from avsum_torch.init import fast_init_
from avsum_torch.models.scorer import AVScorer
from avsum_torch.ops import linear as lin
from avsum_torch.parallel.mesh import Split
from avsum_torch.parallel.tensor import ColumnLinear, jax_layouts
from avsum_torch.train.config import ModelConfig

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
F32 = torch.float32


@pytest.fixture
def precision():
    before = torch.get_float32_matmul_precision()
    yield torch.set_float32_matmul_precision
    torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("device,dtype,setting,shape,rows,want", [
    # the decoder's and the hour cell's products: the kernel
    (CUDA, F32, "highest", (7168, 3072, 2048), (True, True), "kernel"),
    (CUDA, F32, "highest", (7168, 2048, 22528), (True, False), "kernel"),
    (CUDA, F32, "highest", (512, 296, 7168), (False, False), "kernel"),
    (CUDA, F32, "highest", (672, 2816, 2048), (True, True), "kernel"),
    # an expert's ragged rows: its forward reads them by rows, so any count
    (CUDA, F32, "highest", (673, 2816, 2048), (True, True), "kernel"),
    # under "high" the user asked for cuBLAS's one-pass TF32
    (CUDA, F32, "high", (7168, 3072, 2048), (True, True), "cublas"),
    (CUDA, F32, "medium", (7168, 3072, 2048), (True, True), "cublas"),
    # shapes the rule leaves to cuBLAS: the scorer's last Linear (N = 1),
    # a summarize's 32 shots, the router's forward and dW (C a half tile
    # wide), a product below the kernel's least, rows the TMA cannot read
    (CUDA, F32, "highest", (7168, 1, 64), (True, True), "cublas"),
    (CUDA, F32, "highest", (32, 512, 1024), (True, True), "cublas"),
    (CUDA, F32, "highest", (7168, 64, 2048), (True, True), "cublas"),
    (CUDA, F32, "highest", (64, 2048, 7168), (False, False), "cublas"),
    (CUDA, F32, "highest", (7168, 2048, 64), (True, False), "kernel"),
    (CUDA, F32, "highest", (2048, 512, 512), (True, True), "cublas"),
    (CUDA, F32, "highest", (128, 2816, 2048), (True, True), "cublas"),
    (CUDA, F32, "highest", (256, 2816, 2048), (True, True), "kernel"),
    (CUDA, F32, "highest", (7168, 512, 298), (True, True), "cublas"),
    (CUDA, F32, "highest", (7168, 510, 512), (True, True), "cublas"),
    (CUDA, F32, "highest", (510, 512, 7168), (False, False), "cublas"),
    # not a CUDA float32 product, or an empty one: the plain product
    (CUDA, torch.bfloat16, "highest", (7168, 3072, 2048), (True, True),
     "plain"),
    (CUDA, None, "highest", (7168, 3072, 2048), (True, True), "plain"),
    (CPU, F32, "highest", (7168, 3072, 2048), (True, True), "plain"),
    (CUDA, F32, "highest", (0, 2816, 2048), (True, True), "plain"),
    (CUDA, F32, "highest", (2816, 2048, 0), (False, False), "plain"),
])
def test_route(precision, device, dtype, setting, shape, rows, want):
    precision(setting)
    assert lin.route(device, dtype, *shape, *rows) == want


def _case(seed, m=9, k=12, n=8, bias=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return x, w, b if bias else None


def _grads(fn, *args):
    args = [a.clone().requires_grad_() if a is not None else None
            for a in args]
    y = fn(*args)
    cot = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
    y.backward(cot)
    return y.detach(), [a.grad if a is not None else None for a in args]


@pytest.mark.parametrize("bias", [True, False])
def test_linear_plain_matches_f_linear(bias):
    x, w, b = _case(0, bias=bias)
    y, grads = _grads(lin.linear_plain, x, w, b)
    y_ref, grads_ref = _grads(F.linear, x, w, b)
    torch.testing.assert_close(y, y_ref, rtol=1e-6, atol=1e-6)
    for g, g_ref in zip(grads, grads_ref):
        if g_ref is not None:
            torch.testing.assert_close(g, g_ref, rtol=1e-6, atol=1e-5)
    assert lin.linear(x, w, b).shape == (2, 9, 8)


@pytest.mark.parametrize("rows", [9, 0])
@pytest.mark.parametrize("bias", [True, False])
def test_linear_function_matches_autograd_of_plain(bias, rows):
    """Forward, dX (dY by rows, W by columns), dW (both by columns) and db
    of the autograd Function, its products on the CPU, against autograd of
    the plain version; at 0 rows (a held expert routed no shot) dW and db
    are zeros."""
    x, w, b = _case(1, m=rows, bias=bias)
    x = x[0]

    def fn(x, w, b):
        return lin.LinearFunction.apply(x, w, b)

    y, grads = _grads(fn, x, w, b)
    y_ref, grads_ref = _grads(lin.linear_plain, x, w, b)
    assert y.shape == (rows, 8)
    torch.testing.assert_close(y, y_ref, rtol=1e-6, atol=1e-6)
    for g, g_ref in zip(grads, grads_ref):
        if g_ref is not None:
            torch.testing.assert_close(g, g_ref, rtol=1e-6, atol=1e-5)
    if rows == 0:
        assert not grads[1].any()


@pytest.mark.parametrize("a_rows,b_rows", [(True, True), (True, False),
                                           (False, False)])
def test_product_reads_each_layout(a_rows, b_rows):
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    got = lin.product(a if a_rows else a.t().contiguous(), b
                      if b_rows else b.t().contiguous(), a_rows, b_rows)
    torch.testing.assert_close(got, a @ b.t(), rtol=1e-6, atol=1e-6)


def test_plan_splits_keeps_parts_long_enough():
    for m, n, k in [(512, 512, 7168), (64, 2048, 7168), (128, 128, 300)]:
        s = lin.plan_splits(m, n, k, 132)
        assert s == 1 or -(-k // lin.TILE_K) // s >= lin.MIN_SPLIT_K_TILES


def test_linear_is_nn_linear_to_state_dict_init_and_tp():
    ours, torchs = lin.Linear(12, 8), nn.Linear(12, 8)
    assert isinstance(ours, nn.Linear)
    assert list(ours.state_dict()) == list(torchs.state_dict())
    fast_init_(ours, seed=3)
    fast_init_(torchs, seed=3)
    torch.testing.assert_close(ours.weight, torchs.weight)
    assert not ours.bias.any()

    class Mesh:  # the model axis of two ranks, as ColumnLinear asks it
        def size(self, axis):
            return 2

    col = ColumnLinear(ours, Mesh(), Split(0), split_bias=False)
    assert tuple(col.weight.shape) == (4, 12)
    assert col.bias.shape == ours.bias.shape


def test_scorer_linears_are_routed_and_laid_out_as_before():
    cfg = ModelConfig(visual_dim=12, audio_dim=8, hidden_dim=16,
                      num_heads=2, scorer_hidden=8, dropout=0.0)
    model = AVScorer(cfg)
    names = {n for n, m in model.named_modules() if isinstance(m, lin.Linear)}
    assert {"visual_fc.dense", "scorer_hidden", "scorer_out",
            "visual_temporal.blocks.0.attention.qkv",
            "visual_temporal.blocks.0.dense_0", "cross_attention.out"} <= names
    layouts = jax_layouts(model)
    for name in names:
        mod = model.get_submodule(name)
        if f"{name}.weight" in layouts and "attention" not in name:
            assert layouts[f"{name}.weight"][0] == (mod.in_features,
                                                    mod.out_features)


def test_counters_stay_at_zero_on_the_cpu():
    cfg = ModelConfig(visual_dim=12, audio_dim=8, hidden_dim=16,
                      num_heads=2, scorer_hidden=8, dropout=0.0)
    model = AVScorer(cfg)
    before = (lin.linear.launches, lin.linear.bypassed)
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.standard_normal((1, 6, 12)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((1, 6, 8)).astype(np.float32))
    model(v, a, torch.ones(1, 6)).sum().backward()
    assert (lin.linear.launches, lin.linear.bypassed) == before
