"""The port's ternary matmul (K11's plain version and ``ops`` dispatch) and
ternary quantizer against the JAX package on the same numpy inputs, on the
CPU.

On the CPU ``ops.ternary_matmul`` runs the plain version; chip_smoke.py
holds the CUDA kernel against it on the card. The JAX side runs the Pallas
kernel in interpret mode (``ops.ternary_matmul``) and its jnp oracle.
Bounds:

* matmul, fp32 x: within 1e-6 of the output's max, the JAX test's own
  bound (tests/test_kernels_ternary.py); bf16 x: one bf16 rounding of each
  element (2^-7 relative, where the two fp32 sums straddle a rounding
  boundary) plus that 1e-6;
* quantizer: codes identical, except where |w| lies within 1e-6 relative
  of the threshold Δ (torch and XLA sum the mean |w| in other orders);
  scales within 1e-6 relative in every column with identical codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.quant import ternary as jtern
from repro_torch import bridge
from repro_torch.kernels import coded_gemm, ops, ref
from repro_torch.kernels import ternary_matmul as k11
from repro_torch.quant import ternary as ttern


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This file's ops are far below any parallel grain, but on a loaded
    host (the suite's parallel workers) idle intra-op threads cost it
    several times its run time: one torch thread while it runs, the
    worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# tests/test_kernels_ternary.py's shapes, and the smoke classifier's
SHAPES = [(8, 512, 128), (128, 512, 128), (64, 1024, 256), (100, 300, 50),
          (1, 512, 128), (256, 128, 384), (3, 192, 10)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_RTOL = 2.0 ** -7
FC = lambda n, x: x.ndim == 2 and "fc" in n            # noqa: E731


def _inputs(seed, m, k, n, binary=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jtw = (jtern.binarize if binary else jtern.ternarize)(jnp.asarray(w))
    return x, jtw, bridge.ternary_from_numpy(
        np.asarray(jtw.q), np.asarray(jtw.scale), device="cpu")


def _close(got: torch.Tensor, want, rtol=0.0):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    bound = 1e-6 * max(float(np.abs(want).max()), 1e-6) + rtol * np.abs(want)
    err = np.abs(got - want)
    assert got.shape == want.shape
    assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_matmul_matches_jax(m, k, n, dt):
    """The plain version and ``ops.ternary_matmul`` on the CPU against the
    Pallas kernel (interpret mode) and the jnp oracle."""
    jdt, tdt = DTYPES[dt]
    x, jtw, ttw = _inputs(m * 31 + n, m, k, n)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(tdt)
    rtol = BF16_RTOL if dt == "bf16" else 0.0
    want_kernel = jops.ternary_matmul(jx, jtw)
    want_oracle = jref.ternary_matmul_ref(jx, jtw.q, jtw.scale)
    got_ref = ref.ternary_matmul_ref(tx, ttw.q, ttw.scale)
    got_ops = ops.ternary_matmul(tx, ttw)
    assert got_ref.dtype == got_ops.dtype == tdt
    assert torch.equal(got_ref, got_ops)
    for want in (want_kernel, want_oracle):
        _close(got_ops, want, rtol)


def test_leading_batch_dims():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    jtw = jtern.ternarize(jnp.asarray(w))
    ttw = bridge.ternary_from_numpy(np.asarray(jtw.q), np.asarray(jtw.scale),
                                    device="cpu")
    got = ops.ternary_matmul(torch.from_numpy(x), ttw)
    assert got.shape == (2, 3, 64)
    _close(got, jops.ternary_matmul(jnp.asarray(x), jtw))


def test_binary_weights():
    x, jtw, ttw = _inputs(6, 16, 512, 128, binary=True)
    assert int((ttw.q == 0).sum()) == 0              # binary: no zeros
    _close(ops.ternary_matmul(torch.from_numpy(x), ttw),
           jops.ternary_matmul(jnp.asarray(x), jtw))


def test_dense_bias():
    x, jtw, ttw = _inputs(7, 8, 256, 32)
    b = np.random.default_rng(8).standard_normal(32).astype(np.float32)
    _close(ops.ternary_dense(torch.from_numpy(x), ttw, torch.from_numpy(b)),
           jops.ternary_dense(jnp.asarray(x), jtw, bias=jnp.asarray(b)))
    _close(ops.ternary_dense(torch.from_numpy(x), ttw),
           jops.ternary_dense(jnp.asarray(x), jtw))


def test_split_rows_cover_k():
    """The wrapper's K splits, both routes: every row of K in exactly one
    split. M <= 8 (``split_rows``): at most 64 splits, and no more than
    K has 64-row parts. M > 8 (``coded_gemm.plan``): whole 64-row stages, at most
    64 splits, each at least 4 stages long (or one), and the grid within
    one wave of 132 SMs whenever the output tiles alone leave SMs idle."""
    for m in (1, 3, 8, 9, 64, 256):
        for k in (1, 15, 192, 300, 2048, 9216, 25088):
            for n in (10, 1000, 4096):
                if k11.route(m) == "gemv":
                    rows = k11.split_rows(k, n, 132)
                    splits = -(-k // rows)
                    assert 1 <= rows and (splits - 1) * rows < k <= splits * rows
                    assert splits <= min(64, -(-k // 64))
                    continue
                splits = coded_gemm.plan(m, n, k, 132)
                spans = [coded_gemm.split_stages(k, splits, z)
                         for z in range(splits)]
                rows = [r for lo, hi in spans
                        for r in range(64 * lo, min(64 * hi, k))]
                assert rows == list(range(k))
                assert 1 <= splits <= 64
                assert splits == 1 or min(hi - lo for lo, hi in spans) >= 4
                tiles = coded_gemm.tiles(m, n)
                assert splits == 1 or tiles * splits <= 132


def test_wrapper_refuses_cpu_tensors():
    """K11's wrapper takes CUDA tensors only: a CPU tensor raises before
    anything is built or launched."""
    before = k11.ternary_matmul.launches
    with pytest.raises(ValueError, match="CUDA"):
        k11.ternary_matmul(torch.zeros((1, 16)),
                           torch.zeros((16, 4), dtype=torch.int8),
                           torch.ones(4))
    assert k11.ternary_matmul.launches == before


class _NoKernelDevice(torch.Tensor):
    """A CPU tensor that reports a device the port has no kernel for."""

    @property
    def device(self):
        return torch.device("xpu")


def test_ops_dispatch_on_device_not_on_availability(monkeypatch):
    """``ops.ternary_matmul`` goes by the tensor's device: with a card
    reported present, a CPU tensor still takes the plain version; a device
    with no kernel raises; meta tensors (the dry-run's shapes) get an
    empty meta output of the kernel's shape and dtype."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    x, _, ttw = _inputs(9, 4, 64, 16)
    got = ops.ternary_matmul(torch.from_numpy(x), ttw)
    assert torch.equal(got, ref.ternary_matmul_ref(torch.from_numpy(x),
                                                   ttw.q, ttw.scale))
    with pytest.raises(ValueError, match="no kernel"):
        ops.ternary_matmul(torch.empty((4, 64)).as_subclass(_NoKernelDevice),
                           ttw)
    meta = ttern.TernaryWeight(ttw.q.to("meta"), ttw.scale.to("meta"))
    out = ops.ternary_matmul(torch.empty((4, 64), device="meta"), meta)
    assert out.is_meta and out.shape == (4, 16)


# -- the quantizer ------------------------------------------------------------

def _near_threshold(w: np.ndarray, threshold_scale=0.7) -> np.ndarray:
    """|w| within 1e-6 relative of Δ, computed in float64."""
    a = np.abs(w.astype(np.float64))
    red = tuple(range(w.ndim - 1))
    delta = threshold_scale * (a.mean(axis=red, keepdims=True) if red else a)
    return np.abs(a - delta) <= 1e-6 * delta


def _assert_same_quant(t: ttern.TernaryWeight, j, w: np.ndarray,
                       near=None):
    tq, jq = t.q.numpy(), np.asarray(j.q)
    assert t.q.dtype == torch.int8 and t.scale.dtype == torch.float32
    assert tq.shape == jq.shape and t.scale.shape == j.scale.shape
    differ = tq != jq
    assert not (differ & ~near).any() if near is not None else \
        not differ.any()
    cols = ~differ.reshape(-1, tq.shape[-1]).any(0) if tq.ndim else True
    ts, js = t.scale.numpy(), np.asarray(j.scale)
    np.testing.assert_allclose(ts[cols], js[cols], rtol=1e-6, atol=0)


WEIGHTS = [(512, 128), (300, 50), (3, 3, 16, 32), (11, 11, 3, 64), (17,)]


@pytest.mark.parametrize("shape", WEIGHTS, ids=str)
def test_ternarize_matches_jax(shape):
    w = np.random.default_rng(len(shape) * 97 + shape[-1]).standard_normal(
        shape).astype(np.float32)
    t = ttern.ternarize(torch.from_numpy(w))
    j = jtern.ternarize(jnp.asarray(w))
    _assert_same_quant(t, j, w, near=_near_threshold(w))
    assert abs(ttern.quant_error(torch.from_numpy(w), t)
               - jtern.quant_error(jnp.asarray(w), j)) <= 1e-6
    np.testing.assert_allclose(ttern.dequantize(t).numpy(),
                               np.asarray(jtern.dequantize(j)), rtol=1e-6)


@pytest.mark.parametrize("shape", WEIGHTS, ids=str)
def test_binarize_matches_jax(shape):
    w = np.random.default_rng(shape[-1]).standard_normal(shape).astype(
        np.float32)
    t = ttern.binarize(torch.from_numpy(w))
    _assert_same_quant(t, jtern.binarize(jnp.asarray(w)), w)
    assert set(np.unique(t.q.numpy())) <= {-1, 1}


def test_bitplanes_round_trip():
    w = np.random.default_rng(3).standard_normal((64, 48)).astype(np.float32)
    t = ttern.ternarize(torch.from_numpy(w))
    j = jtern.ternarize(jnp.asarray(w))
    plus, minus = ttern.to_bitplanes(t)
    jplus, jminus = jtern.to_bitplanes(j)
    assert plus.dtype == minus.dtype == torch.uint8
    assert not (plus.bool() & minus.bool()).any()
    np.testing.assert_array_equal(plus.numpy(), np.asarray(jplus))
    np.testing.assert_array_equal(minus.numpy(), np.asarray(jminus))
    back = ttern.from_bitplanes(plus, minus, t.scale)
    assert torch.equal(back.q, t.q) and back.scale is t.scale


def _tree(seed):
    """A CNN-like tree of numpy leaves: conv kernels, FC weights, biases
    and an embedding the default predicate skips."""
    rng = np.random.default_rng(seed)

    def a(*s):
        return rng.standard_normal(s).astype(np.float32)
    return {"conv0": {"w": a(3, 3, 3, 8), "b": a(8)},
            "fc0": {"w": a(72, 16), "b": a(16)},
            "fc1": {"w": a(16, 10), "b": a(10)},
            "embed": {"w": a(20, 4)}}


@pytest.mark.parametrize("predicate", [None, FC], ids=["default", "fc"])
@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_quantize_tree_matches_jax(predicate, mode):
    tree = _tree(11)
    ttree = jax.tree.map(torch.from_numpy, tree)
    jtree = jax.tree.map(jnp.asarray, tree)
    tq = ttern.quantize_tree(ttree, mode=mode, predicate=predicate)
    jq = jtern.quantize_tree(jtree, mode=mode, predicate=predicate)
    want = {"conv0/w", "fc0/w", "fc1/w"} if predicate is None \
        else {"fc0/w", "fc1/w"}
    for g, leaves in tree.items():
        for k, w in leaves.items():
            t, j = tq[g][k], jq[g][k]
            quantized = f"{g}/{k}" in want
            assert isinstance(t, ttern.TernaryWeight) == quantized
            assert isinstance(j, jtern.TernaryWeight) == quantized
            if quantized:
                near = _near_threshold(w) if mode == "ternary" else None
                _assert_same_quant(t, j, w, near=near)
            else:
                assert torch.equal(t, ttree[g][k])
    tdeq = ttern.dequantize_tree(tq)
    jdeq = jtern.dequantize_tree(jq)
    for g, leaves in tree.items():
        for k in leaves:
            assert isinstance(tdeq[g][k], torch.Tensor)
            np.testing.assert_allclose(tdeq[g][k].numpy(),
                                       np.asarray(jdeq[g][k]), rtol=1e-6)
