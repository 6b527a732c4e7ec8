"""The port's differentiable int8 matmul (``ops.int8_matmul_train``: K4
with fp32 output forward, K9 backward) and K4's fp32-output mode against
the JAX package, on the CPU.

On the CPU the port runs the kernels' plain versions (``kernels/ref.py``);
chip_smoke.py holds the CUDA kernels against those on the card. The JAX
side runs ``repro.kernels.ops.int8_matmul_train`` (and the Pallas
``int8_matmul_dx`` / ``int8_matmul``) in interpret mode, over cases of
``tests/test_kernels_grad.py``'s ``INT8_CASES``. Tolerances are that
file's: dx fp32 2e-5; bf16 rtol 6e-2 with atol 2% of the gradient's
largest magnitude (one bf16 rounding of each element, and near-zero
elements cancel differently); dscale rtol/atol 1e-4; the fp32 outputs
1e-5 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import int8_matmul as j_im
from repro.kernels import ops as j_ops
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref


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


TOL = {"fp32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=6e-2)}
J_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"fp32": torch.float32, "bf16": torch.bfloat16}

# tests/test_kernels_grad.py::INT8_CASES: (m, k, n, block_n, block_k)
INT8_CASES = [
    (8, 32, 16, 16, 32),            # aligned
    (5, 40, 24, 16, 32),            # ragged everything
    (3, 17, 9, 8, 16),              # tiny + odd
]
IDS = [f"m{c[0]}k{c[1]}n{c[2]}" for c in INT8_CASES]


def _inputs(m, k, n, dt, seed=0, scale_shape=None):
    """x (rounded to the dtype, so both frameworks start from the same
    values), int8 codes, positive scales and an fp32 cotangent, as numpy."""
    rng = np.random.default_rng(seed)
    x = np.array(jnp.asarray(rng.standard_normal((m, k)), J_DT[dt]),
                 np.float32)
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = np.asarray(rng.uniform(
        0.01, 0.1, (n,) if scale_shape is None else scale_shape), np.float32)
    ct = rng.standard_normal((m, n)).astype(np.float32)
    return x, q, scale, ct


def _jax_grads(x, q, scale, ct, dt, bn=16, bk=32):
    def f(x, s):
        y = j_ops.int8_matmul_train(x, jnp.asarray(q), s, block_n=bn,
                                    block_k=bk, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * ct)
    gx, gs = jax.grad(f, argnums=(0, 1))(jnp.asarray(x, J_DT[dt]),
                                         jnp.asarray(scale))
    return np.asarray(gx, np.float32), np.asarray(gs)


def _port_grads(x, q, scale, ct, dt):
    xt = torch.from_numpy(x).to(T_DT[dt]).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    y = t_ops.int8_matmul_train(xt, torch.from_numpy(q), st)
    assert y.dtype == T_DT[dt]
    gx, gs = torch.autograd.grad((y.float() * torch.from_numpy(ct)).sum(),
                                 (xt, st))
    assert gx.dtype == xt.dtype and gs.shape == st.shape
    return gx.float().numpy(), gs.numpy()


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("m,k,n,bn,bk", INT8_CASES, ids=IDS)
def test_dx_matches_jax(m, k, n, bn, bk, dt):
    """dx through the port's autograd Function (K9's plain version) against
    JAX's custom VJP through the Pallas K9 in interpret mode."""
    x, q, scale, ct = _inputs(m, k, n, dt, seed=m * 1000 + k)
    want, _ = _jax_grads(x, q, scale, ct, dt, bn, bk)
    got, _ = _port_grads(x, q, scale, ct, dt)
    tol = dict(TOL[dt])
    if dt == "bf16":
        tol["atol"] = 0.02 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("scale_shape", [(16,), (1, 16), ()],
                         ids=["per-channel", "keepdims", "per-tensor"])
def test_dscale_matches_jax(scale_shape):
    """dscale, recovered from the saved fp32 output, in the scale's own
    shape (``tests/test_kernels_grad.py::test_int8_matmul_dscale_parity``
    at each scale shape ``ops.int8_matmul`` takes)."""
    x, q, scale, ct = _inputs(6, 32, 16, "fp32", seed=7,
                              scale_shape=scale_shape)
    want_x, want = _jax_grads(x, q, scale, ct, "fp32")
    got_x, got = _port_grads(x, q, scale, ct, "fp32")
    assert got.shape == want.shape == scale.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_x, want_x, **TOL["fp32"])


def test_zero_scale_takes_one():
    """A zero scale divides as 1 in the dscale recovery
    (``int8_matmul.py:175``), as in JAX: no inf or nan."""
    x, q, scale, ct = _inputs(4, 32, 16, "fp32", seed=3)
    scale[3] = 0.0
    _, want = _jax_grads(x, q, scale, ct, "fp32")
    _, got = _port_grads(x, q, scale, ct, "fp32")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_forward_is_fp32_before_the_cast(dt):
    """The Function's own output is fp32 for every x dtype (the residual
    dscale needs) and equals JAX's ``int8_matmul_vjp`` primal; the public
    wrapper casts it to x's dtype. The codes get no gradient."""
    x, q, scale, _ = _inputs(8, 32, 16, dt, seed=11)
    xt = torch.from_numpy(x).to(T_DT[dt]).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    qt = torch.from_numpy(q)
    y32 = t_ops._Int8MatmulTrain.apply(xt, qt, st)
    assert y32.dtype == torch.float32
    want = np.asarray(j_im.int8_matmul_vjp(
        jnp.asarray(x, J_DT[dt]), jnp.asarray(q), jnp.asarray(scale),
        (8, 16, 32, True, jnp.dtype(J_DT[dt]).name)))
    assert want.dtype == np.float32
    np.testing.assert_allclose(y32.detach().numpy(), want,
                               rtol=0, atol=1e-5 * np.abs(want).max())
    y = t_ops.int8_matmul_train(xt, qt, st)
    assert y.dtype == xt.dtype
    assert torch.equal(y, y32.to(xt.dtype))
    grads = y32.grad_fn.apply(torch.ones_like(y32))
    assert grads[1] is None and qt.grad is None
    assert grads[0].dtype == xt.dtype and grads[2].shape == st.shape


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_plain_k9_matches_pallas(dt):
    """K9's plain version against the Pallas ``int8_matmul_dx`` in
    interpret mode (block multiples, fp32 dy), dx in x's dtype."""
    rng = np.random.default_rng(5)
    m, n, k = 16, 32, 64
    dy = rng.standard_normal((m, n)).astype(np.float32)
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, (n,)).astype(np.float32)
    want = np.asarray(j_im.int8_matmul_dx(
        jnp.asarray(dy), jnp.asarray(q), jnp.asarray(scale), block_m=16,
        block_n=16, block_k=32, interpret=True, out_dtype=J_DT[dt]),
        np.float32)
    got = t_ref.int8_matmul_dx_ref(torch.from_numpy(dy), torch.from_numpy(q),
                                   torch.from_numpy(scale), T_DT[dt])
    assert got.dtype == T_DT[dt]
    top = np.abs(want).max()
    # fp32: 1e-5 of the max; bf16: one bf16 rounding (2^-7 relative) more
    rtol = 0.0 if dt == "fp32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=1e-5 * top)


def test_plain_k4_fp32_output_matches_pallas():
    """K4's plain version with ``out_dtype=float32`` for bf16 x against the
    Pallas ``int8_matmul`` with ``out_dtype=jnp.float32``; the default
    output stays x's dtype."""
    rng = np.random.default_rng(6)
    x = np.array(jnp.asarray(rng.standard_normal((16, 64)), jnp.bfloat16),
                 np.float32)
    q = rng.integers(-127, 128, (64, 32)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, (32,)).astype(np.float32)
    want = np.asarray(j_im.int8_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(scale),
        block_m=16, block_n=16, block_k=32, interpret=True,
        out_dtype=jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = t_ref.int8_matmul_ref(xt, torch.from_numpy(q),
                                torch.from_numpy(scale),
                                out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert t_ref.int8_matmul_ref(xt, torch.from_numpy(q),
                                 torch.from_numpy(scale)).dtype == torch.bfloat16


class _NoKernelDevice(torch.Tensor):
    """A CPU tensor that reports a device the port has no kernel for."""

    @property
    def device(self):
        return torch.device("xpu")


def test_lead_dims_and_no_cuda_fallback():
    """(..., K) inputs keep their lead dims; a tensor on a device with no
    kernel raises instead of falling back; meta tensors (the dry-run's
    shapes) get an empty meta output of the kernel's shape."""
    x, q, scale, _ = _inputs(6, 32, 16, "fp32", seed=2)
    xt = torch.from_numpy(x).reshape(2, 3, 32)
    y = t_ops.int8_matmul_train(xt, torch.from_numpy(q),
                                torch.from_numpy(scale))
    assert y.shape == (2, 3, 16)
    with pytest.raises(ValueError):
        t_ops.int8_matmul_train(xt.as_subclass(_NoKernelDevice),
                                torch.from_numpy(q), torch.from_numpy(scale))
    out = t_ops.int8_matmul_train(xt.to("meta"),
                                  torch.from_numpy(q).to("meta"),
                                  torch.from_numpy(scale).to("meta"))
    assert out.is_meta and out.shape == (2, 3, 16)
