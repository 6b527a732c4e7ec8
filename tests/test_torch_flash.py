"""The port's training flash attention (K6 forward with lse, K7 dQ, K8
dK/dV) and ``rms_norm``'s custom backward against the JAX package.

On the CPU the port runs the kernels' plain versions (``kernels/ref.py``),
and its ``ops.flash_attention_train`` autograd Function routes to them; the
JAX side runs ``repro.kernels.ops.flash_attention_train`` with ``jax.vjp``
through its Pallas kernels in interpret mode, and ``_fwd_with_lse`` for the
lse, over the grad matrix of ``tests/test_kernels_grad.py``. Tolerances are
that file's: fp32 2e-5, bf16 6e-2 (one bf16 rounding of O(1) values, with
room for the two frameworks rounding at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_fa
from repro.kernels import ops as j_ops
from repro.models import layers as j_layers
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import layers as t_layers


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


TOL = {"fp32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=6e-2, atol=6e-2)}
J_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
SCALE = 0.4

# tests/test_kernels_grad.py::FLASH_CASES
FLASH_CASES = [
    # (sq, sk, h, hkv, d, causal, window, block_q, block_k)
    (16, 16, 2, 2, 8, True, -1, 8, 8),          # aligned, MHA
    (16, 16, 4, 2, 8, True, -1, 8, 8),          # GQA
    (13, 13, 2, 1, 8, True, -1, 8, 8),          # odd seq -> padded blocks
    (24, 24, 2, 2, 8, True, 7, 8, 8),           # sliding window
    (16, 16, 2, 2, 8, False, -1, 8, 8),         # non-causal
    (13, 16, 2, 2, 8, True, -1, 8, 16),         # sq < sk (chunked prefill)
    (16, 16, 2, 2, 16, True, -1, 16, 8),        # asymmetric blocks
    (9, 9, 2, 2, 8, True, 4, 8, 8),             # odd + window
] + [
    # the smoke configs' head dims beyond that matrix's 8 and 16
    (16, 16, 2, 2, 24, True, -1, 8, 8),         # gemma3-smoke's 24
    (21, 21, 4, 2, 24, True, 6, 8, 8),          # odd + window + GQA at 24
    (19, 19, 4, 1, 16, True, -1, 8, 8),         # odd + GQA at 16
]
IDS = [f"sq{c[0]}sk{c[1]}h{c[2]}kv{c[3]}d{c[4]}{'c' if c[5] else 'f'}"
       f"w{c[6]}b{c[7]}x{c[8]}" for c in FLASH_CASES]


def _inputs(case, dt):
    """q, k, v and the output cotangent as numpy, from a seed; q/k/v are
    rounded to the case's dtype (exact in fp32 for both frameworks)."""
    sq, sk, h, hkv, d, causal, window, _, _ = case
    rng = np.random.default_rng(FLASH_CASES.index(case))
    b = 2
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d),
                      (b, sq, h, d))]
    for i in range(3):
        arrs[i] = np.array(jnp.asarray(arrs[i], J_DT[dt]), np.float32)
    return arrs


def _pad_rows(x, mult):
    return np.pad(x, ((0, 0), (0, (-x.shape[1]) % mult), (0, 0), (0, 0)))


def _jax(case, dt):
    """JAX's out, lse, dq, dk, dv (as fp32 numpy) through the Pallas
    kernels in interpret mode, in one jitted call."""
    sq, sk, h, hkv, d, causal, window, bq, bk = case
    q, k, v, ct = _inputs(case, dt)
    cast = lambda x: jnp.asarray(x, J_DT[dt])  # noqa: E731
    # the lse residual of the same kernel, on the wrapper's padded shapes
    bq_, bk_ = min(bq, j_ops._round_up_pow2(sq)), min(bk,
                                                    j_ops._round_up_pow2(sk))

    @jax.jit
    def run(q, k, v, ct, qp, kp, vp):
        def f(q, k, v):
            return j_ops.flash_attention_train(
                q, k, v, scale=SCALE, causal=causal, window=window,
                block_q=bq, block_k=bk, interpret=True)

        out, vjp = jax.vjp(f, q, k, v)
        dq, dk, dv = vjp(ct.astype(out.dtype))
        _, lse = j_fa._fwd_with_lse(qp, kp, vp, (SCALE, causal, window, bq_,
                                                 bk_, True))
        return out, lse, dq, dk, dv

    out, lse, dq, dk, dv = run(
        cast(q), cast(k), cast(v), jnp.asarray(ct), cast(_pad_rows(q, bq_)),
        cast(_pad_rows(k, bk_)), cast(_pad_rows(v, bk_)))
    lse = np.asarray(lse)[:, :, :sq, 0]
    return tuple(np.asarray(x, np.float32)
                 for x in (out, lse, dq, dk, dv))


def _check(name, got, want, dt):
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               **TOL[dt], err_msg=name)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=IDS)
def test_flash_plain_versions_and_autograd_match_jax(case, dt):
    """K6's, K7's and K8's plain versions (out, lse, dq, dk, dv), and the
    ``flash_attention_train`` autograd Function through them, equal JAX's
    kernels; dk/dv come out in k's/v's dtype, each GQA group summed."""
    sq, sk, h, hkv, d, causal, window, _, _ = case
    j_out, j_lse, j_dq, j_dk, j_dv = _jax(case, dt)
    q, k, v, ct = (torch.from_numpy(x) for x in _inputs(case, dt))
    q, k, v = (x.to(T_DT[dt]) for x in (q, k, v))
    kw = dict(scale=SCALE, causal=causal, window=window)

    out, lse = t_ref.flash_attention_fwd_ref(q, k, v, **kw)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    assert lse.shape == (2, h, sq)
    _check("out", out, j_out, dt)
    _check("lse", lse, j_lse, dt)
    dout = ct.to(out.dtype)
    dq, dk, dv = t_ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    assert (dq.dtype, dk.dtype, dv.dtype) == (q.dtype, k.dtype, v.dtype)
    for name, g, w in (("dq", dq, j_dq), ("dk", dk, j_dk), ("dv", dv, j_dv)):
        _check(name, g, w, dt)

    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out2 = t_ops.flash_attention_train(*leaves, **kw)
    assert torch.equal(out2, out)
    (out2.float() * ct).sum().backward()
    for name, g, w in zip(("dq", "dk", "dv"), (x.grad for x in leaves),
                          (j_dq, j_dk, j_dv)):
        assert g.dtype == T_DT[dt], name
        _check(name, g, w, dt)


def test_flash_row_without_key_is_zero():
    """Sq > Sk with a window leaves rows that see no key: the port gives
    them zeros and no gradient (the Pallas body averages V over the masked
    keys it visited, which depends on its tiling), and the other rows are
    unaffected."""
    rng = np.random.default_rng(7)
    q = torch.tensor(rng.standard_normal((1, 12, 2, 8)), dtype=torch.float32,
                     requires_grad=True)
    k = torch.tensor(rng.standard_normal((1, 4, 1, 8)), dtype=torch.float32,
                     requires_grad=True)
    v = torch.tensor(rng.standard_normal((1, 4, 1, 8)), dtype=torch.float32,
                     requires_grad=True)
    out = t_ops.flash_attention_train(q, k, v, scale=SCALE, causal=True,
                                      window=3)
    # row i sees keys (i - 3, i] within [0, 4): rows 6.. see none
    assert torch.equal(out[:, 6:], torch.zeros_like(out[:, 6:]))
    out.sum().backward()
    assert torch.equal(q.grad[:, 6:], torch.zeros_like(q.grad[:, 6:]))
    want = t_layers.sdpa(q[:, :6], k, v,
                         t_layers.attention_mask(torch.arange(6),
                                                 torch.arange(4),
                                                 causal=True, window=3),
                         SCALE)
    torch.testing.assert_close(out[:, :6], want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_rms_norm_backward_matches_jax(dt):
    """``rms_norm``'s custom backward (dx in x's dtype with fp32
    reductions, dscale summed in fp32) equals JAX's custom VJP."""
    rng = np.random.default_rng(3)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 5, 24)), J_DT[dt]),
                   np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(24)).astype(np.float32)
    ct = np.asarray(jnp.asarray(rng.standard_normal((2, 5, 24)), J_DT[dt]),
                    np.float32)

    def jf(x, s):
        return j_layers.rms_norm({"scale": s}, x)

    jy, jvjp = jax.vjp(jf, jnp.asarray(x, J_DT[dt]), jnp.asarray(scale))
    jdx, jds = jvjp(jnp.asarray(ct, J_DT[dt]))
    tx = torch.tensor(x).to(T_DT[dt]).requires_grad_(True)
    ts = torch.tensor(scale).requires_grad_(True)
    ty = t_layers.rms_norm({"scale": ts}, tx)
    ty.backward(torch.tensor(ct).to(T_DT[dt]))
    assert tx.grad.dtype == T_DT[dt] and ts.grad.dtype == torch.float32
    for name, got, want in (("y", ty, jy), ("dx", tx.grad, jdx),
                            ("dscale", ts.grad, jds)):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32), **TOL[dt],
                                   err_msg=name)
