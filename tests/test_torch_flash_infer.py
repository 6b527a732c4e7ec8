"""The port's inference flash attention (K10: ``ops.flash_attention``,
forward only, with its int8-KV mode) against the JAX package, on the CPU.

On the CPU ``ops.flash_attention`` runs K10's plain version
(``ref.flash_attention_ref``); chip_smoke.py holds the CUDA kernel against
it on the card. The JAX side runs ``repro.kernels.ops.flash_attention``
with its Pallas kernel in interpret mode, over causal, windowed and
non-causal (Sq = Sk) cases of ``tests/test_kernels_grad.py``'s
``FLASH_CASES`` in fp32 and bf16, and the int8-KV cases of
``tests/test_kernels_int8.py``. Tolerances: fp32 2e-5, bf16 6e-2 (those
files' bounds); int8 K/V 1e-5 absolute (``test_kernels_int8.py``'s).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.quant import int8 as j_q8
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


TOL = {"fp32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=6e-2, atol=6e-2)}
J_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
SCALE = 0.4

# (sq, sk, h, hkv, d, causal, window) of tests/test_kernels_grad.py's
# FLASH_CASES: MHA, GQA, odd length, window, non-causal, odd + window
CASES = [
    (16, 16, 2, 2, 8, True, -1),
    (16, 16, 4, 2, 8, True, -1),
    (13, 13, 2, 1, 8, True, -1),
    (24, 24, 2, 2, 8, True, 7),
    (16, 16, 2, 2, 8, False, -1),
    (9, 9, 2, 2, 8, True, 4),
    # the smoke configs' other head dims: 16 and gemma3-smoke's 24
    (16, 16, 4, 4, 16, True, -1),
    (21, 21, 3, 1, 24, True, 5),
]
IDS = [f"sq{c[0]}h{c[2]}kv{c[3]}{'c' if c[5] else 'f'}w{c[6]}" for c in CASES]


def _inputs(case, dt, seed):
    """q, k, v as numpy, rounded to the dtype (exact in fp32 for both)."""
    sq, sk, h, hkv, d, _, _ = case
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((2, sq, h, d), (2, sk, hkv, d), (2, sk, hkv, d)):
        a = rng.standard_normal(shape).astype(np.float32)
        out.append(np.array(jnp.asarray(a, J_DT[dt]), np.float32))
    return out


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_matches_pallas(case, dt):
    """K10's plain version through ``ops.flash_attention`` against the
    Pallas kernel in interpret mode, in q's dtype."""
    q, k, v = _inputs(case, dt, CASES.index(case))
    _, _, _, _, _, causal, window = case
    want = j_ops.flash_attention(
        *(jnp.asarray(a, J_DT[dt]) for a in (q, k, v)), scale=SCALE,
        causal=causal, window=window, block_q=8, block_k=8, interpret=True)
    got = t_ops.flash_attention(
        *(torch.from_numpy(a).to(T_DT[dt]) for a in (q, k, v)), scale=SCALE,
        causal=causal, window=window)
    assert got.dtype == T_DT[dt] and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dt])


def _quantized_kv(rng, b, s, hkv, d):
    """tests/test_kernels_int8.py::_quantized_kv, as numpy."""
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((b, s, hkv, d)), jnp.float32)
        q, sc = j_q8.quantize_rowwise(x)
        out.append((np.array(q), np.array(sc)))
    return out


@pytest.mark.parametrize("s,window", [(16, -1), (16, 5), (11, -1)],
                         ids=["global", "window5", "padded11"])
def test_int8_kv_matches_pallas(s, window):
    """int8 K/V codes with (B, Sk, Hkv) fp32 scales, each row times its
    scale as it is read, against the Pallas kernel's int8-KV mode
    (``tests/test_kernels_int8.py::TestInt8FlashAttention``; S = 11 is its
    padded case)."""
    rng = np.random.default_rng(5 + s + window)
    b, h, hkv, d = 2, 4, 2, 16
    if s == 11:
        h, hkv, d = 2, 1, 8
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    (kq, ks), (vq, vs) = _quantized_kv(rng, b, s, hkv, d)
    want = j_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), scale=0.25,
        causal=True, window=window, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), interpret=True)
    t = torch.from_numpy
    got = t_ops.flash_attention(t(q), t(kq), t(vq), scale=0.25, causal=True,
                                window=window, k_scale=t(ks), v_scale=t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError):
        t_ops.flash_attention(t(q), t(kq), t(vq), scale=0.25, k_scale=t(ks))


def test_row_with_no_key_is_zeros():
    """Sq > Sk under a window leaves query rows with no valid key (query i
    sees keys i - window < j <= i below Sk): the port gives them zeros,
    by design, where the JAX wrapper escapes to ``attention_ref``'s
    average of V. The rows that see keys match JAX."""
    rng = np.random.default_rng(9)
    sq, sk, window = 8, 3, 2
    q = rng.standard_normal((1, sq, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, sk, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, sk, 1, 8)).astype(np.float32)
    t = torch.from_numpy
    got = t_ops.flash_attention(t(q), t(k), t(v), scale=SCALE, causal=True,
                                window=window).numpy()
    empty = np.arange(sq) >= sk + window - 1
    assert empty.any() and not empty.all()
    assert (got[:, empty] == 0).all()
    want = np.asarray(j_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=SCALE,
        causal=True, window=window, interpret=True))
    np.testing.assert_allclose(got[:, ~empty], want[:, ~empty],
                               **TOL["fp32"])


def test_equals_training_forward():
    """K10 is K6's forward without the lse: the plain versions give the
    same output bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(CASES[3], "fp32", 3))
    kw = dict(scale=SCALE, causal=True, window=7)
    out, _ = t_ref.flash_attention_fwd_ref(q, k, v, **kw)
    assert torch.equal(t_ops.flash_attention(q, k, v, **kw), out)
