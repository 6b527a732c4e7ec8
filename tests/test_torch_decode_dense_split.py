"""K1's split walk over the slot-major cache, and K4's decode-kernel
planner, checked on the CPU.

K1 (``decode_attention``) runs the split body of K2 and K5
(``csrc/paged_decode_split.cuh``) with a dense row policy: key i of slot b
at ``b * stride_b + i * stride_s``, split by K2's planner at page size 1.
That is K2's walk over the cache seen as pages of one row, so
``emulate`` of ``test_torch_decode_split.py`` models it, in either
kernel's numerics. Held against the JAX Pallas kernel
(``repro.kernels.ops.decode_attention``) in interpret mode: 1e-5 in the
SIMT numerics, chip_smoke.py's bf16 gate in the tensor-core numerics; and
against K2's emulation on a page-16 pool holding the same rows, bit for
bit (the identity chip_smoke.py asserts on the card).

K4's decode kernel (``int8_matmul`` at M <= 8) runs one block a
(128-column tile, band of 128-row rounds); its planner (``decode_plan``,
``decode_band``: the kernel's own arithmetic) is checked at a decode
tick's four projections of starcoder2-7b and a small ragged shape.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as k1
from repro_torch.kernels import int8_matmul as k4
from repro_torch.kernels import paged_decode_attention as k2
from tests.test_torch_decode_split import ATOL, RTOL, SMS, emulate


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The CPU emulations' ops are far below any parallel grain, but on a
    loaded host (the suite's parallel workers) idle intra-op threads cost
    this file many times its run time: one thread while it runs, the
    worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PAGE = 16                           # K2's pool pages in the identity
SK = 256                            # a whole number of Pallas's 128-key blocks
# a dead slot, a one-key slot, a split edge and one past it, the
# capacity, 300 (past Sk: under a window of 70 its keys 230-255), 130 (a
# window of 70 starts inside a split) and 400 (past Sk, whose window of
# 70 starts past Sk: no key, so the kernels write zeros where the Pallas
# kernel averages V over the masked keys of its tiles, as its verify
# kernel does for rows with no key)
LENGTHS = (0, 1, 64, 65, 256, 300, 130, 400)


def _case(seed, *, rep, d, kv, q_dtype, hkv=2):
    """numpy inputs: q (B, H, d) in q_dtype, a (B, SK, hkv, d) cache of
    int8 codes with (B, SK, hkv) scales, or of fp values in its dtype."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))     # noqa: E731
    b = len(LENGTHS)
    q = rng.standard_normal((b, hkv * rep, d)).astype(np.float32)
    q = bf(q) if q_dtype == "bfloat16" else q
    shape = (b, SK, hkv, d)
    if kv == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        scales = tuple((rng.random(shape[:-1]) * 0.02 + 1e-3
                        ).astype(np.float32) for _ in range(2))
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        if kv == "bfloat16":
            k, v = bf(k), bf(v)
        scales = (None, None)
    return (q, k, v, np.array(LENGTHS, np.int32)), scales


def _torch(a):
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def emulate_k1(q, k, v, lengths, *, scale, window, k_scale, v_scale,
               kernel):
    """K1's walk: the cache as pages of one row in slot-major order (row i
    of slot b at pool row b * Sk + i, as DenseRows reads it), split by
    K1's plan. fp32 (B, H, D), zeros for rows with no key."""
    b, sk, hkv, d = k.shape
    pl = k1.plan(b, q.shape[1], hkv, d, sk, kernel, SMS, window)
    table = torch.arange(b * sk, dtype=torch.int32).reshape(b, sk)
    pages = [None if t is None else t.reshape(b * sk, 1, *t.shape[2:])
             for t in (k, v, k_scale, v_scale)]
    return emulate(q[:, None], pages[0], pages[1], table, lengths,
                   scale=scale, window=window, k_scale=pages[2],
                   v_scale=pages[3], split=pl.split, lanes=1,
                   tc=kernel == "tensor_cores")[:, 0], pl


def _pallas(args, scales, *, scale, window):
    q, k, v, lengths = map(jnp.asarray, args)
    kw = {} if scales[0] is None else {"k_scale": jnp.asarray(scales[0]),
                                       "v_scale": jnp.asarray(scales[1])}
    out = jops.decode_attention(q, k, v, lengths, scale=scale, window=window,
                                interpret=True, **kw)
    return np.asarray(out).astype(np.float32)


def _has_key(window):
    """(B,): the slots whose query sees a key below SK."""
    n = np.array(LENGTHS)
    lo = np.maximum(0, n - window) if window > 0 else np.zeros_like(n)
    return (n > 0) & (lo < np.minimum(n, SK))


def _emulated(args, scales, *, scale, window, kernel):
    q, k, v, lengths = map(_torch, args)
    return emulate_k1(q, k, v, lengths, scale=scale, window=window,
                      k_scale=_torch(scales[0]), v_scale=_torch(scales[1]),
                      kernel=kernel)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("window", [-1, 70])
@pytest.mark.parametrize("rep", [1, 9])
def test_simt_dense_split_matches_pallas(rep, window, kv):
    args, scales = _case(1, rep=rep, d=64, kv=kv, q_dtype="float32")
    got, pl = _emulated(args, scales, scale=64 ** -0.5, window=window,
                        kernel="simt")
    assert pl.split == 64 and pl.n_splits == (4 if window < 0 else 3)
    want = _pallas(args, scales, scale=64 ** -0.5, window=window)
    key = _has_key(window)
    assert np.abs(got.numpy()[key] - want[key]).max() < 1e-5
    assert (got.numpy()[~key] == 0.0).all()
    assert (want[np.array(LENGTHS) == 0] == 0.0).all()


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
@pytest.mark.parametrize("window", [-1, 70])
@pytest.mark.parametrize("rep", [1, 9])
def test_tc_dense_split_within_the_card_gate(rep, window, kv):
    args, scales = _case(2, rep=rep, d=128, kv=kv, q_dtype="bfloat16")
    got, pl = _emulated(args, scales, scale=128 ** -0.5, window=window,
                        kernel="tensor_cores")
    assert pl.lanes == 1 and rep <= k2.TC_ROWS
    want = _pallas(args, scales, scale=128 ** -0.5, window=window)
    key = _has_key(window)
    g, w = got.numpy()[key], want[key]
    assert (np.abs(g - w) <= ATOL + RTOL * np.abs(w)).all(), \
        np.abs(g - w).max()
    assert (got.numpy()[~key] == 0.0).all()


@pytest.mark.parametrize("window", [-1, 70])
@pytest.mark.parametrize("kernel,q_dtype,kv", [
    ("simt", "float32", "float32"), ("simt", "float32", "int8"),
    ("tensor_cores", "bfloat16", "int8"),
    ("tensor_cores", "bfloat16", "bfloat16")])
def test_k1_equals_k2_on_the_same_rows(kernel, q_dtype, kv, window):
    """K1 on the cache and K2 on a permuted pool of pages of 16 holding
    the same rows split at the same keys and sum in the same order: equal
    bit for bit."""
    d = 128 if kernel == "tensor_cores" else 64
    args, scales = _case(3, rep=9, d=d, kv=kv, q_dtype=q_dtype)
    q, k, v, lengths = map(_torch, args)
    k_scale, v_scale = map(_torch, scales)
    got, pl1 = emulate_k1(q, k, v, lengths, scale=d ** -0.5, window=window,
                          k_scale=k_scale, v_scale=v_scale, kernel=kernel)
    b, hkv, nb = q.shape[0], k.shape[2], SK // PAGE
    table = torch.from_numpy(np.random.default_rng(4).permutation(
        b * nb).astype(np.int32)).reshape(b, nb)
    pools = []
    for t in (k, v, k_scale, v_scale):
        if t is None:
            pools.append(None)
            continue
        pool = torch.zeros((b * nb + 1, PAGE, *t.shape[2:]), dtype=t.dtype)
        pool[table.flatten().long()] = t.reshape(b * nb, PAGE, *t.shape[2:])
        pools.append(pool)
    pl2 = k2.plan(b, 1, q.shape[1], hkv, d, nb, PAGE, kernel, SMS, window)
    assert (pl1.split, pl1.n_splits) == (pl2.split, pl2.n_splits)
    want = emulate(q[:, None], pools[0], pools[1], table, lengths,
                   scale=d ** -0.5, window=window, k_scale=pools[2],
                   v_scale=pools[3], split=pl2.split, lanes=1,
                   tc=kernel == "tensor_cores")[:, 0]
    assert torch.equal(got, want)


def test_k1_plan_reads_shapes_only_and_splits_as_k2():
    """K1's plan takes no lengths (no host read a layer, no grid that
    changes from tick to tick), and at the main path's shapes it is K2's at
    pages of 16: 8 splits of 256 keys, 256 blocks; 5 of 64 in a window of
    256."""
    assert "length" not in " ".join(inspect.signature(k1.plan).parameters)
    for kernel in ("tensor_cores", "simt"):
        for window in (-1, 256):
            got = k1.plan(8, 36, 4, 128, 2048, kernel, SMS, window)
            want = k2.plan(8, 1, 36, 4, 128, 128, 16, kernel, SMS, window)
            assert got == want
        assert k1.plan(8, 36, 4, 128, 2048, kernel, SMS)[2:4] == (256, 8)
        assert k1.plan(8, 36, 4, 128, 2048, kernel, SMS, 256)[2:4] == (64, 5)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.int8])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_k1_route_is_k2s(d, kv_dtype, q_dtype):
    """One body, one rule: bf16 q over a bf16 or int8 cache at D = 128 on
    the tensor cores (the int8 serve runs' mode), every other mode (the
    dense serve phase's bf16 q over an fp32 cache too) on SIMT."""
    want = ("tensor_cores" if q_dtype == torch.bfloat16 and d == 128
            and kv_dtype != torch.float32 else "simt")
    assert k1.route(q_dtype, kv_dtype, d) == k2.route(q_dtype, kv_dtype,
                                                      d) == want


# (K, N) of a decode tick's projections of starcoder2-7b (wq/wo, wk/wv,
# w_in, w_out) and a K below one round over an N below one tile
K4_DECODE = [(4608, 4608), (4608, 512), (4608, 18432), (18432, 4608),
             (48, 13)]


@pytest.mark.parametrize("k,n", K4_DECODE)
def test_k4_decode_plan_covers_every_row_once_in_balanced_blocks(k, n):
    """Every k row of every tile in exactly one block; no block without a
    round (and every round starts below K: it holds a step); every block
    the same number of rounds; every block resident at once (2 on each of
    the 132 SMs at most); the blocks of a band on adjacent tiles at the
    same rows; each partial in its own workspace slot."""
    pl = k4.decode_plan(k, n, SMS)
    covered = np.zeros((pl.tiles, k), np.int64)
    runs = set()
    for b in range(pl.blocks):
        ct, lo, hi = k4.decode_band(pl, b)
        assert hi > lo and lo * k4.DECODE_ROUND < k
        runs.add(hi - lo)
        for r in range(lo, hi):
            covered[ct, r * k4.DECODE_ROUND:(r + 1) * k4.DECODE_ROUND] += 1
        if ct:
            assert k4.decode_band(pl, b - 1) == (ct - 1, lo, hi)
    assert (covered == 1).all() and len(runs) == 1
    assert pl.blocks <= 2 * SMS
    if pl.bands > 1:
        assert pl.ws_floats == pl.blocks * k4.DECODE_PARTIAL
