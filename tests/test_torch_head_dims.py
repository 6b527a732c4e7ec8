"""K1, K2, K5 and K3 at every head dim of the reference's configs: the
port's plain versions (``kernels/ref.py``, what the public wrappers run on
CPU tensors) against the JAX package's Pallas kernels in interpret mode,
on the same numpy inputs, and the wrappers' head-dim rules.

Head dims 8, 24 (smoke configs), 112 (kimi-k2, zamba2) and 168 (gemma3-27b)
are none of the D = 64 / 128 / 256 the kernels took before; the Pallas
blocks take the whole head dim as their last block dim. Inputs: a dead
slot or row, one key, ragged lengths; windows -1 and 6. Bound: 1e-5 in
fp32, as tests/test_serve_core.py holds the Pallas decode kernel to
masked sdpa; rows with no valid key are exact zeros. The CUDA kernels are
held against these plain versions on the card by chip_smoke.py (every
mode, windows -1 and 300, and gemma3-27b's heads timed).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.quant import int8 as jq
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as k2
from repro_torch.kernels import paged_prefill_attention as k3

NEW_DIMS = (8, 24, 112, 168)
WINDOWS = (-1, 6)
HKV, REP = 2, 2
B, PS, NB = 5, 8, 4
# dead slot, one key, two in between, the table's capacity
LENS = np.array([0, 1, 13, 27, PS * NB], np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions' ops are far below any parallel grain: one torch
    thread while this file runs (idle intra-op threads cost a loaded host
    several times its run time), the worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pool_case(d, t, seed):
    """q (B, T, H, D), fp32 pools of B * NB pages plus one, a permuted
    table and LENS."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, t, HKV * REP, d)).astype(np.float32)
    kp = rng.standard_normal((B * NB + 1, PS, HKV, d)).astype(np.float32)
    vp = rng.standard_normal((B * NB + 1, PS, HKV, d)).astype(np.float32)
    pt = rng.permutation(B * NB).reshape(B, NB).astype(np.int32)
    return q, kp, vp, pt, LENS


def _check(got, want, has_key):
    assert np.abs(got[has_key] - want[has_key]).max() < 1e-5
    assert (got[~has_key] == 0.0).all()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("d", NEW_DIMS)
def test_decode_plain_matches_pallas(d, window):
    """K1: a slot-major cache of 37 keys."""
    rng = np.random.default_rng(d)
    sk = 37
    q = rng.standard_normal((B, HKV * REP, d)).astype(np.float32)
    k = rng.standard_normal((B, sk, HKV, d)).astype(np.float32)
    v = rng.standard_normal((B, sk, HKV, d)).astype(np.float32)
    lens = np.array([0, 1, sk, 20, 7], np.int32)
    scale = d ** -0.5
    got = ops.decode_attention(*map(_t, (q, k, v, lens)), scale=scale,
                               window=window).numpy()
    want = np.asarray(jops.decode_attention(
        *map(jnp.asarray, (q, k, v, lens)), scale=scale, window=window,
        interpret=True))
    _check(got, want, lens > 0)
    assert (want[lens == 0] == 0.0).all()


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("d", NEW_DIMS)
def test_paged_decode_plain_matches_pallas(d, window, int8):
    """K2, fp32 pools and int8 codes with row scales (the int8 serve
    mode), through a permuted table."""
    q, kp, vp, pt, lens = _pool_case(d, 1, seed=d + 1)
    scales = {}
    if int8:
        kp, ks = jq.quantize_rowwise(jnp.asarray(kp))
        vp, vs = jq.quantize_rowwise(jnp.asarray(vp))
        scales = dict(k_scale=ks, v_scale=vs)
    args = (q[:, 0], kp, vp, pt, lens)
    scale = d ** -0.5
    got = ops.paged_decode_attention(
        *map(_t, args), scale=scale, window=window,
        **{k: _t(v) for k, v in scales.items()}).numpy()
    want = np.asarray(jops.paged_decode_attention(
        *map(jnp.asarray, args), scale=scale, window=window, interpret=True,
        **scales))
    _check(got, want, lens > 0)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("d", NEW_DIMS)
def test_paged_verify_plain_matches_pallas(d, window):
    """K5 at T = 3 lanes: lengths 0 and 1 leave rows with no valid key
    (zeros in the port; the Pallas kernel averages V there)."""
    t = 3
    q, kp, vp, pt, lens = _pool_case(d, t, seed=d + 2)
    scale = d ** -0.5
    args = (q, kp, vp, pt, lens)
    got = ops.paged_verify_attention(*map(_t, args), scale=scale,
                                     window=window).numpy()
    want = np.asarray(jops.paged_verify_attention(
        *map(jnp.asarray, args), scale=scale, window=window, interpret=True))
    q_pos = lens[:, None] - t + np.arange(t)[None]
    _check(got, want, (lens[:, None] > 0) & (q_pos >= 0))


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("d", NEW_DIMS)
def test_paged_prefill_plain_matches_pallas(d, window):
    """K3: chunks of C = 5 at an unaligned start, a short row and a dead
    row (the inputs of tests/test_torch_paged.py's K3 case)."""
    rng = np.random.default_rng(d + 3)
    b, c, ps, nbk = 3, 5, 4, 4
    q = rng.normal(size=(b, c, HKV * REP, d)).astype(np.float32)
    k_new = rng.normal(size=(b, c, HKV, d)).astype(np.float32)
    v_new = rng.normal(size=(b, c, HKV, d)).astype(np.float32)
    kp = rng.normal(size=(b * nbk + 1, ps, HKV, d)).astype(np.float32)
    vp = rng.normal(size=(b * nbk + 1, ps, HKV, d)).astype(np.float32)
    pt = rng.permutation(b * nbk).reshape(b, nbk).astype(np.int32)
    starts = np.array([9, 4, 0], np.int32)
    lens = np.array([5, 3, 0], np.int32)
    scale = d ** -0.5
    args = (q, k_new, v_new, kp, vp, pt, starts, lens)
    got = ops.paged_prefill_attention(*map(_t, args), scale=scale,
                                      window=window).numpy()
    want = np.asarray(jops.paged_prefill_attention(
        *map(jnp.asarray, args), scale=scale, window=window, interpret=True))
    # every lane of a live row, the padding lanes past its length too
    _check(got, want, np.broadcast_to((lens > 0)[:, None], (b, c)))


def test_head_dim_sets():
    """Every head dim of the reference's configs, full size and smoke."""
    assert set(k2.HEAD_DIMS) == {8, 16, 24, 64, 112, 128, 168, 256}
    assert set(k3.HEAD_DIMS) == {8, 16, 24, 64, 112, 128, 168}


@pytest.mark.parametrize("d", (8, 16, 24, 64, 112, 128, 168, 256))
def test_check_heads_accepts_the_set(d):
    k2.check_heads("k", d, 2 * 9, 2)
    if d in k3.HEAD_DIMS:
        k3.check_heads("k", "simt", d, 2 * 9, 2)


@pytest.mark.parametrize("d", (4, 12, 32, 96, 160, 176, 192, 512))
def test_other_head_dims_raise(d):
    """A head dim outside the covered set raises ValueError: no wrapper
    falls back to its plain version."""
    with pytest.raises(ValueError, match="head_dim"):
        k2.check_heads("k", d, 4, 2)
    with pytest.raises(ValueError, match="head_dim"):
        k3.check_heads("k", "simt", d, 4, 2)


def test_k3_tensor_cores_take_d128_only():
    """K3's tensor-core kernel takes D = 128 and, on tiles of 128 and 192
    columns zero past D, 112 and 168 (kimi-k2's and gemma3-27b's heads),
    any group; no other head dim."""
    k3.check_heads("k", "tensor_cores", 128, 48, 1)
    k3.check_heads("k", "tensor_cores", 168, 32, 16)
    k3.check_heads("k", "tensor_cores", 112, 64, 8)
    for d in (8, 24, 64):
        with pytest.raises(ValueError, match="head_dim"):
            k3.check_heads("k", "tensor_cores", d, 32, 16)
    with pytest.raises(ValueError, match="GQA"):
        k3.check_heads("k", "simt", 128, 80, 1)
    assert [k3.tc_max_pages(d) for d in (112, 128, 168)] == \
        [16384, 16384, 8192]


@pytest.mark.parametrize("d", (8, 24, 112, 168))
@pytest.mark.parametrize("kv", (torch.bfloat16, torch.int8, torch.float32))
def test_routes_send_other_head_dims_to_simt(d, kv):
    """bf16 q over a bf16 or int8 pool runs K1's, K2's and K5's tensor
    cores at D = 128 only, K3's at 112, 128 and 168; every other head dim
    runs their SIMT kernels."""
    want = "simt" if kv == torch.float32 else "tensor_cores"
    assert k2.route(torch.bfloat16, kv, d) == "simt"
    assert k3.route(torch.bfloat16, kv, d) == (
        want if d in (112, 168) else "simt")
    assert k2.route(torch.bfloat16, kv, 128) == want
    assert k3.route(torch.bfloat16, kv, 128) == want


def test_max_rep_at_the_new_head_dims():
    """The SIMT kernel's P @ V pass holds 8 rows a thread in 1024 // D
    whole groups of D / 4 threads (and the score pass 64 rows): 48 at
    D = 168 (gemma3-27b's group is 2), 64 at 112 and below."""
    assert [k2.max_rep(d) for d in (8, 16, 24, 64, 112, 128, 168, 256)] == \
        [64, 64, 64, 64, 64, 64, 48, 32]
    k2.check_heads("k", 168, 32, 16)
    with pytest.raises(ValueError, match="GQA"):
        k2.check_heads("k", 168, 49, 1)


@pytest.mark.parametrize("kernel", ("simt", "tensor_cores"))
def test_granite_group_of_48_plans_one_lane_a_block(kernel):
    """granite-34b's MQA group (48 heads on one KV head of 128) at K5's
    T = 5 lanes: 240 rows a KV head, past the tensor-core kernel's 64, so
    each block takes one lane of 48 rows (both kernels) and a slot's lanes
    take five lane groups; K2 (T = 1) one."""
    pl = k2.plan(8, 5, 48, 1, 128, 125, 16, kernel, 132)
    assert (pl.lanes, pl.groups) == (1, 5)
    assert pl.lanes * 48 <= (k2.TC_ROWS if kernel == "tensor_cores"
                             else k2.max_rep(128))
    assert k2.plan(8, 1, 48, 1, 128, 125, 16, kernel, 132).groups == 1
    k2.check_heads("k", 128, 48, 1)
