"""The split of K2's and K5's key range across the SMs, checked on the CPU.

K2 (``paged_decode_attention``) and K5 (``paged_verify_attention``) run one
CUDA body (``csrc/paged_decode_split.cuh``) that splits each slot's keys at
fixed absolute positions, walks each split in 64-key tiles from its own
start (or the window's), and merges the splits' partials (m, l, acc) in
split order. ``emulate`` below does that walk in torch, row by row, in the
numerics of either kernel:

* SIMT (every mode but bf16 q over a bf16 or int8 pool at D = 128): fp32
  throughout, q scaled before the dot, K and V dequantized in fp32; held
  against the JAX Pallas kernels in interpret mode at 1e-5, and its K5
  lane t against its K2 at length q_pos + 1 bit for bit, the identity
  chip_smoke.py asserts on the card;
* tensor cores: bf16 q, exact int8 codes (or bf16 values), the K scale and
  the softmax scale on the fp32 score, the V scale folded into P before P
  is rounded to bf16; held against the Pallas kernels at chip_smoke.py's
  bf16 gate (5e-3 absolute plus 1e-2 relative).

Then the planner (``paged_decode_attention.plan``, shapes only) and the
route rules.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import paged_decode_attention as k2
from repro_torch.kernels import ref


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


TILE = 64                           # the kernels' key tile
ATOL, RTOL = 5e-3, 1e-2             # chip_smoke.py MODES' bf16 gate
SMS = 132                           # an H100 SXM


def emulate(q, k_pool, v_pool, table, lengths, *, scale, window=-1,
            k_scale=None, v_scale=None, split, lanes, tc=False):
    """What the split kernel computes for q (B, T, H, D) (K2: T = 1) with
    splits of ``split`` keys and ``lanes`` lanes a block: fp32 (B, T, H, D),
    zeros for rows with no key."""
    b_n, t_n, h, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    rep = h // hkv
    cap = table.shape[1] * ps
    out = torch.zeros((b_n, t_n, h, d))
    neg = torch.tensor(ref.NEG_INF)
    for b in range(b_n):
        ln = int(lengths[b])
        for kvh in range(hkv):
            for t_lo in range(0, t_n, lanes):
                nl = min(lanes, t_n - t_lo)
                q_first = ln - t_n + t_lo
                hi = min(q_first + nl, cap) if ln > 0 else 0
                lo = max(0, q_first + 1 - window) if window > 0 else 0
                if hi <= lo:
                    continue                    # no row has a key: zeros
                splits = range(lo // split, (hi - 1) // split + 1)
                for lane in range(t_lo, t_lo + nl):
                    q_pos = ln - t_n + lane
                    r_lo = max(0, q_pos + 1 - window) if window > 0 else 0
                    for hh in range(kvh * rep, (kvh + 1) * rep):
                        parts = [_split_part(
                            q[b, lane, hh], k_pool, v_pool, table[b],
                            k_scale, v_scale, kvh, scale, tc,
                            max(s * split, lo), min((s + 1) * split, hi),
                            r_lo, min(q_pos + 1, cap), neg)
                            for s in splits]
                        out[b, lane, hh] = _combine(parts, tc)
    return out


def _split_part(q_row, k_pool, v_pool, table_row, k_scale, v_scale, kvh,
                scale, tc, k0, k1, r_lo, r_hi, neg):
    """One row's (m, l, acc) over keys [k0, k1) in whole 64-key tiles
    from k0 (zeros past k1, as the kernels load them, so every tile's sums
    run over 64 terms); keys outside [r_lo, r_hi) add p = 0 with
    alpha = 1."""
    ps = k_pool.shape[1]
    d = q_row.shape[-1]
    m, l, acc = neg.clone(), torch.zeros(()), torch.zeros(d)
    qf = q_row.float() if tc else q_row.float() * scale
    for kt0 in range(k0, k1, TILE):
        keys = torch.arange(kt0, kt0 + TILE)
        live = keys < k1
        page = table_row[torch.where(live, keys, k0) // ps].long()
        off = keys % ps
        kk = k_pool[page, off, kvh].float() * live[:, None]
        vv = v_pool[page, off, kvh].float() * live[:, None]
        if k_scale is None:
            ks = vs = live.float()
        else:
            ks = k_scale[page, off, kvh] * live
            vs = v_scale[page, off, kvh] * live
        if tc:                              # exact codes, scales on S and P
            s = (qf * kk).sum(-1) * ks * scale
        else:                               # fp32, dequantized first
            s = (qf * (kk * ks[:, None])).sum(-1)
            vv = vv * vs[:, None]
        ok = (keys >= r_lo) & (keys < min(r_hi, k1))
        s = torch.where(ok, s, neg)
        m_new = torch.maximum(m, s.max())
        p = torch.where(ok, torch.exp(s - m_new), torch.zeros(()))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum()
        if tc:
            p = (p * vs).bfloat16().float()
        acc = acc * alpha + (p[:, None] * vv).sum(0)
        m = m_new
    return m, l, acc


def _combine(parts, tc):
    """The in-order merge: one split's partial is its output; else weights
    exp(m_j - max m), summed from zero in split order."""
    if len(parts) == 1:
        _, l, acc = parts[0]
    else:
        m_max = torch.stack([m for m, _, _ in parts]).max()
        l, acc = torch.zeros(()), torch.zeros_like(parts[0][2])
        for m, l_j, acc_j in parts:
            f = torch.exp(m - m_max)
            l = f * l_j + l
            acc = f * acc_j + acc
    out = acc * (1.0 / torch.clamp(l, min=1e-30))
    return out.bfloat16().float() if tc else out


def _case(seed, *, b, t, hkv, rep, d, ps, nb, kv, q_dtype, lengths):
    """numpy inputs: q (b, t, H, d) in q_dtype, pools of b * nb pages plus
    the sink through a permuted table, int8 codes with (P, ps, Hkv) scales
    or fp values in the pool's dtype."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))     # noqa: E731
    q = rng.standard_normal((b, t, hkv * rep, d)).astype(np.float32)
    q = bf(q) if q_dtype == "bfloat16" else q
    shape = (b * nb + 1, ps, hkv, d)
    if kv == "int8":
        k_pool = rng.integers(-127, 128, shape).astype(np.int8)
        v_pool = rng.integers(-127, 128, shape).astype(np.int8)
        scales = tuple((rng.random(shape[:-1]) * 0.02 + 1e-3
                        ).astype(np.float32) for _ in range(2))
    else:
        k_pool = rng.standard_normal(shape).astype(np.float32)
        v_pool = rng.standard_normal(shape).astype(np.float32)
        if kv == "bfloat16":
            k_pool, v_pool = bf(k_pool), bf(v_pool)
        scales = (None, None)
    table = rng.permutation(b * nb).astype(np.int32).reshape(b, nb)
    return (q, k_pool, v_pool, table,
            np.array(lengths, np.int32)), scales


def _torch(a):
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _pallas(args, scales, *, scale, window, verify):
    q, k_pool, v_pool, table, lengths = map(jnp.asarray, args)
    kw = {} if scales[0] is None else {"k_scale": jnp.asarray(scales[0]),
                                       "v_scale": jnp.asarray(scales[1])}
    if verify:
        out = jops.paged_verify_attention(q, k_pool, v_pool, table, lengths,
                                          scale=scale, window=window,
                                          interpret=True, **kw)
    else:
        out = jops.paged_decode_attention(q[:, 0], k_pool, v_pool, table,
                                          lengths, scale=scale, window=window,
                                          interpret=True, **kw)[:, None]
    return np.asarray(out).astype(np.float32)


def _has_key(lengths, t):
    """(B, T): the rows with a valid key (a live slot, q_pos >= 0)."""
    q_pos = lengths[:, None] - t + np.arange(t)[None]
    return (lengths[:, None] > 0) & (q_pos >= 0)


def _emulated(args, scales, *, scale, window, kernel):
    q, k_pool, v_pool, table, lengths = map(_torch, args)
    b, t, h, d = q.shape
    hkv = k_pool.shape[2]
    pl = k2.plan(b, t, h, hkv, d, table.shape[1], k_pool.shape[1], kernel,
                 SMS, window)
    return emulate(q, k_pool, v_pool, table, lengths, scale=scale,
                   window=window, k_scale=_torch(scales[0]),
                   v_scale=_torch(scales[1]), split=pl.split, lanes=pl.lanes,
                   tc=kernel == "tensor_cores"), pl


# SIMT: D = 64, H = 6 over Hkv = 2, pages of 8, 24 a slot (a capacity of
# 192 keys: three 64-key splits); lengths: a dead slot, 1 (below T = 3:
# rows with no key), a split edge and one past it, the capacity, and 130
# (a window of 70 starts inside the second split and inside a page)
SIMT = dict(b=6, hkv=2, rep=3, d=64, ps=8, nb=24)
SIMT_LENGTHS = (0, 1, 64, 65, 192, 130)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("window", [-1, 70])
@pytest.mark.parametrize("t", [1, 3])
def test_simt_split_matches_pallas(t, window, kv):
    args, scales = _case(1, t=t, kv=kv, q_dtype="float32",
                         lengths=SIMT_LENGTHS, **SIMT)
    scale = 64 ** -0.5
    got, pl = _emulated(args, scales, scale=scale, window=window,
                        kernel="simt")
    assert pl.n_splits == 3 and pl.split == 64
    want = _pallas(args, scales, scale=scale, window=window, verify=t > 1)
    key = _has_key(args[4], t)
    assert np.abs(got.numpy()[key] - want[key]).max() < 1e-5
    assert (got.numpy()[~key] == 0.0).all()


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_simt_k5_lanes_equal_k2_bit_for_bit(kv):
    """K5's lane t equals K2 at length q_pos + 1 exactly, also where the
    lanes' block spans more splits than the lane (a split edge inside the
    T lanes) and with lanes in two groups."""
    t = 4
    args, scales = _case(2, t=t, kv=kv, q_dtype="float32",
                         lengths=(0, 2, 65, 66, 130, 192), **SIMT)
    q, k_pool, v_pool, table, lengths = map(_torch, args)
    kw = dict(scale=0.125, k_scale=_torch(scales[0]),
              v_scale=_torch(scales[1]), split=64)
    for lanes in (t, 3):
        got = emulate(q, k_pool, v_pool, table, lengths, lanes=lanes, **kw)
        for lane in range(t):
            want = emulate(q[:, lane:lane + 1], k_pool, v_pool, table,
                           (lengths - t + lane + 1).clamp(min=0), lanes=1,
                           **kw)
            assert torch.equal(got[:, lane], want[:, 0])


# tensor cores: D = 128, H = 18 over Hkv = 2 (starcoder2-7b's GQA group of
# 9), pages of 16, 20 a slot (320 keys: five 64-key splits); lengths: a
# dead slot, 3 (below T = 5: a lane with no key), 300 (a window of 256
# starts inside the first split and a page) and 128 (a split edge)
TC = dict(b=4, hkv=2, rep=9, d=128, ps=16, nb=20)
TC_LENGTHS = (0, 3, 300, 128)


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("window", [-1, 256])
@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_tc_split_within_the_card_gate(kv, window, t):
    args, scales = _case(3, t=t, kv=kv, q_dtype="bfloat16",
                         lengths=TC_LENGTHS, **TC)
    scale = 128 ** -0.5
    got, pl = _emulated(args, scales, scale=scale, window=window,
                        kernel="tensor_cores")
    assert pl.n_splits == 5 and pl.lanes == t and t * 9 <= k2.TC_ROWS
    want = _pallas(args, scales, scale=scale, window=window, verify=t > 1)
    key = _has_key(args[4], t)
    g, w = got.numpy()[key], want[key]
    assert (np.abs(g - w) <= ATOL + RTOL * np.abs(w)).all(), \
        np.abs(g - w).max()
    assert (got.numpy()[~key] == 0.0).all()
    # the one rounding the fp32 plain version does not make (P to bf16)
    # keeps the two inside the gate of each other
    q, k_pool, v_pool, table, lengths = map(_torch, args)
    kw = dict(scale=scale, window=window, k_scale=_torch(scales[0]),
              v_scale=_torch(scales[1]))
    plain = (ref.paged_verify_attention_ref(q, k_pool, v_pool, table,
                                            lengths, **kw) if t > 1 else
             ref.paged_decode_attention_ref(q[:, 0], k_pool, v_pool, table,
                                            lengths, **kw)[:, None])
    plain = plain.float().numpy()
    assert (np.abs(got.numpy() - plain)
            <= ATOL + RTOL * np.abs(plain)).all()


# (capacity, page size, (slot, KV head) pairs, SMs, window) -> (keys a
# split, splits of the capacity): starcoder2-7b's main path, a capacity no
# split divides, pages of 48 (a split of lcm(64, 48) = 192 keys at
# least), one pair (32 splits of the keys a row sees at most), a small
# table, an empty one, many pairs, and windows of 256, 300 and 4096 (the
# splits cut the window's keys, not the capacity's)
PLANS = [((2048, 16, 32, 132, -1), (256, 8)),
         ((2000, 16, 32, 132, -1), (256, 8)),
         ((4096, 48, 32, 132, -1), (576, 8)),
         ((131072, 16, 1, 132, -1), (4096, 32)),
         ((320, 16, 8, 132, -1), (64, 5)), ((0, 16, 32, 132, -1), (64, 1)),
         ((2048, 16, 256, 132, -1), (1024, 2)),
         ((2048, 16, 32, 132, 256), (64, 32)),
         ((2000, 16, 32, 132, 300), (64, 32)),
         ((131072, 16, 1, 132, 4096), (128, 1024))]


@pytest.mark.parametrize("shape,want", PLANS,
                         ids=["x".join(map(str, s)) for s, _ in PLANS])
def test_split_plan(shape, want):
    capacity, page_size, pairs, sms, window = shape
    split, n = k2.split_plan(*shape)
    assert (split, n) == want
    # whole tiles and whole pages, and every key below the capacity in
    # exactly one split
    assert split % TILE == 0 and split % page_size == 0 and n >= 1
    owner = np.arange(capacity) // split
    assert owner.max(initial=0) < n and (capacity == 0 or owner[-1] == n - 1)
    assert np.array_equal(np.bincount(owner, minlength=n)[:-1],
                          np.full(n - 1, split))


def test_plan_reads_shapes_only():
    """Neither the planner nor the launch plan takes the lengths: a host
    read of them would cost a device sync a layer and change the grid from
    tick to tick."""
    for fn in (k2.split_plan, k2.plan):
        assert "length" not in " ".join(inspect.signature(fn).parameters)


@pytest.mark.parametrize("window", [-1, 256])
@pytest.mark.parametrize("kernel", ["tensor_cores", "simt"])
def test_k2_and_k5_split_alike_and_cover_the_sms(kernel, window):
    """At one capacity and window K2 (T = 1) and K5 (T = 2, 5, 8: 8 lanes
    take two lane groups) split the keys at the same places; the grid's
    splits (at most MAX_SPLITS) hold every key a block's rows can see,
    wherever the window starts; and at the main path's shapes the grid
    covers the 132 SMs."""
    k2_plan = k2.plan(8, 1, 36, 4, 128, 128, 16, kernel, SMS, window)
    for t in (1, 2, 5, 8):
        pl = k2.plan(8, t, 36, 4, 128, 128, 16, kernel, SMS, window)
        assert pl.split == k2_plan.split
        assert pl.lanes * pl.groups >= t and pl.lanes * 9 <= 64
        assert 1 <= pl.n_splits <= k2.MAX_SPLITS
        span = 2048 if window < 0 else window + min(t, pl.lanes) - 1
        touched = max(len(range(lo // pl.split,
                                (min(lo + span, 2048) - 1) // pl.split + 1))
                      for lo in range(0, 2048 - span + 1 if window > 0 else 1))
        assert touched <= pl.n_splits
    assert k2_plan.n_splits * 4 * 8 >= SMS
    if window < 0:
        assert (k2_plan.split, k2_plan.n_splits) == (256, 8)
        p8 = k2.plan(8, 8, 36, 4, 128, 128, 16, kernel, SMS)
        assert (p8.lanes, p8.groups, p8.units) == (7, 2, 64)
        assert p8.ws_floats == 64 * 8 * 7 * 9 * 132


@pytest.mark.parametrize("q_dtype,kv_dtype,d,want", [
    (torch.bfloat16, torch.int8, 128, "tensor_cores"),
    (torch.bfloat16, torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, torch.float32, 128, "simt"),
    (torch.float32, torch.int8, 128, "simt"),
    (torch.float32, torch.float32, 128, "simt"),
    (torch.bfloat16, torch.int8, 64, "simt"),
    (torch.bfloat16, torch.bfloat16, 256, "simt")])
def test_route(q_dtype, kv_dtype, d, want):
    """bf16 q over a bf16 or int8 pool at D = 128 on the tensor cores; the
    fp32 pool (the unquantized serve mode), fp32 q (the stream identity
    runs) and other head dims on the SIMT kernel: no mode is refused."""
    assert k2.route(q_dtype, kv_dtype, d) == want
