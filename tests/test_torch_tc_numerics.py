"""The numerics of the port's tensor-core kernels, checked on the CPU.

K3's tensor-core kernel (bf16 q over a bf16 or int8 pool,
``csrc/paged_prefill_attention.cu``) does not compute in fp32 throughout
as its plain version does: the int8 codes enter the bf16 MMAs exactly, the
per-key K scale multiplies the fp32 score, the per-key V scale is folded
into P, and P is rounded to bf16 before P.V. ``tc_prefill`` below emulates
exactly that in torch, with the kernel's own walk (128 query rows of one
head a block; the cached prefix, then the chunk, in 64-key tiles; the
online softmax per tile, so P is rounded against the running max of its
tile; at head dims 112 and 168 on tiles of 128 and 192 columns, zero past
D). Held against the JAX Pallas ``paged_prefill_attention`` in
interpret mode at chip_smoke.py's bf16 gate (5e-3 absolute plus 1e-2
relative), it shows here that the design can pass the card's gate: the
one extra rounding, P to bf16 (2^-9 relative a term), stays inside it.

K4's wgmma kernel changes only the order of the fp32 sum; what the CPU
can check is its planner (``int8_matmul.wgmma_plan``: rows of x a block,
K splits, the grid against the SMs, the shapes that raise), the routing
rules of both wrappers, and that the planner's splits reproduce the plain
product when summed in split order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import int8_matmul as k4
from repro_torch.kernels import paged_prefill_attention as k3
from repro_torch.kernels import ref

ROWS, KEYS = 128, 64                # the tensor-core kernel's tiles
ATOL, RTOL = 5e-3, 1e-2             # chip_smoke.py MODES' bf16 gate
SMS = 132                           # an H100 SXM


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The emulations' ops are far below any parallel grain: one torch
    thread while this file runs (idle intra-op threads cost a loaded host
    several times its run time), the worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tc_prefill(q, k_new, v_new, k_pool, v_pool, table, starts, lens, *,
               scale, window=-1, k_scale=None, v_scale=None):
    """What the tensor-core K3 computes: q (B, C, H, D) bf16; k_new/v_new
    bf16; pools bf16, or int8 codes with (P, page_size, Hkv) fp32 scales.
    Returns (B, C, H, D) bf16: a padding token past a live row's length
    attends the row's keys, a dead row is zeros. The tiles hold D rounded
    up to 64 columns (112 -> 128, 168 -> 192), zero past D in shared
    memory: the walk runs on operands zero-padded so, and the output
    keeps the first D columns."""
    d_in = q.shape[-1]
    pad = -(-d_in // 64) * 64 - d_in
    q, k_new, v_new, k_pool, v_pool = (
        torch.nn.functional.pad(x, (0, pad))
        for x in (q, k_new, v_new, k_pool, v_pool))
    b_n, c, h, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    rep = h // hkv
    nb = table.shape[1]
    out = torch.zeros((b_n, c, h, d))
    for b in range(b_n):
        start = min(max(int(starts[b]), 0), nb * ps)
        ln = min(int(lens[b]), c)
        for t0 in range(0, c, ROWS):
            if ln <= 0:
                continue
            kp_lo = max(0, start + t0 - window + 1) if window > 0 else 0
            kp_end = start + min(ln, t0 + ROWS)
            tiles = [(k0, min(k0 + KEYS, start), True)
                     for k0 in range(kp_lo, start, KEYS)]
            tiles += [(k0, min(k0 + KEYS, kp_end), False)
                      for k0 in range(max(kp_lo, start), kp_end, KEYS)]
            rows = torch.arange(t0, min(t0 + ROWS, c))
            q_abs = (start + rows)[None, :, None]
            qh = q[b, rows].float().transpose(0, 1)            # (H, R, D)
            m = torch.full((h, len(rows), 1), ref.NEG_INF)
            l = torch.zeros((h, len(rows), 1))
            o = torch.zeros((h, len(rows), d))
            for k0, k_end, cached in tiles:
                kp = torch.arange(k0, k_end)
                if cached:
                    page = table[b, kp // ps].long()
                    kk, vv = k_pool[page, kp % ps], v_pool[page, kp % ps]
                    if k_scale is not None:
                        ks = k_scale[page, kp % ps]             # (n, Hkv)
                        vs = v_scale[page, kp % ps]
                    else:
                        ks = vs = torch.ones((len(kp), hkv))
                else:
                    kk, vv = k_new[b, kp - start], v_new[b, kp - start]
                    ks = vs = torch.ones((len(kp), hkv))
                # exact codes (or bf16 values) in the MMAs, per head
                kh = kk.float().transpose(0, 1).repeat_interleave(rep, 0)
                vh = vv.float().transpose(0, 1).repeat_interleave(rep, 0)
                ksh = ks.t().repeat_interleave(rep, 0)[:, None, :]
                vsh = vs.t().repeat_interleave(rep, 0)[:, None, :]
                s = (qh @ kh.transpose(1, 2)) * ksh * scale
                ok = kp[None, None, :] <= q_abs
                if window > 0:
                    ok &= q_abs - kp[None, None, :] < window
                s = torch.where(ok, s, torch.tensor(ref.NEG_INF))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.where(ok, torch.exp(s - m_new), torch.zeros(()))
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                p_bf = (p * vsh).bfloat16().float()             # P' in bf16
                o = o * alpha + p_bf @ vh
                m = m_new
            out[b, rows] = (o / l.clamp(min=1e-30)).transpose(0, 1)
    return out[..., :d_in].bfloat16()


# (H, Hkv) at each head dim: starcoder2-7b's group of 9 at 128, kimi-k2's
# of 8 at 112, gemma3-27b's of 2 at 168
K3_HEADS = {128: (18, 2), 112: (16, 2), 168: (4, 2)}


def _prefill_case(kv, seed=0, d=128):
    """B = 3 rows, C = 40 (no multiple of 64), K3_HEADS[d] heads (at 128
    H = 18 over Hkv = 2, a GQA group of 9, as starcoder2-7b's), pages of
    16 through a permuted table; starts 300 (unaligned; a window of 256
    then cuts a prefix tile), 37 and 0, chunk lengths 40, 23 and 0 (a dead
    row)."""
    rng = np.random.default_rng(seed)
    (h, hkv), b, c, ps, nb = K3_HEADS[d], 3, 40, 16, 24
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))     # noqa: E731
    q = bf(rng.standard_normal((b, c, h, d)))
    k_new = bf(rng.standard_normal((b, c, hkv, d)))
    v_new = bf(rng.standard_normal((b, c, hkv, d)))
    pages = b * nb
    shape = (pages + 1, ps, hkv, d)
    if kv == "int8":
        k_pool = rng.integers(-127, 128, shape).astype(np.int8)
        v_pool = rng.integers(-127, 128, shape).astype(np.int8)
        scales = tuple((rng.random(shape[:-1]) * 0.02 + 1e-3
                        ).astype(np.float32) for _ in range(2))
    else:
        k_pool = bf(rng.standard_normal(shape))
        v_pool = bf(rng.standard_normal(shape))
        scales = (None, None)
    table = rng.permutation(pages).astype(np.int32).reshape(b, nb)
    starts = np.array([300, 37, 0], np.int32)
    lens = np.array([40, 23, 0], np.int32)
    return (q, k_new, v_new, k_pool, v_pool, table, starts, lens), scales


def _torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


TC_CASES = [(kv, w, d) for d in (128, 112, 168)
            for kv in ("int8", "bfloat16") for w in (-1, 256)]


@pytest.mark.parametrize("kv,window,d", TC_CASES, ids=[
    f"{kv}-{w}" + ("" if d == 128 else f"-d{d}") for kv, w, d in TC_CASES])
def test_tc_prefill_numerics_within_the_card_gate(kv, window, d):
    args, (ks, vs) = _prefill_case(kv, d=d)
    scale = d ** -0.5
    want = np.asarray(jops.paged_prefill_attention(
        *map(jnp.asarray, args), scale=scale, window=window, block_q=8,
        interpret=True, k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))).astype(np.float32)
    tk = dict(k_scale=None if ks is None else _torch(ks),
              v_scale=None if vs is None else _torch(vs))
    got = tc_prefill(*map(_torch, args), scale=scale, window=window,
                     **tk).float().numpy()
    # every lane of a live row, the padding lanes past its length too
    live = args[-1] > 0
    err = np.abs(got[live] - want[live])
    assert (err <= ATOL + RTOL * np.abs(want[live])).all(), err.max()
    # the emulation rounds where the fp32 plain version does not, and no
    # more: both sit inside the gate of each other
    plain = ref.paged_prefill_attention_ref(
        *map(_torch, args), scale=scale, window=window, **tk).float().numpy()
    assert np.abs(got - plain).max() <= ATOL + RTOL * np.abs(plain).max()
    assert (got[~live] == 0.0).all()


K3_ROUTES = [(torch.bfloat16, torch.int8, 128, "tensor_cores"),
             (torch.bfloat16, torch.bfloat16, 128, "tensor_cores"),
             (torch.bfloat16, torch.float32, 128, "simt"),
             (torch.float32, torch.int8, 128, "simt"),
             (torch.float32, torch.float32, 128, "simt"),
             (torch.bfloat16, torch.int8, 112, "tensor_cores"),
             (torch.bfloat16, torch.bfloat16, 168, "tensor_cores"),
             (torch.bfloat16, torch.int8, 168, "tensor_cores"),
             (torch.bfloat16, torch.float32, 168, "simt"),
             (torch.float32, torch.bfloat16, 112, "simt"),
             (torch.bfloat16, torch.int8, 64, "simt")]


@pytest.mark.parametrize("q_dtype,kv_dtype,d,want", K3_ROUTES, ids=[
    f"q_dtype{i}-kv_dtype{i}-{want}" + ("" if d == 128 else f"-d{d}")
    for i, (_, _, d, want) in enumerate(K3_ROUTES)])
def test_k3_route(q_dtype, kv_dtype, d, want):
    """fp32 pools (the unquantized serve mode) and fp32 q (the stream
    identity runs) stay on the SIMT kernel: TF32 would change them. bf16 q
    over a bf16 or int8 pool runs the tensor cores at D = 112, 128 and
    168, the SIMT kernel at any other head dim."""
    assert k3.route(q_dtype, kv_dtype, d) == want


@pytest.mark.parametrize("m,x_dtype,want", [
    (1, torch.bfloat16, "decode"), (8, torch.bfloat16, "decode"),
    (9, torch.bfloat16, "wgmma"), (40, torch.bfloat16, "wgmma"),
    (2048, torch.bfloat16, "wgmma"), (8, torch.float32, "simt"),
    (4096, torch.float32, "simt")])
def test_k4_regime(m, x_dtype, want):
    assert k4.regime(m, x_dtype) == want


# (M, N, K) -> (rows of x a block, K splits): a speculative tick's M = 40
# on starcoder2-7b's projections (wq/wo, wk/wv, w_in, w_out), an extend
# call's M = 2048, a training batch's 4096, and ragged shapes
PLANS = [((40, 4608, 4608), (64, 4)), ((40, 512, 4608), (64, 9)),
         ((40, 18432, 4608), (64, 1)), ((40, 4608, 18432), (64, 4)),
         ((2048, 18432, 4608), (256, 1)), ((2048, 4608, 18432), (192, 1)),
         ((2048, 512, 4608), (192, 3)), ((9, 16, 16), (64, 1)),
         ((100, 1008, 4608), (128, 9)), ((2047, 4624, 4608), (256, 1)),
         ((129, 4608, 4608), (192, 4)), ((4096, 18432, 4608), (256, 1))]


@pytest.mark.parametrize("shape,want", PLANS, ids=[
    "x".join(map(str, s)) for s, _ in PLANS])
def test_wgmma_plan(shape, want):
    m, n, k = shape
    tile_m, splits = k4.wgmma_plan(m, n, k, SMS)
    assert (tile_m, splits) == want
    tiles = -(-n // k4.TC_BN) * -(-m // tile_m)
    k_tiles = -(-k // k4.TC_BK)
    # the grid covers the SMs unless K is too short to split further (8 k
    # tiles a split at least), and no split is empty
    longest = max(1, min(k_tiles // k4.TC_MIN_SPLIT_TILES, k4.TC_MAX_SPLITS))
    assert tiles * splits >= min(SMS, tiles * longest)
    assert 1 <= splits <= min(k_tiles, k4.TC_MAX_SPLITS)
    # the kernel's split z sums k tiles [z kt / S, (z + 1) kt / S): every k
    # tile once, in order, and no split empty
    bounds = [z * k_tiles // splits for z in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == k_tiles
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
    # the tile holds M when M fits one, and wastes under a tile otherwise
    assert tile_m >= min(m, 192) and -(-m // tile_m) * tile_m - m < tile_m


@pytest.mark.parametrize("m,n,k", [(40, 1000, 4608), (2048, 4600, 4608),
                                   (40, 4608, 24), (8, 4608, 4608)])
def test_wgmma_plan_refuses(m, n, k):
    """N % 16 (TMA's 16-byte row stride on the weight), K % 16, or M <= 8
    (the decode kernel's)."""
    with pytest.raises(ValueError):
        k4.wgmma_plan(m, n, k, SMS)
