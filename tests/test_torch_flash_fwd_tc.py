"""The numerics of the flash forward's fp32 tensor-core kernel (K6, K10
with fp32 q), checked on the CPU (bf16 q runs a kernel of its own:
``test_torch_flash_fwd_bf16_tc.py``).

The forward kernel (``csrc/flash_attention.cu``, ``flash_fwd_tc_kernel``)
runs both products on the tensor cores in tf32, split so as to keep fp32
accuracy: each fp32 operand x = hi + lo with hi = tf32(x) and lo = tf32(x
- hi) (tf32: round to nearest, ties away, to 10 mantissa bits), and a
product A B as A_lo B_hi + A_hi B_lo + A_hi B_hi in fp32 (3xTF32). q is
scaled in fp32 and split as its tile is stored, K and V are widened to
fp32 (int8 codes times their row's scale) and split as theirs are, P as
it is made. The walk: each warpgroup's 64 query rows over the
32-key tiles from its block's first visible key (a block holds two
warpgroups; a tile that none of a warpgroup's rows sees changes nothing
there, so a 64-row walk gives the same values); an online softmax from m
= -1e30 with p masked explicitly and l summed from the fp32 P; each
tile's P V summed on its own and taken into O = O alpha + P V in fp32;
out = O / max(l, 1e-30), lse = m + log(max(l, 1e-30)). ``emulate_fwd``
below does exactly that in torch.
Held against the JAX Pallas forward in interpret mode (``_fwd_with_lse``,
K6's ``pallas_call``, for out and lse; ``ops.flash_attention`` in its
int8-KV mode for K10) at chip_smoke.py's fp32 gate (1e-4 of the max), it
shows that the design can pass the card's gate, and that plain TF32 (hi *
hi' only) does worse at the same inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_fa
from repro.kernels import ops as j_ops
from repro.quant import int8 as j_q8
from repro_torch.kernels import flash_attention as fa
from tests._bf16_planes import bf16x3

ROWS, KEYS = 64, 32                 # the forward's warpgroup rows and key tile
FP32_GATE = 1e-4                    # chip_smoke.py FLASH_TOL["float32"]
BLOCK = 32                          # the Pallas kernel's tiles here


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The emulations' ops are far below any parallel grain: one torch
    thread while this file runs (idle intra-op threads cost a loaded host
    several times its run time), the worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tf32(x):
    """x rounded to tf32 as cvt.rna.tf32.f32 rounds: add 0x1000 to the bit
    pattern and clear the low 13 bits (to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a @ b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """a @ b in plain TF32: only the hi * hi' term."""
    return tf32(a) @ tf32(b)


def _valid(qi, kj, sq, sk, causal, window):
    """(len(qi), len(kj)) valid pairs, the kernel's ``valid_pair``."""
    diff = qi[:, None] - kj[None, :]
    ok = (qi[:, None] < sq) & (kj[None, :] < sk)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    return ok


def _rows(x, lo, n):
    """Rows [lo, lo + n) of dim 1 of x, zeros past its end."""
    out = torch.zeros((x.shape[0], n) + tuple(x.shape[2:]), dtype=x.dtype)
    hi = min(lo + n, x.shape[1])
    if hi > lo:
        out[:, :hi - lo] = x[:, lo:hi]
    return out


def emulate_fwd(q, k, v, *, scale, causal, window, k_scale=None,
                v_scale=None, mm=mm3):
    """What the forward kernel computes: q (B, Sq, H, D) fp32, k/v (B, Sk,
    Hkv, D) fp32 or int8 codes with (B, Sk, Hkv) scales. Returns out (B,
    Sq, H, D) and lse (B, H, Sq) fp32. A head
    dim under 64 runs the D = 64 kernel on tiles zero past it, 112 the D =
    128 kernel, 168 its own kernel on planes of 192 columns
    (``flash_attention.kernel_dim``): the walk runs on zero-padded
    operands (exact zeros in every product, so 168's 21 k steps of 8 give
    the same values) and the output keeps the first D columns."""
    d_in = q.shape[-1]
    pad = fa.kernel_dim(d_in) - d_in
    kf, vf = k.float(), v.float()
    if k_scale is not None:                     # widened and scaled as stored
        kf, vf = kf * k_scale[..., None], vf * v_scale[..., None]
    q, kf, vf = (torch.nn.functional.pad(x, (0, pad)) for x in (q, kf, vf))
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    out = torch.zeros((b, sq, h, d))
    lse = torch.zeros((b, h, sq))
    for q0 in range(0, sq, ROWS):
        n_q = min(ROWS, sq - q0)
        qi = torch.arange(q0, q0 + ROWS)
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        k_hi = min(sk, q0 + n_q) if causal else sk
        qs = _rows(q.float(), q0, ROWS).permute(0, 2, 1, 3) * scale
        m = torch.full((b, h, ROWS), -1e30)
        l = torch.zeros((b, h, ROWS))
        acc = torch.zeros((b, h, ROWS, d))
        for k0 in range(k_lo // KEYS * KEYS, k_hi, KEYS):
            kj = torch.arange(k0, k0 + KEYS)
            kt = _rows(kf, k0, KEYS).permute(0, 2, 1, 3) \
                .repeat_interleave(rep, 1)                      # (B, H, K, D)
            vt = _rows(vf, k0, KEYS).permute(0, 2, 1, 3) \
                .repeat_interleave(rep, 1)
            s = mm(qs, kt.transpose(-1, -2))
            ok = _valid(qi, kj, sq, sk, causal, window)
            m_new = torch.maximum(m, torch.where(ok, s, -1e30).amax(-1))
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + mm(p, vt)
            m = m_new
        den = l.clamp_min(1e-30)
        out[:, q0:q0 + n_q] = (acc / den[..., None]).permute(
            0, 2, 1, 3)[:, :n_q]
        lse[:, :, q0:q0 + n_q] = (m + torch.log(den))[..., :n_q]
    return out[..., :d_in].to(q.dtype), lse


# (sq, sk, h, hkv, d, causal, window): both head dims; ragged lengths
# across the 64-row blocks and 32-key tiles, Sq < Sk, GQA groups of 1, 2
# and 3, windows that start inside a tile, a non-causal case
CASES = [
    (130, 130, 4, 2, 64, True, -1),
    (96, 160, 3, 1, 128, True, -1),
    (128, 128, 2, 2, 128, True, 40),
    (64, 96, 2, 1, 64, False, -1),
    (200, 200, 2, 1, 64, True, 70),
]
IDS = [f"sq{c[0]}sk{c[1]}h{c[2]}kv{c[3]}d{c[4]}{'c' if c[5] else 'f'}w{c[6]}"
       for c in CASES]
# the smoke configs' head dims (the D = 64 kernel on tiles zero past d)
SMALL = [
    (130, 130, 4, 2, 8, True, -1),
    (67, 96, 3, 1, 16, True, -1),
    (96, 96, 2, 2, 24, True, 40),
]
SMALL_IDS = [f"sq{c[0]}sk{c[1]}h{c[2]}kv{c[3]}d{c[4]}{'c' if c[5] else 'f'}"
             f"w{c[6]}" for c in SMALL]
# kimi-k2's and zamba2's 112 (the D = 128 kernel on tiles zero past it) and
# gemma3-27b's 168 (its own kernel, planes of 192 columns), gemma3's group
# of 2 and a window that starts inside a tile among them
WIDE = [
    (130, 130, 4, 2, 112, True, -1),
    (96, 160, 2, 1, 168, True, -1),
    (128, 128, 4, 2, 168, True, 40),
]
WIDE_IDS = [f"sq{c[0]}sk{c[1]}h{c[2]}kv{c[3]}d{c[4]}{'c' if c[5] else 'f'}"
            f"w{c[6]}" for c in WIDE]


def _inputs(case):
    sq, sk, h, hkv, d, _, _ = case
    rng = np.random.default_rng((CASES + SMALL + WIDE).index(case))
    shapes = ((1, sq, h, d), (1, sk, hkv, d), (1, sk, hkv, d))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@functools.partial(jax.jit, static_argnames=("statics",))
def _pallas_fwd(q, k, v, statics):
    return j_fa._fwd_with_lse(q, k, v, statics)


def _jax_fwd(case):
    """K6's Pallas kernel (``_fwd_with_lse``) in interpret mode: out (B, Sq,
    H, D) and lse (B, H, Sq). Keys padded to the tile sit past Sk, where the
    causal mask hides them from every row (Sq <= Sk) or none is padded."""
    sq, sk, _, _, d, causal, window = case
    assert (causal and sq <= sk) or sk % BLOCK == 0
    q, k, v = _inputs(case)

    def pad(x):
        return jnp.pad(jnp.asarray(x),
                       ((0, 0), (0, -x.shape[1] % BLOCK), (0, 0), (0, 0)))

    out, lse = _pallas_fwd(pad(q), pad(k), pad(v), statics=(
        d ** -0.5, causal, window, BLOCK, BLOCK, True))
    return np.asarray(out)[:, :sq], np.asarray(lse)[:, :, :sq, 0]


def _emulated(case, mm):
    sq, sk, h, hkv, d, causal, window = case
    q, k, v = (torch.from_numpy(x) for x in _inputs(case))
    out, lse = emulate_fwd(q, k, v, scale=d ** -0.5, causal=causal,
                           window=window, mm=mm)
    return out.numpy(), lse.numpy()


def _rel_errs(got, want):
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("case", CASES + WIDE, ids=IDS + WIDE_IDS)
def test_split_numerics_within_the_card_gate(case):
    """3xTF32 in the kernel's tile walk: out and lse within 1e-4 of the max
    of the Pallas forward's (with a margin of 10x: about 2^-21 a
    product)."""
    errs = _rel_errs(_emulated(case, mm3), _jax_fwd(case))
    assert max(errs) <= FP32_GATE / 10, errs


@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
def test_small_dims_within_the_card_gate(case):
    """Head dims 8, 16 and 24 on the D = 64 kernel's zero-padded tiles:
    out and lse within the fp32 gate's 10x margin of the Pallas
    forward's."""
    errs = _rel_errs(_emulated(case, mm3), _jax_fwd(case))
    assert max(errs) <= FP32_GATE / 10, errs


def test_plain_tf32_is_worse_than_the_split():
    """The split is needed: hi * hi' alone (plain TF32, about 2^-11 an
    operand) is at least 10x further from the Pallas forward than the
    split in out and in lse, in every case, and misses the fp32 gate in
    out in every case (about 4e-4 of the max, the split 3e-7 to 8e-7).
    Its lse stays within the gate in some cases (3e-5 to 2e-4 of the
    max, the split about 1e-7): lse is a log of a sum, which averages the
    products' rounding."""
    for case in CASES:
        want = _jax_fwd(case)
        split_errs = _rel_errs(_emulated(case, mm3), want)
        plain_errs = _rel_errs(_emulated(case, mm1), want)
        assert all(p >= 10 * s for p, s in zip(plain_errs, split_errs)), \
            (case, split_errs, plain_errs)
        assert plain_errs[0] > FP32_GATE, (case, plain_errs)


@pytest.mark.parametrize("s,window", [(96, -1), (130, 50)])
@pytest.mark.parametrize("d", [16, 64, 128, 112, 168])
def test_int8_kv_within_the_card_gate(s, window, d):
    """K10's int8-KV mode: codes times their row's scale in fp32, then the
    split, against the Pallas kernel's int8-KV mode (``ops.flash_attention``
    with ``k_scale``/``v_scale``) at the fp32 gate with the same 10x
    margin."""
    rng = np.random.default_rng(7 + s + d)
    b, h, hkv = 1, 4, 2
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kv = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((b, s, hkv, d)), jnp.float32)
        codes, sc = j_q8.quantize_rowwise(x)
        kv += [np.array(codes), np.array(sc)]
    kq, ks, vq, vs = kv
    want = np.asarray(j_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), scale=d ** -0.5,
        causal=True, window=window, block_q=BLOCK, block_k=BLOCK,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True))
    t = torch.from_numpy
    got, _ = emulate_fwd(t(q), t(kq), t(vq), scale=d ** -0.5, causal=True,
                         window=window, k_scale=t(ks), v_scale=t(vs))
    err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert err <= FP32_GATE / 10, err


def test_bf16_operands_are_tf32_exact():
    """What the bf16 forward (``flash_fwd_bf16_kernel``) rests on: bf16
    values and int8 codes are exact as bf16 (``bf16x3`` gives hi = x and
    mid = lo = 0; tf32 too, hi = x and lo = 0), so bf16 K and V and the
    codes enter its bf16 ``wgmma`` as they are stored, and S = Q K^T is
    exact products; a bf16 q scaled in fp32 is not exact as bf16 (mid or
    lo nonzero), which is why the kernel scales S after the product."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(4096).astype(
        np.float32)).to(torch.bfloat16).float()
    codes = torch.arange(-128, 128, dtype=torch.float32)
    for exact in (x, codes):
        hi, mid, lo = bf16x3(exact)
        assert torch.equal(hi, exact) and not mid.any() and not lo.any()
        hi, lo = split(exact)
        assert torch.equal(hi, exact) and not lo.any()
    _, mid_s, lo_s = bf16x3(x * 128 ** -0.5)
    assert mid_s.any() or lo_s.any()


@pytest.mark.parametrize("d", [8, 16, 24, 64, 128, 112, 168])
def test_forward_route(d):
    """K6 and K10 run their tensor-core kernel for fp32 and bf16 q at every
    head dim (the backward routes bf16 to its bf16 tensor-core kernels at
    every head dim too); any other dtype or head dim has no kernel."""
    for dt in (torch.float32, torch.bfloat16):
        assert fa.route(dt, d) == "tensor_cores"
    assert fa.route(torch.bfloat16, d) == "tensor_cores"
    with pytest.raises(ValueError):
        fa.route(torch.float16, d)
    with pytest.raises(ValueError):
        fa.route(torch.float32, 96)
    assert set(fa.flash_attention_fwd.launches_by_kernel) == \
        set(fa.flash_attention.launches_by_kernel) == {"tensor_cores"}
