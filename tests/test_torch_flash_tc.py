"""The numerics of K7's and K8's tensor-core kernels, checked on the CPU.

The fp32 backward kernels (``csrc/flash_attention.cu``,
``flash_bwd_dq_tc_kernel`` and ``flash_bwd_dkv_tc_kernel``) run every
product on the tensor cores in tf32, split so as to keep fp32 accuracy:
each fp32 operand x = hi + lo with hi = tf32(x) and lo = tf32(x - hi)
(tf32: round to nearest, ties away, to 10 mantissa bits), and a product
A B as A_lo B_hi + A_hi B_lo + A_hi B_hi in fp32 (3xTF32). Q, K, V and dO
are split as their tiles are stored, P and dS as they are made, and each
tile's product over the rows (dQ over keys, dV and dK over queries) is
summed on its own, then added to the running sum in fp32.
``emulate_dq`` and ``emulate_dkv`` below do exactly that in torch, with
the kernels' walks: K7 64 query rows a block over 32-key tiles from the
block's first visible key; K8 64 keys a block over the group's heads,
each over 32-query tiles, or, where its (key tile, batch, KV head)
blocks are fewer than the card's SMs (``flash_attention.dkv_split``), one
head a block, the heads' partial sums added in head order.
Held against the JAX Pallas backward in interpret mode, at chip_smoke.py's
fp32 gate (1e-4 of the max), they show the design can pass the card's
gate, and that plain TF32 (hi * hi' only) at the same inputs does not.
The head dims under 64 (8, 16, 24: the smoke configs') run the D = 64
kernels on tiles zero past d, 112 the D = 128 kernels and 168 kernels of
192 columns (whose register-only operands are split as they are read,
the same split), which the emulation does too.
The routing rule, K8's split rule and its block order are checked as
pure functions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

DQ_ROWS, DQ_KEYS = 64, 32           # K7's block rows and key tile
DKV_KEYS, DKV_ROWS = 64, 32         # K8's block keys and query tile
FP32_GATE = 1e-4                    # chip_smoke.py FLASH_TOL["float32"]
SMS = 132                           # the H100's SMs: K8's split rule


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
    """a @ b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32, each
    term a product of tf32 values (exact in fp32)."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """a @ b in plain TF32: only the hi * hi' term."""
    return tf32(a) @ tf32(b)


def _valid(qi, kj, sq, sk, causal, window):
    """(len(qi), len(kj)) valid pairs, the kernels' ``valid_pair``."""
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


def emulate_dq(q, k, v, dout, lse, delta, *, scale, causal, window, mm=mm3,
               keys=DQ_KEYS):
    """What K7's tensor-core kernel computes: fp32 q, k, v, dout (B, S, H,
    D), lse and delta (B, H, Sq). Returns dq (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    dq = torch.zeros_like(q)
    for q0 in range(0, sq, DQ_ROWS):
        n_q = min(DQ_ROWS, sq - q0)
        qi = torch.arange(q0, q0 + DQ_ROWS)
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        k_hi = min(sk, q0 + n_q) if causal else sk
        qs = _rows(q, q0, DQ_ROWS).permute(0, 2, 1, 3) * scale   # (B, H, R, D)
        do = _rows(dout, q0, DQ_ROWS).permute(0, 2, 1, 3)
        lse_r = _rows(lse.transpose(1, 2), q0, DQ_ROWS).transpose(1, 2)
        dl_r = _rows(delta.transpose(1, 2), q0, DQ_ROWS).transpose(1, 2)
        acc = torch.zeros((b, h, DQ_ROWS, d))
        for k0 in range(k_lo // keys * keys, k_hi, keys):
            kj = torch.arange(k0, k0 + keys)
            kt = _rows(k, k0, keys).permute(0, 2, 1, 3) \
                .repeat_interleave(rep, 1)                        # (B, H, K, D)
            vt = _rows(v, k0, keys).permute(0, 2, 1, 3) \
                .repeat_interleave(rep, 1)
            s = mm(qs, kt.transpose(-1, -2))
            dp = mm(do, vt.transpose(-1, -2))
            ok = _valid(qi, kj, sq, sk, causal, window)
            p = torch.where(ok, torch.exp(s - lse_r[..., None]), 0.0)
            acc = acc + mm(p * (dp - dl_r[..., None]), kt)
        dq[:, q0:q0 + n_q] = (acc * scale).permute(0, 2, 1, 3)[:, :n_q]
    return dq


def emulate_dkv(q, k, v, dout, lse, delta, *, scale, causal, window,
                mm=mm3, rows=DKV_ROWS, split=False):
    """What K8's tensor-core kernel computes. Returns (dk, dv) (B, Sk,
    Hkv, D), each GQA group summed in the kernel's order: head, then tile,
    in one running sum, or with ``split`` each head's tiles in a sum of its
    own and the heads' sums added in head order."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, sk, DKV_KEYS):
        n_k = min(DKV_KEYS, sk - k0)
        kj = torch.arange(k0, k0 + DKV_KEYS)
        q_lo = k0 if causal else 0
        q_hi = min(sq, k0 + n_k - 1 + window) if window > 0 else sq
        kt = _rows(k, k0, DKV_KEYS).permute(0, 2, 1, 3)           # (B, Hkv, K, D)
        vt = _rows(v, k0, DKV_KEYS).permute(0, 2, 1, 3)
        parts = []
        for r in range(rep):
            if split or r == 0:
                dk_acc = torch.zeros((b, hkv, DKV_KEYS, d))
                dv_acc = torch.zeros((b, hkv, DKV_KEYS, d))
            heads = torch.arange(hkv) * rep + r
            for q0 in range(q_lo // rows * rows, q_hi, rows):
                qi = torch.arange(q0, q0 + rows)
                qs = _rows(q, q0, rows)[:, :, heads].permute(0, 2, 1, 3) \
                    * scale                                       # (B, Hkv, R, D)
                do = _rows(dout, q0, rows)[:, :, heads].permute(0, 2, 1, 3)
                lse_r = _rows(lse.transpose(1, 2), q0, rows)[:, :, heads] \
                    .transpose(1, 2)                              # (B, Hkv, R)
                dl_r = _rows(delta.transpose(1, 2), q0, rows)[:, :, heads] \
                    .transpose(1, 2)
                st = mm(kt, qs.transpose(-1, -2))                 # (B, Hkv, K, R)
                dpt = mm(vt, do.transpose(-1, -2))
                ok = _valid(qi, kj, sq, sk, causal, window).t()
                pt = torch.where(ok, torch.exp(st - lse_r[:, :, None]), 0.0)
                dv_acc = dv_acc + mm(pt, do)
                dk_acc = dk_acc + mm(pt * (dpt - dl_r[:, :, None]), qs)
            if split:
                parts.append((dk_acc, dv_acc))
        if split:
            dk_acc, dv_acc = parts[0]
            for pk, pv in parts[1:]:
                dk_acc, dv_acc = dk_acc + pk, dv_acc + pv
        dk[:, k0:k0 + n_k] = dk_acc.permute(0, 2, 1, 3)[:, :n_k]
        dv[:, k0:k0 + n_k] = dv_acc.permute(0, 2, 1, 3)[:, :n_k]
    return dk, dv


# (sq, sk, h, hkv, causal, window): D = 64, the kernels' smaller head dim;
# Sq < Sk and ragged lengths cross the 64- and 32-row tiles
CASES = [
    (100, 130, 3, 1, True, -1),        # Sq < Sk, GQA rep 3
    (96, 96, 2, 2, True, 40),          # window, rep 1
    (70, 70, 6, 2, False, -1),         # non-causal, rep 3
    (65, 100, 3, 1, True, 33),         # window, Sq < Sk, rep 3
    (64, 64, 8, 2, True, 8),           # a smoke launcher's S 64, rep 4, window 8
]
IDS = [f"sq{c[0]}sk{c[1]}h{c[2]}kv{c[3]}{'c' if c[4] else 'f'}w{c[5]}"
       for c in CASES]
D = 64
# kimi-k2's and zamba2's head dim 112 (the D = 128 kernels on tiles zero
# past it) and gemma3-27b's 168 (kernels of 192 columns) on cases of CASES:
# a window with rep 1, Sq < Sk with rep 3
WIDE = [(CASES[1], 112), (CASES[0], 112), (CASES[1], 168), (CASES[0], 168)]
WIDE_IDS = [f"{IDS[CASES.index(c)]}d{d}" for c, d in WIDE]


def _inputs(case, d=D):
    sq, sk, h, hkv, _, _ = case
    rng = np.random.default_rng(CASES.index(case))
    shapes = ((1, sq, h, d), (1, sk, hkv, d), (1, sk, hkv, d), (1, sq, h, d))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@functools.lru_cache(maxsize=None)
def _jax_grads(case, d=D):
    """JAX's dq, dk, dv through the Pallas backward in interpret mode,
    jitted; once per module (the plain-TF32 test reuses the cases')."""
    sq, sk, h, hkv, causal, window = case
    q, k, v, ct = _inputs(case, d)

    @jax.jit
    def grads(q, k, v, ct):
        def f(q, k, v):
            return j_ops.flash_attention_train(
                q, k, v, scale=d ** -0.5, causal=causal, window=window,
                block_q=32, block_k=32, interpret=True)

        _, vjp = jax.vjp(f, q, k, v)
        return vjp(ct)

    return [np.asarray(x, np.float32)
            for x in grads(*(jnp.asarray(x) for x in (q, k, v, ct)))]


def _pad(x, dk):
    """x's last dim zero-padded to dk: the kernels' tiles in shared memory
    at a head dim under 64 (``flash_attention.kernel_dim``)."""
    return torch.nn.functional.pad(x, (0, dk - x.shape[-1]))


def _split(case, sms=SMS):
    """Whether K8 splits the case's groups over blocks on a card of
    ``sms`` SMs (B = 1)."""
    sq, sk, h, hkv, _, _ = case
    return fa.dkv_split(-(-sk // DKV_KEYS) * hkv, h // hkv, sms)


def _emulated(case, mm, d=D, sms=SMS):
    """The kernels' dq, dk, dv on a card of ``sms`` SMs, from the port's
    plain forward's out and lse as the backward on the card gets them; the
    walks run on tiles zero-padded to ``kernel_dim(d)`` columns, and the
    outputs' first d columns are kept."""
    sq, sk, h, hkv, causal, window = case
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(case, d))
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
    dk_ = fa.kernel_dim(d)
    q, k, v, dout = (_pad(x, dk_) for x in (q, k, v, dout))
    dq = emulate_dq(q, k, v, dout, lse, delta, mm=mm, **kw)
    dk, dv = emulate_dkv(q, k, v, dout, lse, delta, mm=mm,
                         split=_split(case, sms), **kw)
    return [x[..., :d].numpy() for x in (dq, dk, dv)]


def _rel_errs(got, want):
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("case,d", [(c, D) for c in CASES] + WIDE,
                         ids=IDS + WIDE_IDS)
def test_split_numerics_within_the_card_gate(case, d):
    """3xTF32 in the kernels' tile walks as an H100 runs them (168 too, on
    its 192-column kernels; K8 split over the group's heads where the
    case's blocks are fewer than the SMs): dq, dk and dv within 1e-4 of the
    max of JAX's (with a margin of 10x: about 2^-21 a product)."""
    errs = _rel_errs(_emulated(case, mm3, d), _jax_grads(case, d))
    assert max(errs) <= FP32_GATE / 10, errs


@pytest.mark.parametrize("case,d", [(c, D) for c in CASES if c[2] > c[3]]
                         + WIDE[3:], ids=[i for i, c in zip(IDS, CASES)
                                          if c[2] > c[3]] + WIDE_IDS[3:])
def test_group_walk_within_the_card_gate(case, d):
    """K8's walk over the whole group in one block, which shapes that fill
    the card run (one SM here, so no split): within the same margin."""
    assert _split(case) and not _split(case, 1)
    errs = _rel_errs(_emulated(case, mm3, d, sms=1), _jax_grads(case, d))
    assert max(errs) <= FP32_GATE / 10, errs


@pytest.mark.parametrize("d", [8, 16, 24])
@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[4]],
                         ids=[IDS[0], IDS[1], IDS[4]])
def test_small_dims_within_the_card_gate(case, d):
    """The smoke configs' head dims run the D = 64 kernels on tiles zero
    past d, K8 split over the group's heads at these shapes (rep 3 and 4;
    rep 1 walks its one head): the same 3xTF32 walks within the fp32
    gate's 10x margin."""
    assert _split(case) == (case[2] > case[3])
    errs = _rel_errs(_emulated(case, mm3, d), _jax_grads(case, d))
    assert max(errs) <= FP32_GATE / 10, errs


@pytest.mark.parametrize("d", [D, 168])
def test_plain_tf32_misses_the_fp32_gate(d):
    """The split is needed: hi * hi' alone (plain TF32, about 2^-11 an
    operand) puts dq, dk or dv outside the fp32 gate at the same inputs,
    in every case, at D = 64 and on the 168 kernels."""
    cases = CASES if d == D else [c for c, dd in WIDE if dd == d]
    for case in cases:
        errs = _rel_errs(_emulated(case, mm1, d), _jax_grads(case, d))
        assert max(errs) > FP32_GATE, (case, errs)


def test_tf32_rounding():
    """Round to nearest at 10 mantissa bits, ties away from zero, and the
    split's parts add up to x within 2^-22 relative."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -11 - 2 ** -23],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 1.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    hi, lo = split(y)
    for part in (hi, lo):
        assert torch.equal(part.view(torch.int32) & 0x1FFF,
                           torch.zeros_like(part, dtype=torch.int32))
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2 ** -22


@pytest.mark.parametrize("d", [8, 16, 24, 64, 128, 112, 168])
def test_route(d):
    """fp32 and bf16 run the tensor-core kernels at every head dim, 168
    included (``tests/test_torch_flash_bf16_tc.py`` for bf16); any other
    dtype or head dim has no kernel, and no other kernel is counted. The
    dims under 64 run the D = 64 kernels, 112 the D = 128 ones, 168
    kernels of 192 columns."""
    assert fa.kernel_dim(d) == {112: 128, 168: 192}.get(d, max(d, 64))
    assert fa.route(torch.float32, d) == "tensor_cores"
    assert fa.route(torch.bfloat16, d) == "tensor_cores"
    with pytest.raises(ValueError):
        fa.route(torch.float16, d)
    with pytest.raises(ValueError):
        fa.route(torch.float32, 96)
    assert set(fa.flash_attention_bwd_dq.launches_by_kernel) == \
        set(fa.flash_attention_bwd_dkv.launches_by_kernel) == \
        {"tensor_cores"}


def test_dkv_split_rule():
    """K8 splits a group over blocks only where its blocks would leave SMs
    idle and the group has heads to split: the smoke launcher's B 8 x S 64
    (16 blocks), not the D 128 training shape (256) nor gemma3-27b's 168
    at S 2048 (512); never a group of one head."""
    units = lambda sk, b, hkv: -(-sk // fa.DKV_KEYS) * b * hkv  # noqa: E731
    assert fa.dkv_split(units(64, 8, 2), 4, SMS)
    assert not fa.dkv_split(units(2048, 2, 4), 9, SMS)
    assert not fa.dkv_split(units(2048, 1, 16), 2, SMS)
    assert not fa.dkv_split(units(64, 8, 2), 1, SMS)
    assert fa.dkv_split(SMS - 1, 2, SMS) and not fa.dkv_split(SMS, 2, SMS)


# (sk, b, hkv, rep): the D 128 training shape and gemma3-27b's 168 (the
# grid fills the card), small shapes that split, a group of one
ORDER_CASES = [(2048, 2, 4, 9), (2048, 1, 16, 2), (130, 1, 1, 3),
               (64, 8, 2, 4), (64, 3, 2, 1), (1, 2, 4, 2)]


@pytest.mark.parametrize("sk,b,hkv,rep", ORDER_CASES)
def test_dkv_block_order(sk, b, hkv, rep):
    """Every (key tile, batch, KV head, head of the group) exactly once,
    no block launching before one whose key tile some more queries see
    under the causal mask (the heaviest first); where the grid fills the
    card, one block a (key tile, batch, KV head) walking the whole group,
    in the order of the kernels before the split."""
    order = fa.dkv_block_order(sk, b, hkv, rep, SMS)
    n_kt = -(-sk // fa.DKV_KEYS)
    split = fa.dkv_split(n_kt * b * hkv, rep, SMS)
    assert sorted((t, bb, hk, r0 + i) for t, bb, hk, r0, n in order
                  for i in range(n)) == \
        [(t, bb, hk, r) for t in range(n_kt) for bb in range(b)
         for hk in range(hkv) for r in range(rep)]
    assert len(order) == n_kt * b * hkv * (rep if split else 1)
    work = [(sk - t * fa.DKV_KEYS) * n for t, _, _, _, n in order]
    assert work == sorted(work, reverse=True)      # causal, Sq = Sk
    if not split:
        assert order == [(t, bb, hk, 0, rep) for t in range(n_kt)
                         for bb in range(b) for hk in range(hkv)]
