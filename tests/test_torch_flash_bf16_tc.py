"""The numerics of K7's and K8's bf16 tensor-core kernels, checked on the CPU.

The bf16 backward kernels (``csrc/flash_attention.cu``,
``flash_bwd_dq_bf16_kernel`` and ``flash_bwd_dkv_bf16_kernel``) compute
the Pallas backward's function, which upcasts its bf16 inputs to fp32:
S = Q K^T and dP = dO V^T have bf16 on both sides, so each 16-deep step
of bf16 ``wgmma`` sums exact products in fp32; p = exp(scale S - lse)
and dS = p (dP - delta) are fp32; and the products over the rows (dQ +=
dS K, dV += P^T dO, dK += dS^T Q) take their fp32 operand (P or dS) in
three exact bf16 planes, split on the bit pattern (hi = the top 16 bits,
mid the top 16 of the rest, lo what is left: hi + mid + lo == x), each
multiplied by the bf16 tile, each tile's sum on its own and then added to
the running fp32 sum. ``emulate_dq`` and ``emulate_dkv`` below do exactly
that in torch, with the kernels' walks: K7 64 query rows a block over
64-key tiles from the block's first visible key, K8 64 keys a block over
the group's heads, each over 64-query tiles, or, where its (key tile,
batch, KV head) blocks are fewer than the card's SMs
(``flash_attention.dkv_split``: every case here with a group of more than
one head), one head a block, the heads' sums added in head order; dq and
dk are scaled once at the end.

Held against the JAX Pallas backward in interpret mode: the fp32
accumulators (before the bf16 cast) against Pallas run on the same bf16
values upcast to fp32, which computes the same function, at the fp32
gate of ``test_torch_flash_tc.py`` (1e-4 of the max); the bf16 outputs
against Pallas run in bf16 at chip_smoke.py's bf16 gate (1e-2 of the max
plus 1e-3). The same walk with P and dS rounded to one bf16 plane (as
bf16 SDPA does) is reported beside three planes and must do measurably
worse. Head dims 8, 16 and 24 (the D = 64 kernel, tiles zero past them),
64, 112 (the D = 128 kernel), 128 and 168 (tiles of 192 columns), GQA
groups 1, 3 and 4, windows -1, 8 and 300, one non-causal case, ragged
lengths; K8's walk over the whole group (shapes that fill the card) too.
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
from tests._bf16_planes import bf16x3, dots16, planes1, planes3

# K7's rows and key tiles; K8's keys and query tiles
TILE = 64
FP32_GATE = 1e-4                    # chip_smoke.py FLASH_TOL["float32"]
BF16_GATE, BF16_ATOL = 1e-2, 1e-3   # chip_smoke.py FLASH_TOL, FLASH_ATOL
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


def emulate_dq(q, k, v, dout, lse, delta, *, scale, causal, window,
               mm=planes3):
    """K7's bf16 tensor-core kernel on fp32 tensors holding bf16 values:
    q, dout (B, Sq, H, D), k, v (B, Sk, Hkv, D), lse and delta (B, H, Sq).
    Returns dq (B, Sq, H, D) in fp32, before the kernel's bf16 cast."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    dq = torch.zeros_like(q)
    for q0 in range(0, sq, TILE):
        n_q = min(TILE, sq - q0)
        qi = torch.arange(q0, q0 + TILE)
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        k_hi = min(sk, q0 + n_q) if causal else sk
        qs = _rows(q, q0, TILE).permute(0, 2, 1, 3)              # (B, H, R, D)
        do = _rows(dout, q0, TILE).permute(0, 2, 1, 3)
        lse_r = _rows(lse.transpose(1, 2), q0, TILE).transpose(1, 2)
        dl_r = _rows(delta.transpose(1, 2), q0, TILE).transpose(1, 2)
        acc = torch.zeros((b, h, TILE, d))
        for k0 in range(k_lo // TILE * TILE, k_hi, TILE):
            kj = torch.arange(k0, k0 + TILE)
            kt = _rows(k, k0, TILE).permute(0, 2, 1, 3) \
                .repeat_interleave(rep, 1)                       # (B, H, K, D)
            vt = _rows(v, k0, TILE).permute(0, 2, 1, 3) \
                .repeat_interleave(rep, 1)
            s = dots16(qs, kt) * scale
            dp = dots16(do, vt)
            ok = _valid(qi, kj, sq, sk, causal, window)
            p = torch.where(ok, torch.exp(s - lse_r[..., None]), 0.0)
            acc = acc + mm(p * (dp - dl_r[..., None]), kt)
        dq[:, q0:q0 + n_q] = (acc * scale).permute(0, 2, 1, 3)[:, :n_q]
    return dq


def emulate_dkv(q, k, v, dout, lse, delta, *, scale, causal, window,
                mm=planes3, split=False):
    """K8's bf16 tensor-core kernel on the inputs of ``emulate_dq``.
    Returns (dk, dv) (B, Sk, Hkv, D) in fp32, before the bf16 cast, each
    GQA group summed in the kernel's order: head, then query tile, in one
    running sum, or with ``split`` each head's tiles in a sum of its own
    and the heads' sums added in head order."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, sk, TILE):
        n_k = min(TILE, sk - k0)
        kj = torch.arange(k0, k0 + TILE)
        q_lo = k0 if causal else 0
        q_hi = min(sq, k0 + n_k - 1 + window) if window > 0 else sq
        kt = _rows(k, k0, TILE).permute(0, 2, 1, 3)            # (B, Hkv, K, D)
        vt = _rows(v, k0, TILE).permute(0, 2, 1, 3)
        parts = []
        for r in range(rep):
            if split or r == 0:
                dk_acc = torch.zeros((b, hkv, TILE, d))
                dv_acc = torch.zeros((b, hkv, TILE, d))
            heads = torch.arange(hkv) * rep + r
            for q0 in range(q_lo // TILE * TILE, q_hi, TILE):
                qi = torch.arange(q0, q0 + TILE)
                qs = _rows(q, q0, TILE)[:, :, heads].permute(0, 2, 1, 3)
                do = _rows(dout, q0, TILE)[:, :, heads].permute(0, 2, 1, 3)
                lse_r = _rows(lse.transpose(1, 2), q0, TILE)[:, :, heads] \
                    .transpose(1, 2)                              # (B, Hkv, R)
                dl_r = _rows(delta.transpose(1, 2), q0, TILE)[:, :, heads] \
                    .transpose(1, 2)
                st = dots16(kt, qs) * scale                    # (B, Hkv, K, R)
                dpt = dots16(vt, do)
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
        dk[:, k0:k0 + n_k] = (dk_acc * scale).permute(0, 2, 1, 3)[:, :n_k]
        dv[:, k0:k0 + n_k] = dv_acc.permute(0, 2, 1, 3)[:, :n_k]
    return dk, dv


# (sq, sk, h, hkv, causal, window, d): ragged lengths across the 64-row
# tiles, every head-dim family of the kernels, groups of 1 and 3, windows
# -1 and 300, one non-causal case
CASES = [
    (100, 130, 3, 1, True, -1, 64),        # Sq < Sk, group 3
    (70, 70, 6, 2, False, -1, 8),          # non-causal, group 3, smoke dim
    (97, 97, 3, 1, True, -1, 112),         # group 3, the D = 128 kernel
    (65, 65, 2, 2, True, -1, 168),         # group 1, 192-column tiles
    (330, 330, 2, 2, True, 300, 128),      # window 300, group 1
    (320, 320, 3, 1, True, 300, 168),      # window 300, group 3
    (64, 64, 8, 2, True, 8, 16),           # a smoke launcher's S 64, group 4
    (67, 67, 4, 2, True, -1, 24),          # odd length, group 2
]
IDS = [f"sq{c[0]}sk{c[1]}h{c[2]}kv{c[3]}{'c' if c[4] else 'f'}w{c[5]}d{c[6]}"
       for c in CASES]


def _inputs(case):
    """q, k, v and the output cotangent as fp32 numpy holding bf16 values,
    from a seed."""
    sq, sk, h, hkv, _, _, d = case
    rng = np.random.default_rng(CASES.index(case))
    shapes = ((1, sq, h, d), (1, sk, hkv, d), (1, sk, hkv, d), (1, sq, h, d))
    return [np.asarray(jnp.asarray(rng.standard_normal(s), jnp.bfloat16),
                       np.float32) for s in shapes]


@functools.lru_cache(maxsize=None)
def _pallas(case, dtype):
    """JAX's dq, dk, dv (fp32 numpy) through the Pallas backward in
    interpret mode, jitted, on the case's bf16 values in ``dtype``
    ("float32": upcast, the kernels' fp32 function; "bfloat16": the bf16
    run whose outputs the card's are held to). Once per module."""
    sq, sk, h, hkv, causal, window, d = case
    dt = getattr(jnp, dtype)

    @jax.jit
    def grads(q, k, v, ct):
        def f(q, k, v):
            return j_ops.flash_attention_train(
                q, k, v, scale=d ** -0.5, causal=causal, window=window,
                block_q=32, block_k=32, interpret=True)
        out, vjp = jax.vjp(f, q, k, v)
        return vjp(ct.astype(out.dtype))

    args = [jnp.asarray(x, dt) for x in _inputs(case)]
    return tuple(np.asarray(x, np.float32) for x in grads(*args))


def _pad(x, dk):
    """x's last dim zero-padded to dk: the kernels' tiles in shared memory
    (``flash_attention.kernel_dim``)."""
    return torch.nn.functional.pad(x, (0, dk - x.shape[-1]))


def _split(case, sms=SMS):
    """Whether K8 splits the case's groups over blocks on a card of
    ``sms`` SMs (B = 1)."""
    sq, sk, h, hkv = case[:4]
    return fa.dkv_split(-(-sk // TILE) * hkv, h // hkv, sms)


@functools.lru_cache(maxsize=None)
def _emulated(case, fwd_dtype, planes, sms=SMS):
    """The kernels' fp32 dq, dk, dv (before the bf16 cast) on the case's
    bf16 values on a card of ``sms`` SMs, from the port's plain forward's
    out and lse in ``fwd_dtype`` ("float32" for the fp32 comparison;
    "bfloat16" as the card's bf16 backward gets them), with ``planes`` (3
    or 1) bf16 planes of P and dS; the walks run on tiles zero-padded to
    ``kernel_dim(d)`` columns and the outputs' first d columns are kept."""
    sq, sk, h, hkv, causal, window, d = case
    x32 = [torch.from_numpy(x) for x in _inputs(case)]
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    dt = getattr(torch, fwd_dtype)
    out, lse = ref.flash_attention_fwd_ref(*(x.to(dt) for x in x32[:3]),
                                           **kw)
    dout = x32[3].to(dt).float()
    delta = (dout * out.float()).sum(-1).transpose(1, 2).contiguous()
    q, k, v, dout = (_pad(x, fa.kernel_dim(d)) for x in x32[:3] + [dout])
    mm = planes3 if planes == 3 else planes1
    dq = emulate_dq(q, k, v, dout, lse, delta, mm=mm, **kw)
    dk, dv = emulate_dkv(q, k, v, dout, lse, delta, mm=mm,
                         split=_split(case, sms), **kw)
    return tuple(x[..., :d].numpy() for x in (dq, dk, dv))


def _rel_errs(got, want):
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fp32_accumulators_within_the_fp32_gate(case):
    """dq, dk and dv before the bf16 cast, three planes of P and dS, within
    1e-4 of the max of Pallas's on the same values in fp32, with a margin
    of 10x."""
    errs = _rel_errs(_emulated(case, "float32", 3),
                     _pallas(case, "float32"))
    assert max(errs) <= FP32_GATE / 10, errs


GROUPS = [(c, i) for c, i in zip(CASES, IDS) if c[2] > c[3]]


@pytest.mark.parametrize("case", [c for c, _ in GROUPS],
                         ids=[i for _, i in GROUPS])
def test_group_walk_within_the_fp32_gate(case):
    """K8's walk over the whole group in one block, which shapes that fill
    the card run (one SM here, so no split): the fp32 accumulators within
    the same margin."""
    assert _split(case) and not _split(case, 1)
    errs = _rel_errs(_emulated(case, "float32", 3, sms=1),
                     _pallas(case, "float32"))
    assert max(errs) <= FP32_GATE / 10, errs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_outputs_within_the_bf16_gate(case):
    """dq, dk and dv cast to bf16, from the bf16 forward's out and lse as
    on the card, within chip_smoke.py's bf16 gate (1e-2 of the max plus
    1e-3) of Pallas's bf16 backward."""
    got = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
           for x in _emulated(case, "bfloat16", 3)]
    for name, g, w in zip(("dq", "dk", "dv"), got,
                          _pallas(case, "bfloat16")):
        err = float(np.abs(g - w).max())
        assert err <= BF16_GATE * float(np.abs(w).max()) + BF16_ATOL, \
            (name, err)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_plane_does_measurably_worse(case, record_property):
    """P and dS rounded to one bf16 plane (as bf16 SDPA rounds them) miss
    the fp32 gate that three planes meet, at 10x three planes' error or
    more; both errors are recorded beside each other."""
    want = _pallas(case, "float32")
    three = max(_rel_errs(_emulated(case, "float32", 3), want))
    one = max(_rel_errs(_emulated(case, "float32", 1), want))
    record_property("rel_err_three_planes", three)
    record_property("rel_err_one_plane", one)
    assert one > FP32_GATE and one >= 10 * three, (one, three)


def test_bf16x3_split_is_exact():
    """hi + mid + lo == x for finite fp32 x across magnitudes, each part a
    bf16 value (low 16 bits zero), lo with at most 8 significant bits."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(8192)
                          * np.exp2(rng.integers(-60, 60, 8192)))
                         .astype(np.float32))
    parts = bf16x3(x)
    for part in parts:
        assert torch.equal(part.view(torch.int32) & 0xFFFF,
                           torch.zeros_like(part, dtype=torch.int32))
    hi, mid, lo = parts
    assert torch.equal((hi + mid) + lo, x)
    assert torch.equal(lo.to(torch.bfloat16).float(), lo)
