"""The numerics of K6's and K10's bf16 tensor-core kernel, checked on the
CPU.

With bf16 q the forward (``csrc/flash_attention.cu``,
``flash_fwd_bf16_kernel``) computes the Pallas body's function, which
upcasts q, k and v to fp32: S = Q K^T has bf16 on both sides, so each
16-deep step of bf16 ``wgmma`` sums exact products in fp32, and S is
scaled in fp32 after it (times each key's K scale in K10's int8-KV mode,
where the codes are exact in bf16); the online softmax runs in fp32 from m
= -1e30 with p masked explicitly and l summed from the fp32 p; P V takes p
(times each key's V scale over int8 codes) in three exact bf16 planes
against the bf16 (or exactly widened) V tile, each 64-key tile's sum taken
into O = O alpha + P V in fp32; out = O / max(l, 1e-30), lse = m +
log(max(l, 1e-30)). The walk: each block's 64 query rows (one
warpgroup) over the 64-key tiles its rows can see, from its first visible
key, on tiles zero-padded to ``flash_attention.kernel_dim`` columns.
``emulate_fwd_bf16`` below does exactly that in torch.

Held against the JAX Pallas forward in interpret mode (``_fwd_with_lse``,
K6's ``pallas_call``; ``ops.flash_attention`` with ``k_scale``/``v_scale``
for K10's int8-KV mode): the fp32 result before the bf16 cast, and lse,
against Pallas run on the same bf16 values upcast to fp32, within the fp32
gate / 10 (1e-5 of the max); the bf16 out against Pallas run in bf16
within chip_smoke.py's bf16 gate (1e-2 of the max plus 1e-3). P rounded to
one bf16 plane (as bf16 SDPA rounds it) must do measurably worse. The
source lines that ``benchmarks/flash_fwd_parts.py`` replaces are checked
here too: each must be in the source exactly once.
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
from repro_torch.benchmarks import flash_fwd_parts
from repro_torch.kernels import flash_attention as fa
from tests._bf16_planes import dots16, planes1, planes3

TILE = 64                           # the block's rows and the key tile
FP32_GATE = 1e-4                    # chip_smoke.py FLASH_TOL["float32"]
BF16_GATE, BF16_ATOL = 1e-2, 1e-3   # chip_smoke.py FLASH_TOL, FLASH_ATOL
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


def emulate_fwd_bf16(q, k, v, *, scale, causal, window, k_scale=None,
                     v_scale=None, mm=planes3):
    """What the bf16 forward kernel computes: q (B, Sq, H, D) and k/v (B,
    Sk, Hkv, D) fp32 tensors holding bf16 values, or k/v holding int8
    codes with their (B, Sk, Hkv) fp32 scales. Returns out (B, Sq, H, D)
    in fp32, before the kernel's bf16 cast, and lse (B, H, Sq)."""
    d_in = q.shape[-1]
    pad = fa.kernel_dim(d_in) - d_in
    q, k, v = (torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    int8 = k_scale is not None
    out = torch.zeros((b, sq, h, d))
    lse = torch.zeros((b, h, sq))
    for q0 in range(0, sq, TILE):
        n_q = min(TILE, sq - q0)
        qi = torch.arange(q0, q0 + TILE)
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        k_hi = min(sk, q0 + n_q) if causal else sk
        qs = _rows(q, q0, TILE).permute(0, 2, 1, 3)           # (B, H, R, D)
        m = torch.full((b, h, TILE), -1e30)
        l = torch.zeros((b, h, TILE))
        acc = torch.zeros((b, h, TILE, d))
        for k0 in range(k_lo // TILE * TILE, k_hi, TILE):
            kj = torch.arange(k0, k0 + TILE)
            kt = _rows(k, k0, TILE).permute(0, 2, 1, 3) \
                .repeat_interleave(rep, 1)                      # (B, H, K, D)
            vt = _rows(v, k0, TILE).permute(0, 2, 1, 3) \
                .repeat_interleave(rep, 1)
            mul = torch.full((b, h, 1, TILE), scale)
            vs = None
            if int8:
                ks = _rows(k_scale, k0, TILE).transpose(1, 2) \
                    .repeat_interleave(rep, 1)[:, :, None]      # (B, H, 1, K)
                vs = _rows(v_scale, k0, TILE).transpose(1, 2) \
                    .repeat_interleave(rep, 1)[:, :, None]
                mul = mul * ks
            s = dots16(qs, kt) * mul
            ok = _valid(qi, kj, sq, sk, causal, window)
            m_new = torch.maximum(m, torch.where(ok, s, -1e30).amax(-1))
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pv = p * vs if int8 else p
            acc = acc * alpha[..., None] + mm(pv, vt)
            m = m_new
        den = l.clamp_min(1e-30)
        out[:, q0:q0 + n_q] = (acc / den[..., None]).permute(
            0, 2, 1, 3)[:, :n_q]
        lse[:, :, q0:q0 + n_q] = (m + torch.log(den))[..., :n_q]
    return out[..., :d_in], lse


# (sq, sk, h, hkv, d, causal, window): every head dim the wrapper takes,
# GQA groups of 1, 2 and 3, ragged lengths across the 64-row and 64-key
# tiles, Sq < Sk, windows that start inside a tile, one non-causal case
CASES = [
    (130, 130, 4, 2, 8, True, -1),
    (67, 96, 3, 1, 16, True, -1),
    (96, 96, 2, 2, 24, True, 40),
    (200, 200, 3, 1, 64, True, 70),
    (130, 130, 4, 2, 112, True, -1),
    (64, 96, 2, 1, 128, False, -1),
    (100, 160, 3, 1, 128, True, -1),
    (128, 128, 4, 2, 168, True, 40),
]
IDS = [f"sq{c[0]}sk{c[1]}h{c[2]}kv{c[3]}d{c[4]}{'c' if c[5] else 'f'}w{c[6]}"
       for c in CASES]
# K10's int8-KV mode with bf16 q: (s, h, hkv, d, window)
INT8 = [(96, 4, 2, 16, -1), (130, 3, 1, 128, 50), (100, 4, 2, 168, -1)]
INT8_IDS = [f"s{c[0]}h{c[1]}kv{c[2]}d{c[3]}w{c[4]}" for c in INT8]


def _bf16(x):
    """fp32 numpy holding x's values rounded to bf16."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _inputs(case):
    """q, k and v as fp32 numpy holding bf16 values, from a seed."""
    sq, sk, h, hkv, d, _, _ = case
    rng = np.random.default_rng(CASES.index(case))
    shapes = ((1, sq, h, d), (1, sk, hkv, d), (1, sk, hkv, d))
    return [_bf16(rng.standard_normal(s)) for s in shapes]


@functools.partial(jax.jit, static_argnames=("statics",))
def _pallas_fwd(q, k, v, statics):
    return j_fa._fwd_with_lse(q, k, v, statics)


@functools.lru_cache(maxsize=None)
def _pallas(case, dtype):
    """K6's Pallas kernel (``_fwd_with_lse``) in interpret mode on the
    case's bf16 values in ``dtype`` ("float32": upcast; "bfloat16"): out
    (B, Sq, H, D) and lse (B, H, Sq) as fp32 numpy. Keys padded to the
    tile sit past Sk, where the causal mask hides them from every row (Sq
    <= Sk) or none is padded."""
    sq, sk, _, _, d, causal, window = case
    assert (causal and sq <= sk) or sk % BLOCK == 0
    dt = getattr(jnp, dtype)

    def pad(x):
        return jnp.pad(jnp.asarray(x, dt),
                       ((0, 0), (0, -x.shape[1] % BLOCK), (0, 0), (0, 0)))

    out, lse = _pallas_fwd(*(pad(x) for x in _inputs(case)), statics=(
        d ** -0.5, causal, window, BLOCK, BLOCK, True))
    return (np.asarray(out, np.float32)[:, :sq],
            np.asarray(lse)[:, :, :sq, 0])


@functools.lru_cache(maxsize=None)
def _emulated(case, planes):
    """The kernel's fp32 out and its lse on the case's bf16 values, with
    ``planes`` (3 or 1) bf16 planes of P."""
    sq, sk, h, hkv, d, causal, window = case
    q, k, v = (torch.from_numpy(x) for x in _inputs(case))
    out, lse = emulate_fwd_bf16(q, k, v, scale=d ** -0.5, causal=causal,
                                window=window,
                                mm=planes3 if planes == 3 else planes1)
    return out.numpy(), lse.numpy()


def _rel_errs(got, want):
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fp32_result_within_the_fp32_gate(case):
    """out before the bf16 cast and lse, three planes of P, within 1e-4 of
    the max of Pallas's on the same values in fp32, with a margin of
    10x."""
    errs = _rel_errs(_emulated(case, 3), _pallas(case, "float32"))
    assert max(errs) <= FP32_GATE / 10, errs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_out_within_the_bf16_gate(case):
    """out cast to bf16 within chip_smoke.py's bf16 gate (1e-2 of the max
    plus 1e-3) of Pallas's bf16 forward."""
    got = torch.from_numpy(_emulated(case, 3)[0]).to(
        torch.bfloat16).float().numpy()
    want = _pallas(case, "bfloat16")[0]
    err = float(np.abs(got - want).max())
    assert err <= BF16_GATE * float(np.abs(want).max()) + BF16_ATOL, err


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_plane_does_measurably_worse(case, record_property):
    """P rounded to one bf16 plane (as bf16 SDPA rounds it) misses the
    fp32 gate in out that three planes meet, at 10x three planes' error or
    more; both errors are recorded beside each other."""
    want = _pallas(case, "float32")[0]
    three = _rel_errs(_emulated(case, 3)[:1], [want])[0]
    one = _rel_errs(_emulated(case, 1)[:1], [want])[0]
    record_property("rel_err_three_planes", three)
    record_property("rel_err_one_plane", one)
    assert one > FP32_GATE and one >= 10 * three, (one, three)


@functools.lru_cache(maxsize=None)
def _int8_inputs(case):
    """bf16 q (fp32 numpy holding bf16 values), K/V int8 codes and their
    fp32 scales from ``quantize_rowwise``, from a seed."""
    s, h, hkv, d, _ = case
    rng = np.random.default_rng(11 + INT8.index(case))
    q = _bf16(rng.standard_normal((1, s, h, d)))
    kv = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((1, s, hkv, d)), jnp.float32)
        codes, sc = j_q8.quantize_rowwise(x)
        kv += [np.array(codes), np.array(sc)]
    return (q, *kv)


def _pallas_int8(case, dtype):
    s, h, hkv, d, window = case
    q, kq, ks, vq, vs = _int8_inputs(case)
    return np.asarray(j_ops.flash_attention(
        jnp.asarray(q, getattr(jnp, dtype)), jnp.asarray(kq),
        jnp.asarray(vq), scale=d ** -0.5, causal=True, window=window,
        block_q=BLOCK, block_k=BLOCK, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), interpret=True), np.float32)


@pytest.mark.parametrize("case", INT8, ids=INT8_IDS)
def test_int8_kv_within_the_gates(case):
    """K10's int8-KV mode with bf16 q: the codes exact in bf16, each key's
    K scale on its column of S and its V scale on p before the planes;
    the fp32 result within the fp32 gate / 10 of the Pallas int8-KV
    forward on q upcast to fp32, and cast to bf16 within the bf16 gate of
    it on bf16 q."""
    s, h, hkv, d, window = case
    t = torch.from_numpy
    q, kq, ks, vq, vs = _int8_inputs(case)
    got, _ = emulate_fwd_bf16(t(q), t(kq).float(), t(vq).float(),
                              scale=d ** -0.5, causal=True, window=window,
                              k_scale=t(ks), v_scale=t(vs))
    want = _pallas_int8(case, "float32")
    err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert err <= FP32_GATE / 10, err
    got16 = got.to(torch.bfloat16).float().numpy()
    want16 = _pallas_int8(case, "bfloat16")
    err16 = float(np.abs(got16 - want16).max())
    assert err16 <= BF16_GATE * float(np.abs(want16).max()) + BF16_ATOL, \
        err16


@pytest.mark.parametrize("name", list(flash_fwd_parts.PARTS))
def test_parts_lines_are_in_the_source_once(name):
    """Every line ``flash_fwd_parts.py`` replaces is in the flash source
    exactly once (no build: the parts script stops on a line that is not),
    and its edits change the source."""
    text = flash_fwd_parts.part_source(name)
    as_is = flash_fwd_parts.part_source("as_is")
    assert (text != as_is) == bool(flash_fwd_parts.PARTS[name][1])
