"""The numerics of the coded GEMM (``csrc/coded_gemm.cuh``), the tensor-core
body of K9 and of K11 at M > 8, checked on the CPU.

The codes are exact in bf16, so the kernel runs every product on bf16
``wgmma``: bf16 x as one plane, fp32 x (and K9's g = dy * scale, folded in
fp32) split on its bit pattern into three bf16 planes, hi + mid + lo == x
(``hopper::bf16x3_split``: hi = x's top 16 bits, r = x - hi, mid = r's top
16 bits, lo = r - mid), each multiplied by the same code tile. Each 64-deep
stage's products are summed on their own, then added to the running fp32
sum; split K adds the splits' sums in split order. ``emulate`` below does
that in torch, with the planner's splits (each stage's sum exact, rounded
to fp32 once). Held against the Pallas kernels in interpret mode
(``int8_matmul_dx``; ``ternary_matmul`` through ``ops``) at small ragged
shapes within chip_smoke.py's gates (K9_TOL, K11_TOL), it shows the design
can pass the card's gates, and that one plane of fp32 x does not. The split
is checked exact on its own, and the planner as a pure function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import int8_matmul as j_im
from repro.kernels import ops as j_ops
from repro.quant import ternary as j_tern
from repro_torch.kernels import coded_gemm
from repro_torch.kernels import int8_matmul as k9
from repro_torch.kernels import ternary_matmul as k11


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


# chip_smoke.py's gates: (of the plain version's max abs, relative)
K9_TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-5, 2.0 ** -7)}
K11_TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-5, 2.0 ** -7)}
SMS = 132                                   # an H100's SMs
FLT_MAX = float(np.finfo(np.float32).max)


def split3(x):
    """hopper::bf16x3_split on a float32 tensor, through its bit pattern:
    (hi, mid, lo) as float32 tensors whose low 16 bits are zero."""
    u = x.contiguous().view(torch.int32)
    finite = (u & 0x7F800000) != 0x7F800000
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    hi = ((u & -65536) | nan.to(torch.int32) * 0x00400000).view(torch.float32)
    r = torch.where(finite, x - hi, torch.zeros_like(x))
    mid = (r.view(torch.int32) & -65536).view(torch.float32)
    return hi, mid, r - mid


def emulate(a, codes, planes, splits):
    """The kernel's fp32 sums of a (M, Kc) against codes (Kc, N_out): the
    planes of a, each 64-deep stage's products summed exactly and rounded
    to fp32 once, added to the split's running sum; the splits' sums added
    in split order."""
    pieces = split3(a) if planes == 3 else (a,)
    kc = a.shape[1]
    total = None
    for z in range(splits):
        lo, hi = coded_gemm.split_stages(kc, splits, z)
        run = torch.zeros(a.shape[0], codes.shape[1])
        for st in range(lo, hi):
            sl = slice(st * coded_gemm.BK, (st + 1) * coded_gemm.BK)
            part = sum(p[:, sl].double() @ codes[sl].double() for p in pieces)
            run = run + part.float()
        total = run if total is None else total + run
    return total


def _assert_within(got, want, tol):
    of_max, rtol = tol
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bound = of_max * np.abs(want).max() + rtol * np.abs(want)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= bound).all(), \
        float((np.abs(got - want) - bound).max())


# -- the split ------------------------------------------------------------------

def _exact(x):
    hi, mid, lo = split3(x)
    for p in (hi, mid, lo):
        assert not (p.view(torch.int32) & 0xFFFF).any()       # bf16 values
    return hi.double() + mid.double() + lo.double()


def _planes_sum(x):
    """What the three bf16 planes carry: each piece's top 16 bits (the
    kernel packs those; a subnormal lo can hold bits below them)."""
    return sum((p.view(torch.int32) & -65536).view(torch.float32).double()
               for p in split3(x))


def test_split_is_exact_on_normals():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200_000)
         * 10.0 ** rng.uniform(-30, 30, 200_000)).astype(np.float32)
    t = torch.from_numpy(x)
    assert torch.equal(_exact(t), t.double())
    hi = split3(t)[0]
    assert (hi.abs() <= t.abs()).all()                          # truncation


def test_split_is_exact_near_flt_max():
    """Truncation never rounds hi up past FLT_MAX."""
    rng = np.random.default_rng(1)
    big = rng.uniform(2.0 ** 127, FLT_MAX, 10_000).astype(np.float32)
    x = np.concatenate([big, -big, [FLT_MAX, -FLT_MAX,
                                    np.nextafter(np.float32(FLT_MAX),
                                                 np.float32(0))]])
    t = torch.from_numpy(x.astype(np.float32))
    assert torch.equal(_exact(t), t.double())
    assert torch.isfinite(split3(t)[0]).all()


def test_split_near_the_smallest_normals():
    """Exact for |x| >= 2^-103 (lo is zero or a normal number); near
    2^-110 exact wherever lo is zero or normal, and off by less than
    2^-126 elsewhere."""
    rng = np.random.default_rng(2)
    sign = rng.choice([-1.0, 1.0], 20_000)
    ok = torch.from_numpy((sign * 2.0 ** rng.uniform(-103, -90, 20_000))
                          .astype(np.float32))
    assert torch.equal(_exact(ok), ok.double())
    near = torch.from_numpy((sign * 2.0 ** rng.uniform(-111, -109, 20_000))
                            .astype(np.float32))
    lo = split3(near)[2]
    normal = (lo == 0) | (lo.abs() >= 2.0 ** -126)
    carried = _planes_sum(near)
    assert normal.any() and not normal.all()
    assert torch.equal(carried[normal], near.double()[normal])
    assert ((carried - near.double()).abs() < 2.0 ** -126).all()


def test_split_of_non_finite_values():
    """inf and NaN go into hi alone (NaN stays NaN, whatever its payload),
    mid = lo = 0, so products with the codes are the fp32 dot's."""
    bits = torch.tensor([0x7F800000, -8388608, 0x7FC00000, 0x7F800001,
                         -1], dtype=torch.int32)               # +-inf, NaNs
    x = bits.view(torch.float32)
    hi, mid, lo = split3(x)
    assert torch.equal(hi[:2], x[:2]) and torch.isnan(hi[2:]).all()
    assert not mid.any() and not lo.any()
    codes = torch.tensor([-1.0, 0.0, 1.0])
    for v in x:
        want = v * codes
        got = sum(p * codes for p in split3(v.reshape(1)))
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got[~torch.isnan(got)], want[~torch.isnan(want)])


# -- the designs against Pallas ----------------------------------------------------

def _pad(a, rows, cols):
    return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])))


def _up(n, m):
    return -(-n // m) * m


# (M, K, N) of K9: a contraction (N) of one ragged stage, a tiny case, and
# a multi-stage contraction over a ragged dx tile; splits from the planner
# and forced
K9_CASES = [(100, 300, 50, None), (9, 7, 3, None), (70, 300, 700, None),
            (70, 300, 700, 3)]


@pytest.mark.parametrize("out", sorted(K9_TOL))
@pytest.mark.parametrize("m,k,n,splits", K9_CASES)
def test_k9_design_matches_pallas(m, k, n, splits, out):
    rng = np.random.default_rng(m * 7 + n)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32) * 1e-3
    bm, bn, bk = 16, 16, 32
    mp, np_, kp = _up(m, bm), _up(n, bn), _up(k, bk)
    want = np.asarray(j_im.int8_matmul_dx(
        jnp.asarray(_pad(dy, mp, np_)), jnp.asarray(_pad(q, kp, np_)),
        jnp.asarray(np.pad(scale, (0, np_ - n))), block_m=bm, block_n=bn,
        block_k=bk, interpret=True,
        out_dtype=getattr(jnp, out)), np.float32)[:m, :k]
    splits = splits or coded_gemm.plan(m, k, n, SMS)
    g = torch.from_numpy(dy) * torch.from_numpy(scale)         # fp32 fold
    got = emulate(g, torch.from_numpy(q).float().T, 3, splits).to(
        getattr(torch, out))
    _assert_within(got.float().numpy(), want, K9_TOL[out])


# (M, K, N) of K11 at M > 8: chip_smoke.py's ragged tensor-core shapes
K11_CASES = [(9, 301, 50), (100, 300, 50), (64, 7, 3), (64, 777, 1000),
             (130, 2052, 300)]


def _k11_inputs(m, k, n, x_dtype):
    rng = np.random.default_rng(m * 13 + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, x_dtype))
    tw = j_tern.ternarize(jnp.asarray(rng.standard_normal((k, n)),
                                      jnp.float32))
    want = np.asarray(j_ops.ternary_matmul(jx, tw, interpret=True),
                      np.float32)
    xt = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    return (xt, torch.from_numpy(np.array(tw.q)).float(),
            torch.from_numpy(np.array(tw.scale, np.float32)), want)


@pytest.mark.parametrize("x_dtype", sorted(K11_TOL))
@pytest.mark.parametrize("m,k,n", K11_CASES)
def test_k11_design_matches_pallas(m, k, n, x_dtype):
    xt, codes, scale, want = _k11_inputs(m, k, n, x_dtype)
    planes = 3 if x_dtype == "float32" else 1
    got = (emulate(xt, codes, planes, coded_gemm.plan(m, n, k, SMS))
           * scale).to(getattr(torch, x_dtype))
    _assert_within(got.float().numpy(), want, K11_TOL[x_dtype])


def test_one_plane_of_fp32_misses_the_gate():
    """fp32 x as its hi plane alone (a bf16 product) misses the fp32 gate
    that the three planes pass."""
    m, k, n = 130, 2052, 300
    xt, codes, scale, want = _k11_inputs(m, k, n, "float32")
    splits = coded_gemm.plan(m, n, k, SMS)
    hi_only = emulate(split3(xt)[0], codes, 1, splits) * scale
    with pytest.raises(AssertionError):
        _assert_within(hi_only.numpy(), want, K11_TOL["float32"])
    _assert_within((emulate(xt, codes, 3, splits) * scale).numpy(), want,
                   K11_TOL["float32"])


# -- the planner and the routes ----------------------------------------------------

PLAN_SHAPES = [(m, n, kc) for m in (9, 64, 100, 256, 4096)
               for n in (3, 50, 512, 1000, 4096, 4608, 18432)
               for kc in (1, 7, 64, 300, 2048, 4608, 9216, 25088)]


@pytest.mark.parametrize("chunk", range(4))
def test_plan_covers_every_row_once(chunk):
    """Every contraction row in exactly one split of whole 64-row stages,
    1-64 splits each at least MIN_SPLIT_STAGES long; split only where the
    tiles leave SMs idle, and then the grid within one wave of 132 SMs."""
    for m, n, kc in PLAN_SHAPES[chunk::4]:
        splits = coded_gemm.plan(m, n, kc, SMS)
        spans = [coded_gemm.split_stages(kc, splits, z)
                 for z in range(splits)]
        assert [r for lo, hi in spans
                for r in range(lo * coded_gemm.BK,
                               min(hi * coded_gemm.BK, kc))] == list(range(kc))
        tiles = coded_gemm.tiles(m, n)
        assert 1 <= splits <= coded_gemm.MAX_SPLITS
        if splits > 1:
            assert tiles < SMS and tiles * splits <= SMS
            assert min(hi - lo for lo, hi in spans) \
                >= coded_gemm.MIN_SPLIT_STAGES
        if tiles >= SMS:
            assert splits == 1
        assert coded_gemm.ws_floats(m, n, splits) == (
            splits * tiles * coded_gemm.TILE_FLOATS if splits > 1 else 0)


def test_plan_at_the_timed_shapes():
    """K9's training projections run unsplit (1152 or more 64 x 256 dx
    tiles); K11's batch-64 FC layers split to fill the SMs in one wave."""
    for k, n in ((4608, 4608), (4608, 512), (4608, 18432), (18432, 4608)):
        assert coded_gemm.tiles(4096, k) >= 1152
        assert coded_gemm.plan(4096, k, n, SMS) == 1
    assert coded_gemm.plan(64, 4096, 9216, SMS) == 8           # AlexNet fc0
    assert coded_gemm.plan(64, 4096, 25088, SMS) == 8          # VGG-16 fc0
    assert coded_gemm.plan(64, 1000, 4096, SMS) == 16          # fc2
    assert coded_gemm.plan(256, 512, 2048, SMS) == 8           # the bench


def test_routes():
    """K11 streams at M <= 8 and runs the tensor cores above; K9 has one
    kernel. The per-kernel counters name exactly those routes."""
    assert [k11.route(m) for m in (1, 8, 9, 64)] == \
        ["gemv", "gemv", "tensor_cores", "tensor_cores"]
    assert set(k11.ternary_matmul.launches_by_kernel) == \
        {"gemv", "tensor_cores"}
    assert set(k9.int8_matmul_dx.launches_by_kernel) == {"tensor_cores"}
