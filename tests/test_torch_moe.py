"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the same fp32 weights and inputs, made
from seeds with numpy, on the CPU.

Bounds: ``route``'s gates within 1e-6 and its expert ids equal, the aux
loss within rel 1e-5; ``moe_dense`` and ``moe_capacity`` within 2e-5
(tests/test_moe.py's bound between the two JAX paths), at an ample
capacity and at a tight one (cf 0.25), with the same routes dropped as a
recount of the reference's first-come ranks. The JAX layers are built once
per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The smoke models' ops are far below any parallel grain, but on a
    loaded host (the suite's parallel workers) idle intra-op threads cost
    this file several times its run time: one thread while it runs, the
    worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_CACHE = {}


def _setup(e=8, k=2, d=32, f=64, cf=8.0, seed=0):
    """(JAX cfg, JAX params, port cfg, port params) of one layer."""
    key = (e, k, d, f, cf, seed)
    if key not in _CACHE:
        jcfg = jmoe.MoEConfig(d_model=d, d_ff=f, n_experts=e, top_k=k,
                              capacity_factor=cf)
        params = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg,
                               dtype=jnp.float32).params
        tcfg = tmoe.MoEConfig(**dataclasses.asdict(jcfg))
        tparams = {n: torch.from_numpy(np.array(v)) for n, v in params.items()}
        _CACHE[key] = (jcfg, params, tcfg, tparams)
    return _CACHE[key]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ref_dropped(ids: np.ndarray, n_experts: int, tg: int, cap: int):
    """The reference's first-come drops, recounted in numpy: per group of
    ``tg`` tokens, a route's rank is the number of earlier routes (token
    major over (t, k)) to its expert."""
    t, k = ids.shape
    out = np.zeros((t, k), bool)
    for g0 in range(0, t, tg):
        seen = np.zeros(n_experts, int)
        for ti in range(g0, g0 + tg):
            for j in range(k):
                out[ti, j] = seen[ids[ti, j]] >= cap
                seen[ids[ti, j]] += 1
    return out


def test_config_and_capacity_mirror_the_reference():
    jcfg, _, tcfg, _ = _setup()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for cf in (0.25, 1.25, 8.0):
        jc = dataclasses.replace(jcfg, capacity_factor=cf)
        tc = dataclasses.replace(tcfg, capacity_factor=cf)
        for n in (1, 8, 64, 4096):
            assert tc.capacity(n) == jc.capacity(n)


def test_init_shapes_and_dtypes():
    """The reference's leaves and shapes, behind a stack dim; the router
    stays fp32 when the experts are bf16."""
    jcfg, params, tcfg, _ = _setup()
    p = tmoe.init_moe(tcfg, (3,), generator=torch.Generator().manual_seed(0),
                      device=torch.device("cpu"), dtype=torch.bfloat16)
    assert {n: tuple(v.shape) for n, v in p.items()} == {
        n: (3,) + tuple(v.shape) for n, v in params.items()}
    assert p["router"].dtype == torch.float32
    assert p["w_in"].dtype == torch.bfloat16
    # fan-in scale: std 1/sqrt(d) truncated at two deviations
    w = p["w_in"].float()
    assert w.abs().max() <= 2.0 / np.sqrt(tcfg.d_model) + 1e-3
    assert abs(w.std().item() * np.sqrt(tcfg.d_model) - 0.88) < 0.05


def test_route_matches_jax():
    jcfg, params, tcfg, tparams = _setup()
    x = _x((48, 32), 1)
    jg, ji, ja = jmoe.route(params, jcfg, jnp.asarray(x))
    tg, ti, ta = tmoe.route(tparams, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    assert float(ta) == pytest.approx(float(ja), rel=1e-5)
    assert float(ta) > 0


def test_topk_tie_goes_to_the_lower_expert_id():
    """Equal logits resolve as ``jax.lax.top_k`` resolves them: a zero input
    ties all experts, and a router with equal columns ties two."""
    jcfg, params, tcfg, tparams = _setup(e=6, k=3, d=8, f=8)
    router = np.array(params["router"])
    router[:, 4] = router[:, 1]
    router[:, 5] = router[:, 1]
    jp = dict(params, router=jnp.asarray(router))
    tp = dict(tparams, router=torch.from_numpy(router))
    x = np.concatenate([np.zeros((2, 8), np.float32), _x((30, 8), 2)])
    _, ji, _ = jmoe.route(jp, jcfg, jnp.asarray(x))
    _, ti, _ = tmoe.route(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[0], [0, 1, 2])
    # some row routes to the tied experts: 1 before 4 before 5
    tied = [row for row in ti.numpy().tolist() if 1 in row and 4 in row]
    assert tied and all(r.index(1) < r.index(4) for r in tied)


@pytest.mark.parametrize("cf,group", [(8.0, 16), (0.25, 32), (0.25, 64)])
def test_capacity_and_dense_match_jax(cf, group):
    """Ample capacity (nothing drops) and tight capacity (routes drop): the
    same outputs, aux and dropped routes as the reference."""
    jcfg, params, tcfg, tparams = _setup(cf=cf)
    x = _x((2, 32, 32), 3)
    jy, ja = jmoe.moe_capacity(params, jcfg, jnp.asarray(x),
                               group_size=group)
    ty, ta = tmoe.moe_capacity(tparams, tcfg, torch.from_numpy(x),
                               group_size=group)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-5)
    assert float(ta) == pytest.approx(float(ja), rel=1e-5)
    jd, _ = jmoe.moe_dense(params, jcfg, jnp.asarray(x))
    td, _ = tmoe.moe_dense(tparams, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-5)
    _, ids, _ = jmoe.route(params, jcfg, jnp.asarray(x.reshape(64, 32)))
    tg = min(group, 64)
    want = _ref_dropped(np.asarray(ids), jcfg.n_experts, tg,
                        jcfg.capacity(tg))
    got = tmoe.dropped_routes(tcfg, torch.from_numpy(np.array(ids)), group)
    np.testing.assert_array_equal(got.numpy(), want)
    if cf < 1:
        assert want.any()
        # the dropped routes add nothing: the output is the dense one less
        # their gated terms, never renormalized
        assert not np.allclose(ty.numpy(), td.numpy(), atol=1e-3)
    else:
        assert not want.any()
        np.testing.assert_allclose(ty.numpy(), td.numpy(), atol=2e-5)


def test_group_invariance_with_ample_capacity():
    """tests/test_moe.py::test_group_invariance on the port."""
    _, _, tcfg, tparams = _setup(cf=16.0)
    x = torch.from_numpy(_x((2, 32, 32), 5))
    y1, _ = tmoe.moe_capacity(tparams, tcfg, x, group_size=16)
    y2, _ = tmoe.moe_capacity(tparams, tcfg, x, group_size=64)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=2e-5)


def test_groups_that_miss_the_tokens_raise():
    """200 tokens in groups of 64 make 3 groups of 66: the reference
    asserts, the port raises ValueError."""
    jcfg, params, tcfg, tparams = _setup()
    x = _x((2, 100, 32), 6)
    with pytest.raises(AssertionError):
        jmoe.moe_capacity(params, jcfg, jnp.asarray(x), group_size=64)
    with pytest.raises(ValueError, match="groups of 64"):
        tmoe.moe_capacity(tparams, tcfg, torch.from_numpy(x), group_size=64)


def test_int8_experts_equal_their_dequantized_weights():
    """An int8 leaf ({"q8", "s8"}, one scale row per expert) goes through
    ``layers.wl``, a block of experts at a time: the same output as the
    dequantized fp32 weights."""
    from repro_torch.quant import int8 as tint8
    _, _, tcfg, tparams = _setup(cf=0.5)
    q = {n: (tint8.quantize_weight(v, lead=1) if n != "router" else v)
         for n, v in tparams.items()}
    deq = {n: (v["q8"].float() * v["s8"] if isinstance(v, dict) else v)
           for n, v in q.items()}
    x = torch.from_numpy(_x((2, 16, 32), 7))
    yq, _ = tmoe.moe_capacity(q, tcfg, x, group_size=32)
    yd, _ = tmoe.moe_capacity(deq, tcfg, x, group_size=32)
    np.testing.assert_allclose(yq.numpy(), yd.numpy(), atol=1e-6)
    assert tuple(q["w_in"]["s8"].shape) == (tcfg.n_experts, 1, tcfg.d_ff)


def test_grads_flow():
    """tests/test_moe.py::test_grads_flow on the port: the output and the
    aux loss reach the router and every expert weight."""
    _, _, tcfg, tparams = _setup()
    p = {n: v.clone().requires_grad_(True) for n, v in tparams.items()}
    x = torch.from_numpy(_x((1, 16, 32), 8))
    y, aux = tmoe.moe_capacity(p, tcfg, x, group_size=16)
    ((y ** 2).sum() + aux).backward()
    for name in ("w_in", "w_gate", "w_out", "router"):
        assert p[name].grad.abs().max() > 0, name


def test_counting_sort_fifo():
    """tests/test_moe.py::test_counting_sort_fifo on the port, and the same
    slots as the reference's at a larger, dropping case."""
    ids = torch.tensor([[0], [1], [0], [0], [1]])
    slot_token, slot_of_route = tmoe._counting_sort_dispatch(ids, 2, 2)
    # expert 0 gets tokens 0,2 (FIFO); token 3 dropped; expert 1: 1,4
    assert slot_token.tolist() == [0, 2, 1, 4]
    assert int(slot_of_route[3, 0]) == -1
    big = np.random.default_rng(9).integers(0, 5, (40, 3)).astype(np.int32)
    jt, js = jmoe._counting_sort_dispatch(jnp.asarray(big), 5, 6)
    tt, ts = tmoe._counting_sort_dispatch(torch.from_numpy(big).long(), 5, 6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
