"""The port's multi-rank parallel layer (``repro_torch.parallel``:
``ring_allreduce_int8``, ``pipeline_apply`` through ``make_pipelined_fn``,
and ``models.moe.moe_ep``) on gloo CPU process groups, against the JAX
package's on the same numpy inputs, run on forced host devices through
``tests/_mp.py``; and the single-device error-feedback transform against
``repro.parallel.compression`` in process.

Bounds:
* ``ring_allreduce_int8``, 8 ranks: every rank's vector within 4 ulps (of
  the largest |value|) of the JAX rank's; both round half to even and sum
  in the same chunk order, so they agree to the last bits;
* ``compress_grads_with_ef``: the int8 codes equal, the dequantized values
  and the residuals within 1 ulp;
* ``pipeline_apply``, 4 ranks: output and every stage's weight gradient
  within 1e-5 (the reference's own bound) of ``make_pipelined_fn`` and
  ``jax.grad``;
* ``moe_ep``, 4 ranks, bridged weights: within 2e-4 (the reference's
  bound against ``moe_dense``) of the JAX ``moe_ep`` at capacity factor 8
  (no drops) and 1 (routes dropped), the aux loss within 1e-5.

The JAX runs happen once, in one subprocess; the port's in one spawn per
world size (8 ranks, then 4), each rank on one torch thread.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compression as j_comp
from repro_torch.parallel import compression as t_comp
from tests import _torch_dist
from tests._mp import run_multidevice

RING_WORLD, STAGES_WORLD = 8, 4
MOE_CFG = dict(d_model=32, d_ff=64, n_experts=8, top_k=2)
MOE_CFS = (8.0, 1.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs():
    rng = np.random.default_rng(0)
    d, f, e = MOE_CFG["d_model"], MOE_CFG["d_ff"], MOE_CFG["n_experts"]

    def fan_in(shape, fi):
        return (rng.standard_normal(shape) / np.sqrt(fi)).astype(np.float32)

    return {
        # a ragged length (1003 over 8 ranks pads) with a wide range
        "ring_x": (rng.standard_normal((RING_WORLD, 1003))
                   * rng.uniform(0.1, 10.0, (RING_WORLD, 1))
                   ).astype(np.float32),
        "pipe_w": (rng.standard_normal((STAGES_WORLD, 16, 16)) * 0.3
                   ).astype(np.float32),
        "pipe_x": rng.standard_normal((8, 16)).astype(np.float32),
        "pipe_micro": 4,
        "moe_params": {"router": fan_in((d, e), d),
                       "w_in": fan_in((e, d, f), d),
                       "w_gate": fan_in((e, d, f), d),
                       "w_out": fan_in((e, f, d), f)},
        "moe_x": rng.standard_normal((4, 16, d)).astype(np.float32),
        "moe_cfg": MOE_CFG, "moe_cfs": MOE_CFS,
    }


_JAX_REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.models import moe as moe_lib
from repro.parallel import compression as comp, pipeline as pp
from repro.parallel.compat import shard_map
inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
devs = np.array(jax.devices())
mesh8 = Mesh(devs[:8], ("dp",))
f = jax.jit(shard_map(lambda xs: comp.ring_allreduce_int8(xs[0], "dp")[None],
                      mesh8, in_specs=P("dp"), out_specs=P("dp")))
out["ring"] = np.asarray(f(jnp.asarray(inp["ring_x"])))
mesh4 = Mesh(devs[:4], ("pipe",))
run = pp.make_pipelined_fn(lambda w, x: jnp.tanh(x @ w), mesh4,
                           n_micro=inp["pipe_micro"])
ws, x = jnp.asarray(inp["pipe_w"]), jnp.asarray(inp["pipe_x"])
out["pipe_y"] = np.asarray(run(ws, x))
out["pipe_g"] = np.asarray(jax.grad(lambda w: jnp.sum(run(w, x) ** 2))(ws))
mesh_m = Mesh(devs[:4], ("model",))
params = {k: jnp.asarray(v) for k, v in inp["moe_params"].items()}
specs = {"router": P(), "w_in": P("model"), "w_gate": P("model"),
         "w_out": P("model")}
for cf in inp["moe_cfs"]:
    cfg = moe_lib.MoEConfig(**inp["moe_cfg"], capacity_factor=cf)
    g = jax.jit(shard_map(lambda p, x: moe_lib.moe_ep(p, cfg, x, "model", 4),
                          mesh_m, in_specs=(specs, P()), out_specs=(P(), P())))
    y, aux = g(params, jnp.asarray(inp["moe_x"]))
    out[f"moe_y_{cf}"], out[f"moe_aux_{cf}"] = np.asarray(y), np.asarray(aux)
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX outputs, the port's per-rank outputs by world size)."""
    work = tmp_path_factory.mktemp("parallel")
    inputs = _inputs()
    with open(work / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    code = (f"import sys; sys.argv = ['', {str(work / 'in.pkl')!r}, "
            f"{str(work / 'jax.pkl')!r}]\n" + _JAX_REFERENCE)
    assert "OK" in run_multidevice(code, n_devices=8, timeout=300)
    with open(work / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    got = {RING_WORLD: _torch_dist.run_ranks(RING_WORLD, "ring_task",
                                             work / "ring", inputs),
           STAGES_WORLD: _torch_dist.run_ranks(STAGES_WORLD, "stages_task",
                                               work / "stages", inputs)}
    return inputs, want, got


def _ulp(x: np.ndarray) -> float:
    return float(np.spacing(np.float32(np.abs(x).max())))


def test_ring_allreduce_int8_per_rank(runs):
    """Every rank's int8 ring all-reduce equals the JAX rank's to 4 ulps,
    and every rank holds the same vector."""
    inputs, want, got = runs
    ring = np.stack([r["ring"] for r in got[RING_WORLD]])
    assert ring.shape == inputs["ring_x"].shape
    tol = 4 * _ulp(want["ring"])
    np.testing.assert_allclose(ring, want["ring"], rtol=0, atol=tol)
    np.testing.assert_array_equal(ring, np.broadcast_to(ring[0], ring.shape))
    # the mean it approximates, within the int8 hops' error
    mean = inputs["ring_x"].mean(0)
    assert np.abs(ring[0] - mean).max() / np.abs(mean).max() < 0.05


def test_pipeline_matches_reference(runs):
    """GPipe over 4 ranks: the output on every rank and each stage's
    weight gradient (on its own rank) within 1e-5 of the JAX pipeline's
    and ``jax.grad``'s."""
    _, want, got = runs
    for rank, r in enumerate(got[STAGES_WORLD]):
        np.testing.assert_allclose(r["pipe_y"], want["pipe_y"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(r["pipe_g"], want["pipe_g"][rank],
                                   rtol=0, atol=1e-5)
    assert np.abs(want["pipe_g"]).max() > 0


@pytest.mark.parametrize("cf", MOE_CFS)
def test_moe_ep_matches_reference(runs, cf):
    """Expert-parallel MoE over 4 ranks, two experts each: the combine on
    every rank within 2e-4 of the JAX ``moe_ep``, with no route dropped
    (factor 8) and with routes dropped (factor 1)."""
    inputs, want, got = runs
    for r in got[STAGES_WORLD]:
        np.testing.assert_allclose(r[f"moe_y_{cf}"], want[f"moe_y_{cf}"],
                                   rtol=0, atol=2e-4)
        np.testing.assert_allclose(r[f"moe_aux_{cf}"], want[f"moe_aux_{cf}"],
                                   rtol=1e-5)
    if cf == 1.0:
        # the tight factor drops routes: the output differs from factor 8's
        assert np.abs(want["moe_y_1.0"] - want["moe_y_8.0"]).max() > 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_grads_with_ef(seed):
    """One error-feedback step on a two-leaf tree with a carried residual:
    the codes equal, the dequantized gradient and the new residual within
    1 ulp of the JAX transform's."""
    rng = np.random.default_rng(seed)
    g = {"w": rng.standard_normal((37, 19)).astype(np.float32),
         "b": {"x": (rng.standard_normal(301) * 1e-3).astype(np.float32)}}
    ef = {"w": (rng.standard_normal((37, 19)) * 0.01).astype(np.float32),
          "b": {"x": (rng.standard_normal(301) * 1e-5).astype(np.float32)}}
    jg = jax.tree.map(jnp.asarray, g)
    jdq, jef = j_comp.compress_grads_with_ef(jg, jax.tree.map(jnp.asarray,
                                                              ef))
    tg = {"w": torch.from_numpy(g["w"]),
          "b": {"x": torch.from_numpy(g["b"]["x"])}}
    te = {"w": torch.from_numpy(ef["w"]),
          "b": {"x": torch.from_numpy(ef["b"]["x"])}}
    tdq, tef = t_comp.compress_grads_with_ef(tg, te)
    for path in (("w",), ("b", "x")):
        def at(tree):
            for k in path:
                tree = tree[k]
            return np.asarray(tree)
        target = at(g) + at(ef)
        jq, js = j_comp._quantize(jnp.asarray(target))
        tq, ts = t_comp._quantize(torch.from_numpy(target))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_max_ulp(at(tdq), at(jdq), maxulp=1)
        np.testing.assert_allclose(at(tef), at(jef), rtol=0,
                                   atol=_ulp(at(jef)))
    z = t_comp.init_ef_state(tg)
    assert z["w"].shape == (37, 19) and not z["b"]["x"].any()


def test_one_rank_group(tmp_path):
    """On a group of one rank the ring returns its input itself (the
    reference's n == 1) and ``psum`` is the identity both ways."""
    import datetime
    import torch.distributed as dist
    from repro_torch.parallel import compat
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        x = torch.arange(5.0, requires_grad=True)
        assert t_comp.ring_allreduce_int8(x) is x
        y = compat.psum(x * 2.0)
        y.sum().backward()
        assert torch.equal(y, x.detach() * 2.0)
        assert torch.equal(x.grad, torch.full((5,), 2.0))
        assert (compat.axis_size(), compat.axis_index()) == (1, 0)
    finally:
        dist.destroy_process_group()
