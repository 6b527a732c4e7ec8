"""The port's CNN workloads (``models/cnn.py``, the AlexNet and VGG-16
configs, the ternary route through K11's plain version) against the JAX
package on bridged weights and the same numpy images, on the CPU.

Bounds: logits within 1e-5 of the max |logit| (fp32 convolutions summed in
other orders); the K11 route against JAX's dequantized forward and against
JAX's ``forward(matmul_fn=kops.ternary_matmul)`` (the Pallas kernel in
interpret mode) within 1e-5 of the max; ``loss_fn``'s ce and acc within
1e-6 relative; gradients (no dropout) within 1e-4 of each leaf's max.
The ternary codes are JAX's, bridged, so the route's parity does not
depend on the quantizer's threshold ties (tests/test_torch_ternary.py
holds the quantizers to each other). Dropout cannot reproduce threefry's
bits: it is checked for its distribution and its determinism given a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import alexnet as j_alexnet
from repro.configs import vgg16 as j_vgg16
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro.quant import ternary as jtern
from repro_torch import bridge
from repro_torch.configs import alexnet as t_alexnet
from repro_torch.configs import base as t_base
from repro_torch.configs import vgg16 as t_vgg16
from repro_torch.examples.edge_cnn_repro import fc_predicate, ternary_mm
from repro_torch.models import cnn as tcnn
from repro_torch.quant import ternary as ttern


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


ARCHS = {"alexnet": (j_alexnet, t_alexnet), "vgg16": (j_vgg16, t_vgg16)}
_CACHE = {}


def _setup(arch):
    """(JAX smoke cfg, port cfg, JAX params, port params, numpy batch)."""
    if arch not in _CACHE:
        jmod, tmod = ARCHS[arch]
        jcfg, tcfg = jmod.make_smoke(), tmod.make_smoke()
        jparams = jcnn.init_cnn(jax.random.PRNGKey(7), jcfg).params
        tparams = bridge.cnn_params_from_numpy(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
        rng = np.random.default_rng(8)
        imgs = rng.standard_normal(
            (4, jcfg.image_size, jcfg.image_size, jcfg.in_channels)
        ).astype(np.float32)
        labels = rng.integers(0, jcfg.num_classes, 4).astype(np.int32)
        _CACHE[arch] = (jcfg, tcfg, jparams, tparams, imgs, labels)
    return _CACHE[arch]


def _close(got: torch.Tensor, want, of_max=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= of_max * max(float(np.abs(want).max()), 1e-12), err


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_jax(arch):
    jcfg, tcfg, jparams, tparams, imgs, _ = _setup(arch)
    want = jcnn.forward(jparams, jcfg, jnp.asarray(imgs))
    got = tcnn.forward(tparams, tcfg, torch.from_numpy(imgs))
    _close(got, want)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_ternary_route_matches_jax(arch):
    """The K11 route (``matmul_fn=ternary_mm``, the plain version on the
    CPU) against JAX's dequantized forward (the reference example's
    logits) and against JAX's forward through its Pallas kernel."""
    jcfg, tcfg, jparams, _, imgs, _ = _setup(arch)
    jq = jtern.quantize_tree(jparams, predicate=fc_predicate)
    tq = {g: {k: (bridge.ternary_from_numpy(np.asarray(v.q),
                                            np.asarray(v.scale), "cpu")
                  if isinstance(v, jtern.TernaryWeight)
                  else torch.from_numpy(np.array(v)))
              for k, v in leaves.items()} for g, leaves in jq.items()}
    assert sorted(f"{g}/{k}" for g in tq for k in tq[g]
                  if isinstance(tq[g][k], ttern.TernaryWeight)) == \
        [f"fc{i}/w" for i in range(len(tcfg.fcs) + 1)]
    got = tcnn.forward(tq, tcfg, torch.from_numpy(imgs), matmul_fn=ternary_mm)
    x = jnp.asarray(imgs)
    _close(got, jcnn.forward(jtern.dequantize_tree(jq), jcfg, x))
    _close(got, jcnn.forward(jq, jcfg, x, matmul_fn=jops.ternary_matmul))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jparams, tparams, imgs, labels = _setup(arch)
    jbatch = {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)}
    (jce, jm), jg = jax.value_and_grad(jcnn.loss_fn, has_aux=True)(
        jparams, jcfg, jbatch)
    params = {g: {k: v.clone().requires_grad_(True) for k, v in l.items()}
              for g, l in tparams.items()}
    ce, m = tcnn.loss_fn(params, tcfg, {"images": torch.from_numpy(imgs),
                                        "labels": torch.from_numpy(labels)})
    for key in ("ce", "acc"):
        np.testing.assert_allclose(float(m[key].detach()), float(jm[key]),
                                   rtol=1e-6)
    ce.backward()
    for g, leaves in params.items():
        for k, p in leaves.items():
            _close(p.grad, jg[g][k], of_max=1e-4)


def test_dropout_distribution_and_determinism():
    """With ``train`` and a generator, each unit of an FC activation is
    dropped or scaled by 1 / (1 - p); about 1 - p of them are kept; one
    seed gives one mask, another seed another. Without a generator (or
    without ``train``) nothing is dropped."""
    _, tcfg, _, tparams, _, _ = _setup("alexnet")
    imgs = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (256, tcfg.image_size, tcfg.image_size, 3)).astype(np.float32))
    seen = []

    def record(a, w):
        seen.append(a)
        return a @ w

    def run(seed, train=True):
        seen.clear()
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        out = tcnn.forward(tparams, tcfg, imgs, train=train, generator=gen,
                           matmul_fn=record)
        return out, seen[1].clone()        # fc1's input: fc0 after dropout

    plain_out, plain = run(None)
    assert torch.equal(run(5, train=False)[0], plain_out)
    out_a, a = run(5)
    out_b, b = run(5)
    _, c = run(6)
    assert torch.equal(a, b) and torch.equal(out_a, out_b)
    assert not torch.equal(a, c)
    live = plain > 0
    kept = a[live] != 0
    p = tcfg.dropout
    torch.testing.assert_close(a[live][kept], plain[live][kept] / (1 - p))
    assert (a[~live] == 0).all()
    n = int(live.sum())
    assert n > 4000
    assert abs(float(kept.float().mean()) - (1 - p)) < 4 * (p * (1 - p) / n) ** 0.5


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_shapes_and_flops_match_jax(arch):
    """Full and smoke configs: field for field, ``flops_per_image`` and
    every parameter shape (JAX's from ``jax.eval_shape``, allocating
    nothing)."""
    jmod, tmod = ARCHS[arch]
    for jcfg, tcfg in ((jmod.make_config(), tmod.make_config()),
                       (jmod.make_smoke(), tmod.make_smoke())):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcnn.flops_per_image(tcfg) == jcnn.flops_per_image(jcfg)
        shapes = jax.eval_shape(
            lambda: jcnn.init_cnn(jax.random.PRNGKey(0), jcfg)).params
        assert tcnn.param_shapes(tcfg) == {
            g: {k: tuple(v.shape) for k, v in leaves.items()}
            for g, leaves in shapes.items()}
    spec = t_base.get(arch)
    assert spec.kind == "cnn" and spec.make_config() is tmod.make_config()


def test_full_size_flops_and_params():
    """The analytic FLOPs the card's training row divides by: 1.434 GFLOP
    an image for AlexNet, 30.94 for VGG-16; 61.1M and 138.4M params."""
    for cfg, gflop, params in ((tcnn.ALEXNET, 1.434, 61.10e6),
                               (tcnn.VGG16, 30.94, 138.36e6)):
        assert abs(tcnn.flops_per_image(cfg) / 1e9 / gflop - 1) < 1e-3
        n = sum(int(np.prod(s)) for leaves in tcnn.param_shapes(cfg).values()
                for s in leaves.values())
        assert abs(n - params) / params < 1e-3


@pytest.mark.parametrize("size,kernel,stride,want", [
    (224, 11, 4, (3, 4)), (32, 11, 4, (3, 4)), (27, 5, 1, (2, 2)),
    (13, 3, 1, (1, 1)), (8, 2, 2, (0, 0))])
def test_same_pads_are_xla_s(size, kernel, stride, want):
    """SAME pads as XLA computes them: AlexNet's first conv pads (3, 4),
    the odd pixel high; the output is ceil(size / stride)."""
    lo, hi = tcnn.same_pads(size, kernel, stride)
    assert (lo, hi) == want
    assert (size + lo + hi - kernel) // stride + 1 == -(-size // stride)


def test_bridge_refuses_wrong_shapes():
    jcfg, tcfg, jparams, _, _, _ = _setup("alexnet")
    tree = jax.tree.map(np.asarray, jparams)
    tree["fc0"]["w"] = tree["fc0"]["w"][:-1]
    with pytest.raises(ValueError, match="shapes"):
        bridge.cnn_params_from_numpy(tree, tcfg, device="cpu")


def test_init_cnn_from_seed():
    """``init_cnn`` is deterministic per seed, in the reference's layout,
    with fan-in scaled weights and zero biases."""
    cfg = t_alexnet.make_smoke()
    a = tcnn.init_cnn(cfg, seed=3, device="cpu")
    b = tcnn.init_cnn(cfg, seed=3, device="cpu")
    c = tcnn.init_cnn(cfg, seed=4, device="cpu")
    assert {g: {k: tuple(v.shape) for k, v in l.items()}
            for g, l in a.items()} == tcnn.param_shapes(cfg)
    assert all(torch.equal(a[g][k], b[g][k]) for g in a for k in a[g])
    assert not torch.equal(a["fc0"]["w"], c["fc0"]["w"])
    assert all(float(a[g]["b"].abs().max()) == 0.0 for g in a)
    w = a["conv0"]["w"]
    std = 1.0 / (11 * 11 * 3) ** 0.5
    assert float(w.abs().max()) <= 2 * std + 1e-6
