"""The port's analytic FLOPs walker (``repro_torch.core.flops``: aten ops
through a ``TorchDispatchMode``, the kernels' own counts) against the JAX
package's jaxpr walker (``repro.core.flops``) on the same shapes.

The reference's ``tests/test_flops.py`` cases, mirrored on meta tensors:
a single matmul, a batched einsum, a Python loop against the reference's
scan, a backward, a convolution, the traffic and the per-device split:
FLOPs equal. Then starcoder2-7b's smoke cells, built by both packages'
``build_lm_cell`` on a one-device mesh: the decode and prefill cells'
dot FLOPs equal the reference's ``dot_general`` exactly (the decode
attention is K1's count on the port's side, the reference's masked
einsums on its side). The training cell's ratio comes from the config:
the reference (``remat="full"``) runs each layer's dots forward, again in
the backward's recompute (all but the block's last, the MLP's
``w_out``, whose output the backward does not need) and twice in the
backward, and its attention as full S x S einsums; the port has no remat
and its attention is K6-K8 over the causal pairs (4, 6 and 8 Dh FLOPs a
pair and head). Both totals are asserted exactly, and so their ratio.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro.configs import base as j_cfgbase
from repro.core import flops as j_fl
from repro.launch import cells as j_cells
from repro.launch.mesh import make_mesh as j_make_mesh
from repro_torch.configs import base as t_cfgbase
from repro_torch.core import flops as t_fl
from repro_torch.launch import cells as t_cells
from repro_torch.launch.mesh import make_mesh as t_make_mesh

ATTENTION_KERNELS = ("decode_attention", "flash_attention_fwd",
                     "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def meta(*shape):
    return torch.empty(shape, device="meta")


def sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def test_single_matmul():
    c = t_fl.cost_of_fn(lambda a, b: a @ b, meta(32, 64), meta(64, 128))
    want = j_fl.cost_of_fn(lambda a, b: a @ b, sds(32, 64), sds(64, 128))
    assert c["flops_global"] == want["flops_global"] == 2 * 32 * 64 * 128


def test_batched_einsum():
    c = t_fl.cost_of_fn(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                        meta(4, 8, 16), meta(4, 16, 32))
    want = j_fl.cost_of_fn(lambda a, b: jnp.einsum("bik,bkj->bij", a, b),
                           sds(4, 8, 16), sds(4, 16, 32))
    assert c["flops_global"] == want["flops_global"] == 2 * 4 * 8 * 16 * 32


def test_loop_against_scan():
    """Eager torch has no scan: the loop's seven steps are counted as they
    run, the reference's scan body times its trip count."""
    def f(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x

    def g(x):
        w = jnp.zeros((16, 16))
        y, _ = jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x, None,
                            length=7)
        return y

    c = t_fl.cost_of_fn(f, meta(4, 16), meta(16, 16))
    want = j_fl.cost_of_fn(g, sds(4, 16))
    assert c["flops_global"] == want["flops_global"] == 7 * 2 * 4 * 16 * 16


def test_backward_included():
    """loss(w) = sum(x @ w): the gradient adds the backward's dot; the dot
    FLOPs equal ``jax.grad``'s."""
    x = torch.ones(4, 16, device="meta")

    def grad(w):
        w = w.requires_grad_(True)
        (x @ w).sum().backward()
        return w.grad

    c_f = t_fl.cost_of_fn(lambda w: (x @ w).sum(), meta(16, 16))
    c_g = t_fl.cost_of_fn(grad, meta(16, 16))
    xj = jnp.ones((4, 16))
    want = j_fl.cost_of_fn(jax.grad(lambda w: jnp.sum(xj @ w)),
                           sds(16, 16))
    assert c_g["flops_global"] >= c_f["flops_global"]
    assert c_g["by_prim"]["dot_general"] == want["by_prim"]["dot_general"]
    assert c_g["by_prim"]["dot_general"] == 2 * c_f["by_prim"]["dot_general"]


def test_conv_flops():
    def f(x, k):
        return F.conv2d(x, k, padding="same")

    def g(x, k):
        return jax.lax.conv_general_dilated(
            x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    c = t_fl.cost_of_fn(f, meta(1, 3, 8, 8), meta(16, 3, 3, 3))
    want = j_fl.cost_of_fn(g, sds(1, 8, 8, 3), sds(3, 3, 3, 16))
    assert c["flops_global"] == want["flops_global"] \
        == 2 * 8 * 8 * 16 * 3 * 3 * 3


def test_conv_backward_counts_both_gradients():
    x = torch.empty(2, 3, 8, 8, device="meta", requires_grad=True)
    k = torch.empty(16, 3, 3, 3, device="meta", requires_grad=True)

    def step(x, k):
        F.conv2d(x, k, padding=1).sum().backward()

    fwd = 2 * 2 * 8 * 8 * 16 * 3 * 3 * 3
    assert t_fl.cost_of_fn(step, x, k)["by_prim"]["conv_general_dilated"] \
        == 3 * fwd


def test_traffic_positive_and_per_device_split():
    c = t_fl.cost_of_fn(lambda a, b: a @ b, meta(32, 64), meta(64, 128),
                        n_devices=4)
    assert c["traffic_bytes_global"] >= (32 * 64 + 64 * 128 + 32 * 128) * 4
    assert c["flops_per_device"] == c["flops_global"] / 4
    assert c["traffic_per_device"] == c["traffic_bytes_global"] / 4


# -- the cells -----------------------------------------------------------------

ARCH = "starcoder2-7b"
SHAPES = {"decode_32k": (128, 8), "prefill_32k": (128, 4),
          "train_4k": (64, 8)}


def _cells(shape_name):
    seq, batch = SHAPES[shape_name]
    over = {"remat": "full"} if shape_name == "train_4k" else None
    out = []
    for cfgbase, cells, mesh in (
            (j_cfgbase, j_cells, j_make_mesh((1, 1), ("data", "model"))),
            (t_cfgbase, t_cells, t_make_mesh((1, 1), ("data", "model")))):
        arch = cfgbase.get(ARCH)
        arch = dataclasses.replace(arch, make_config=arch.make_smoke)
        shape = dataclasses.replace(cfgbase.SHAPES[shape_name], seq_len=seq,
                                    global_batch=batch)
        out.append(cells.build_lm_cell(arch, shape, mesh, overrides=over))
    return out


def _dots(shape_name):
    """(the reference cell's dot_general FLOPs, the port cell's by_prim)."""
    jcell, tcell = _cells(shape_name)
    want = j_fl.jaxpr_cost(jax.make_jaxpr(jcell.step_fn)(*jcell.args_sds)
                           .jaxpr).by_prim["dot_general"]
    with t_fl.count() as c:
        tcell.step_fn(*tcell.args_meta)
    return want, c.by_prim, tcell.cfg


@pytest.mark.parametrize("shape_name", ["decode_32k", "prefill_32k"])
def test_inference_cells_dot_flops_equal(shape_name):
    want, by_prim, _ = _dots(shape_name)
    got = by_prim["dot_general"] + sum(by_prim.get(k, 0.0)
                                       for k in ATTENTION_KERNELS)
    assert got == want
    if shape_name == "decode_32k":
        assert by_prim["decode_attention"] > 0


def test_train_cell_ratio_from_config():
    want, by_prim, cfg = _dots("train_4k")
    seq, b = SHAPES["train_4k"]
    t = b * seq
    d, h, hkv, dh, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim, cfg.d_ff)
    n_layers = cfg.n_layers
    assert not cfg.mlp_gated and cfg.tail == ()
    proj = 2 * t * (d * (h + 2 * hkv) * dh + h * dh * d + 2 * d * ff)
    w_out = 2 * t * ff * d                       # the block's last dot
    attn_full = 4 * b * h * seq * seq * dh       # q k^T and P V, S x S
    head = 2 * t * d * cfg.padded_vocab
    ref = n_layers * (4 * (proj + attn_full) - w_out) + 3 * head
    pairs = b * h * seq * (seq + 1) // 2
    port_dots = n_layers * 3 * proj + 3 * head
    port_flash = n_layers * (4 + 6 + 8) * dh * pairs
    assert want == ref
    assert by_prim["dot_general"] == port_dots
    assert sum(by_prim[k] for k in ATTENTION_KERNELS[1:]) == port_flash
    got = by_prim["dot_general"] + port_flash
    assert got / want == pytest.approx((port_dots + port_flash) / ref,
                                       rel=1e-12)
    assert got < want          # no recompute, no masked-out pairs
