"""The port's cells and dry-run (``repro_torch.launch.cells``,
``launch.dryrun``): the counterpart of ``tests/test_dryrun_small.py``.

gemma3-27b's smoke config with ``train_4k`` and ``decode_32k`` shrunk as
that test shrinks them (S 64 x B 8, S 128 x B 8; ``prefill_32k`` to S 64
x B 4), and whisper-large-v3's smoke cells at the same shapes, on a
(2, 4) mesh:

* ``build_cell``'s fields equal the reference ``Cell``'s (built on an
  abstract mesh of the same shape): kind, ``tokens_per_step``,
  ``n_params_total``, ``n_params_active``, ``analytic_live_bytes``, the
  donated arguments, and every argument leaf's shape and dtype (meta
  tensors against ``ShapeDtypeStruct``s), exactly;
* the dry-run's cost of each cell on its meta tensors has FLOPs > 0, and
  a full-width record (``run_cell``) is ``ok``; an fp8 KV cache is
  refused with ``ValueError``;
* one materialized CPU step of each cell equals the port's model function
  called directly on copies of the same tensors, bit for bit (the decode
  logits and caches, the prefill logits, the training loss and updated
  params).
"""

import copy
import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs import base as j_cfgbase
from repro.launch import cells as j_cells
from repro_torch.configs import base as t_cfgbase
from repro_torch.core import flops as t_fl
from repro_torch.launch import cells as t_cells
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import encdec as t_encdec
from repro_torch.models import transformer as t_tf
from repro_torch.optim import apply_updates
from repro_torch.train.loop import value_and_grad

CUTS = {"train_4k": (64, 8), "decode_32k": (128, 8), "prefill_32k": (64, 4)}
CASES = [("gemma3-27b", s) for s in CUTS] + [("whisper-large-v3", s)
                                             for s in CUTS]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _shape(cfgbase, name):
    seq, batch = CUTS[name]
    return dataclasses.replace(cfgbase.SHAPES[name], seq_len=seq,
                               global_batch=batch)


def _smoke(cfgbase, arch_id):
    arch = cfgbase.get(arch_id)
    return dataclasses.replace(arch, make_config=arch.make_smoke)


def _build(cells, cfgbase, mesh, arch_id, shape_name, overrides=None):
    arch = _smoke(cfgbase, arch_id)
    shape = _shape(cfgbase, shape_name)
    build = (cells.build_lm_cell if arch.kind == "lm"
             else cells.build_encdec_cell)
    return build(arch, shape, mesh, overrides=overrides)


def _port(arch_id, shape_name, overrides=None):
    return _build(t_cells, t_cfgbase, make_mesh((2, 4), ("data", "model")),
                  arch_id, shape_name, overrides)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], prefix + (k,))
        return out
    if hasattr(tree, "__dataclass_fields__"):
        out = []
        for f in tree.__dataclass_fields__:
            out += _leaves(getattr(tree, f), prefix + (f,))
        return out
    return [(prefix, tree)]


@pytest.mark.parametrize("arch_id,shape_name", CASES)
def test_cell_fields_equal_reference(arch_id, shape_name):
    mesh = AbstractMesh((2, 4), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2)
    want = _build(j_cells, j_cfgbase, mesh, arch_id, shape_name)
    got = _port(arch_id, shape_name)
    for field in ("kind", "tokens_per_step", "n_params_total",
                  "n_params_active", "analytic_live_bytes",
                  "donate_argnums"):
        assert getattr(got, field) == getattr(want, field), field
    assert len(got.args_meta) == len(want.args_sds)
    for g_arg, w_arg in zip(got.args_meta, want.args_sds):
        g_l, w_l = _leaves(g_arg), _leaves(w_arg)
        assert [p for p, _ in g_l] == [p for p, _ in w_l]
        for (path, g), (_, w) in zip(g_l, w_l):
            assert g.is_meta, path
            assert tuple(g.shape) == tuple(w.shape), path
            assert str(g.dtype).split(".")[-1] == str(w.dtype), path


@pytest.mark.parametrize("arch_id,shape_name", CASES)
def test_dryrun_cost_on_meta(arch_id, shape_name):
    cell = _port(arch_id, shape_name)
    cost = t_fl.cost_of_fn(cell.step_fn, *cell.args_meta, n_devices=8)
    assert cost["flops_per_device"] > 0 and cost["traffic_per_device"] > 0
    assert cost["flops_per_device"] * 8 == cost["flops_global"]


@pytest.mark.parametrize("arch_id", ["gemma3-27b", "whisper-large-v3"])
def test_full_width_record(arch_id):
    """A full-width record on the one-device mesh, decode_32k cut to 8
    rows: ``ok``, its FLOPs and argument bytes, no collective bytes."""
    shape = dataclasses.replace(t_cfgbase.SHAPES["decode_32k"],
                                global_batch=8)
    rec = dryrun.run_cell(arch_id, "decode_32k", mesh_name="one",
                          shape=shape)
    assert rec["ok"], rec.get("traceback")
    assert rec["flops_per_device"] > 0 and rec["memory"]["argument"] > 0
    assert rec["collective_bytes_per_device"] is None
    assert rec["collective_note"] and rec["modeled"]
    assert rec["memory"]["hbm_bytes"] == 80 * 1024 ** 3


def test_refusals_and_notes():
    with pytest.raises(ValueError, match="fp8"):
        _port("gemma3-27b", "decode_32k", {"kv_cache_dtype": "fp8"})
    cell = _port("gemma3-27b", "train_4k", {"remat": "full"})
    assert "remat" in cell.notes
    w8 = _port("gemma3-27b", "decode_32k", {"_weights_int8": True})
    assert w8.cfg.quant.weights_int8
    assert w8.args_meta[0]["pat0"]["attn"]["wq"]["q8"].dtype == torch.int8
    with pytest.raises(ValueError, match="skips"):
        t_cells.build_cell("starcoder2-7b", "long_500k",
                           make_mesh((1, 1), ("data", "model")))


def _equal(a, b):
    for (pa, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y), pa


@pytest.mark.parametrize("arch_id,shape_name", CASES)
def test_materialized_step_equals_direct_call(arch_id, shape_name):
    cell = _port(arch_id, shape_name)
    args = cell.materialize("cpu", seed=0)
    for a, m in zip(args, cell.args_meta):
        for (path, x), (_, y) in zip(_leaves(a), _leaves(m)):
            assert x.shape == y.shape and x.dtype == y.dtype, path
    cfg = cell.cfg
    lm = arch_id != "whisper-large-v3"
    if cell.kind == "decode":
        params, token, pos, caches = args
        caches2 = copy.deepcopy(caches)
        logits, out = cell.run(*args)
        if lm:
            want, want_c = t_tf.decode_step(params, cfg, token,
                                            pos.expand(token.shape[0]),
                                            caches2)
        else:
            want, want_c = t_encdec.decode_step(params, cfg, token, pos,
                                                caches2)
        assert torch.equal(logits, want) and torch.isfinite(logits).all()
        _equal(out, want_c)
    elif cell.kind == "prefill":
        params, batch = args
        got = cell.run(*args)
        if lm:
            want = t_tf.prefill(params, cfg, batch["tokens"],
                                max_len=batch["tokens"].shape[1],
                                cache_dtype=torch.bfloat16)
            assert torch.equal(got[0], want[0])
            _equal(got[1], want[1])
        else:
            enc = t_encdec.encode(params, cfg, batch["frames"])
            want = t_encdec.decode_train(params, cfg, batch["tokens"], enc)
            assert torch.equal(got, want[:, -1:])
    else:
        params, opt_state, batch = args
        params2, opt2 = _clone_tree(params), _clone_tree(opt_state)
        loss_fn = ((lambda p, b: t_tf.loss_fn(p, cfg, b)) if lm
                   else (lambda p, b: t_encdec.loss_fn(p, cfg, b)))
        loss, _, grads = value_and_grad(loss_fn, params2, batch)
        if lm:
            grads = t_cells._cast_like(grads, params2)
        apply_updates(params2, grads, opt2, t_cells._adamw_for(
            t_cfgbase.get(arch_id)))
        new_p, _, metrics = cell.run(*args)
        assert torch.equal(metrics["loss"], loss)
        assert torch.isfinite(metrics["loss"])
        _equal(new_p, params2)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    out = tree.detach().clone()
    return out.requires_grad_(tree.requires_grad)
