"""The port's sharding rules (``repro_torch.parallel.sharding``) and
logical-axes trees against the JAX package's, leaf for leaf.

For every LM and encoder-decoder arch, smoke and full config: the port's
axes trees (``lm_axes`` / ``encdec_axes``, ``caches_axes`` /
``dec_caches_axes``, ``opt_state_axes``) equal the reference's
(``init_lm(...).axes`` from ``jax.eval_shape``, ``caches_axes``, the
cells' ``_ENC_CACHE_AXES``, ``opt_state_axes``), and the port's spec of
every param, cache and optimizer-state leaf (its trees built on meta
tensors) equals the reference's ``PartitionSpec`` under
``DEFAULT_RULES``, ``LONG_CONTEXT_RULES`` and the cells' ``_fsdp`` param
rules, on the reference tests' fake production mesh (2 x 16 x 16), one
pod (16 x 16) and a (2, 4) mesh; ``local_shape`` of each leaf times its
spec's axis sizes gives the leaf's shape back, and ``placements_for``
shards exactly the spec's dims. Exact equality throughout.
"""

import math
from functools import partial

import jax
import pytest
import torch

from repro.configs import base as j_cfgbase
from repro.launch import cells as j_cells
from repro.models import encdec as j_encdec
from repro.models import transformer as j_tf
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw as j_adamw
from repro.parallel import sharding as j_sh
from repro_torch.configs import base as t_cfgbase
from repro_torch.models import encdec as t_encdec
from repro_torch.models import transformer as t_tf
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.optim import adamw as t_adamw
from repro_torch.parallel import sharding as t_sh


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


MESHES = [FakeMesh(pod=2, data=16, model=16), FakeMesh(data=16, model=16),
          FakeMesh(data=2, model=4)]
FSDP = dict(j_sh.DEFAULT_RULES, embed=("pod", "data"))
RULES = {"default": (j_sh.DEFAULT_RULES, t_sh.DEFAULT_RULES),
         "long_context": (j_sh.LONG_CONTEXT_RULES, t_sh.LONG_CONTEXT_RULES),
         "fsdp": (FSDP, dict(t_sh.DEFAULT_RULES, embed=("pod", "data")))}
ARCHS = list(j_cfgbase.all_arch_ids(lm_only=True))
CACHE_B, CACHE_S = 8, 64


def _paths(tree, prefix=()):
    """{key path: leaf} over dicts and dataclass nodes."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_paths(tree[k], prefix + (k,)))
        return out
    if hasattr(tree, "__dataclass_fields__"):
        out = {}
        for f in tree.__dataclass_fields__:
            out.update(_paths(getattr(tree, f), prefix + (f,)))
        return out
    return {prefix: tree}


def _state_cfg(arch):
    return "int8" if arch.params_nominal >= 5e11 else "bf16"


_TREES = {}


def _trees(arch_id, which):
    """(reference trees, port trees): [(name, leaves, axes)] each."""
    key = (arch_id, which)
    if key in _TREES:
        return _TREES[key]
    ja, ta = j_cfgbase.get(arch_id), t_cfgbase.get(arch_id)
    jc, tc = getattr(ja, which)(), getattr(ta, which)()
    state = _state_cfg(ja)
    j_opt_cfg = JAdamW(state_dtype=state, use_master=False)
    t_opt_cfg = TAdamW(state_dtype=state, use_master=False)
    if ja.kind == "lm":
        jp = jax.eval_shape(partial(j_tf.init_lm, cfg=jc),
                            jax.random.PRNGKey(0))
        jcache = jax.eval_shape(partial(j_tf.init_caches, jc, CACHE_B,
                                        CACHE_S))
        jcache_ax = j_tf.caches_axes(jc)
        tp = t_tf.init_lm(tc, device="meta")
        tp_ax = t_tf.lm_axes(tc)
        tcache = t_tf.init_caches(tc, CACHE_B, CACHE_S, device="meta")
        tcache_ax = t_tf.caches_axes(tc)
    else:
        jp = jax.eval_shape(partial(j_encdec.init_encdec, cfg=jc),
                            jax.random.PRNGKey(0))
        jcache = jax.eval_shape(partial(j_encdec.init_dec_caches, jc,
                                        CACHE_B, CACHE_S))
        jcache_ax = j_cells._ENC_CACHE_AXES
        tp = t_encdec.init_encdec(tc, device="meta")
        tp_ax = t_encdec.encdec_axes(tc)
        tcache = t_encdec.init_dec_caches(tc, CACHE_B, CACHE_S,
                                          device="meta")
        tcache_ax = t_encdec.dec_caches_axes()
    jopt = jax.eval_shape(partial(j_adamw.init_opt_state, cfg=j_opt_cfg),
                          jp.params)
    topt = t_adamw.init_opt_state(tp, t_opt_cfg)
    ref = [("params", jp.params, jp.axes), ("caches", jcache, jcache_ax),
           ("opt", jopt, j_adamw.opt_state_axes(jp.axes, j_opt_cfg))]
    port = [("params", tp, tp_ax), ("caches", tcache, tcache_ax),
            ("opt", topt, t_adamw.opt_state_axes(tp_ax, t_opt_cfg))]
    _TREES[key] = (ref, port)
    return _TREES[key]


@pytest.mark.parametrize("which", ["make_smoke", "make_config"])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_axes_trees_equal(arch_id, which):
    """The port's axes trees equal the reference's, and its trees have the
    reference's leaves at the reference's shapes."""
    ref, port = _trees(arch_id, which)
    for (name, jt, jax_axes), (_, tt, t_axes) in zip(ref, port):
        assert _paths(t_axes) == _paths(jax_axes), name
        jl, tl = _paths(jt), _paths(tt)
        assert set(jl) == set(tl), name
        for path, leaf in jl.items():
            assert tuple(tl[path].shape) == tuple(leaf.shape), (name, path)


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("which", ["make_smoke", "make_config"])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_specs_equal(arch_id, which, rules):
    """Every leaf's spec equals the reference's on every mesh, and its
    local shape and placements agree with the spec."""
    from torch.distributed.tensor import Shard
    ref, port = _trees(arch_id, which)
    j_rules, t_rules = RULES[rules]
    for mesh in MESHES:
        for (name, jt, jax_axes), (_, tt, t_axes) in zip(ref, port):
            want = _paths(j_sh.specs_for_tree(jt, jax_axes, mesh, j_rules))
            got = _paths(t_sh.specs_for_tree(tt, t_axes, mesh, t_rules))
            assert {p: tuple(s) for p, s in want.items()} == got, \
                (name, mesh.shape)
            leaves = _paths(tt)
            for path, spec in got.items():
                shape = tuple(leaves[path].shape)
                local = t_sh.local_shape(shape, spec, mesh)
                full = tuple(n * t_sh._axis_size(mesh, e) for n, e in
                             zip(local, spec + (None,) * len(shape)))
                assert full == shape, (path, spec)
                pl = t_sh.placements_for(spec, mesh)
                sharded = {p.dim for p in pl if isinstance(p, Shard)}
                assert sharded == {d for d, e in enumerate(spec)
                                   if e is not None}, (path, spec)


def test_rule_cases():
    """The reference tests' spot cases, through the port."""
    m = MESHES[0]
    assert t_sh.spec_for((4608, 36, 128), ("embed", "heads", "head_dim"),
                         m) == (None, None, "model")
    assert t_sh.spec_for((64, 2048, 1408), ("experts", "embed", "ffn"),
                         m) == ("model",)
    assert t_sh.spec_for((256, 4096), ("batch", "seq"), m) \
        == (("pod", "data"),)
    assert t_sh.batch_spec(m, 1, seq_len=524288, long_context=True) \
        == (None, ("pod", "data"))
    assert t_sh.spec_for((256, 128), ("batch", "seq"), MESHES[1]) \
        == ("data",)
    assert t_sh.dp_axes(m) == ("pod", "data") and t_sh.dp_size(m) == 32
    assert t_sh.local_shape((256, 4096), (("pod", "data"),), m) \
        == (8, 4096)
    specs = {"a": (None, "model"), "b": {"c": (None, "model"), "d": ()}}
    assert t_sh.summarize(specs) == {"P(None, 'model')": 2, "P()": 1}
    # a dim over two mesh axes: Shard on both, the major axis first
    pl = t_sh.placements_for((("pod", "data"), "model"), m)
    assert [type(p).__name__ for p in pl] == ["Shard"] * 3
    assert [p.dim for p in pl] == [0, 0, 1]
    assert math.prod(m.shape.values()) == 512


def test_activation_context():
    """``constrain`` is the identity without a context and on a plain
    tensor under one; a fully replicated spec leaves x alone."""
    from repro_torch.parallel import ctx
    x = torch.zeros(4, 8)
    assert ctx.constrain(x, "batch", None) is x
    with ctx.activation_sharding(MESHES[2]):
        assert ctx.constrain(x, "batch", None) is x
        assert ctx.constrain(x, None, None) is x
        assert ctx.constrain(x, "batch") is x          # rank mismatch
    assert ctx._current() is None


def test_mesh_descriptions():
    """The production meshes as descriptions, touching no device."""
    from repro_torch.launch import mesh as t_mesh
    single = t_mesh.make_production_mesh()
    multi = t_mesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    with pytest.raises(RuntimeError, match="no process group"):
        single.device_mesh("cpu")
