"""The SSD/hybrid family on the port, against the JAX package on the same
bridged fp32 weights, on the CPU: mamba2-1.3b (3 SSD blocks in its smoke
config, 48 at full width) and zamba2-7b (2 x (2 SSD blocks and a site of
the one shared attention block) and an SSD tail in smoke; 13 x (5 + 1)
and 3 at full width).

The reference's ``init_ssd`` leaves ``conv_b``/``conv_c`` at zero, which
makes every SSM state exactly 0.0 after a prefill (only the D skip and
``conv_x`` carry signal), so a broken scan would pass on ``init_lm``'s
weights. Every model and engine here runs ``init_lm``'s weights with
``conv_b``/``conv_c`` drawn N(0, 0.2) from a numpy seed, written into the
numpy tree before it is bridged, so both packages get the same arrays,
and the tests assert that the states they compare are nonzero.

Bounds: forward logits within 1e-4 and ``loss_fn``'s gradients within
2e-5 (tests/test_torch_transformer.py's and tests/test_torch_train.py's
bounds); prefill plus decode within 1e-3 of the forward
(tests/test_models_smoke.py's bound); prefill logits and every cache leaf
within 1e-5 of JAX's; greedy streams identical, and the carbon report's
modeled keys equal. The JAX models and engine runs are cached per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.core import accounting as j_acct
from repro.models import ssd as jssd
from repro.models import transformer as jtf
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import base as t_base
from repro_torch.core import accounting as t_acct
from repro_torch.models import common, costing
from repro_torch.models import ssd as tssd
from repro_torch.models import transformer as ttf
from repro_torch.serve import (FaultPlan, ProcessKilled, ServeConfig,
                               ServeEngine)
from repro_torch.serve.reference import ReferenceEngine


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The smoke models' ops are far below any parallel grain: one torch
    thread while this file runs (idle intra-op threads cost a loaded host
    several times its run time), the worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCHS = ("mamba2-1.3b", "zamba2-7b")
MAX_LEN = 32
# three slots for nine prompts of five lengths: admission groups equal
# lengths and requeues the rest, slots die beside live ones
PROMPT_LENS = (5, 9, 5, 7, 9, 5, 3, 12, 7)
NEW = 6
RUNS = (("mamba2-1.3b", "none"), ("zamba2-7b", "none"), ("zamba2-7b", "int8"))
_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _live(tree, seed=0):
    """``conv_b``/``conv_c`` of every ``ssd`` group drawn N(0, 0.2), in
    place, in the numpy tree."""
    rng = np.random.default_rng(seed)
    for k, v in sorted(tree.items()):
        if not isinstance(v, dict):
            continue
        if k == "ssd":
            for name in ("conv_b", "conv_c"):
                v[name] = rng.normal(0.0, 0.2, v[name].shape).astype(
                    v[name].dtype)
        else:
            _live(v, seed + 1)
    return tree


def _init(jcfg, dtype=jnp.float32):
    """JAX ``init_lm``'s params, jitted (op by op it takes 10-20 s)."""
    return jax.jit(lambda k: jtf.init_lm(k, jcfg, dtype=dtype).params)(
        jax.random.PRNGKey(0))


def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params) of ``arch``'s smoke
    config, fp32, on live conv weights."""
    def make():
        jcfg = j_base.get(arch).make_smoke()
        tree = _live(jax.tree.map(np.asarray, _init(jcfg)))
        tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
        tparams = bridge.params_from_numpy(tree, tcfg, device="cpu")
        return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tparams
    return _cached(("models", arch), make)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssm_max(caches) -> float:
    """The largest |value| of any SSM state in a cache tree (either
    package's)."""
    return max(float(np.abs(np.asarray(e["ssd"].ssm, np.float32)).max())
               for e in caches.values() if "ssd" in e)


def _flat(tree, prefix=""):
    """(``jax.tree_util.keystr`` path, leaf) of a nested dict of tensors."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}['{k}']")
        else:
            yield f"{prefix}['{k}']", v


# -----------------------------------------------------------------------------
# Configs and parameters
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_mirror_the_reference(arch):
    """The registry holds the arch, and its configs are the reference's,
    full size and smoke, through the bridge (``ssd_cfg`` carried)."""
    spec, tspec = j_base.get(arch), t_base.get(arch)
    assert (tspec.family, tspec.kind) == (spec.family, "lm")
    for make, t_make in ((spec.make_config, tspec.make_config),
                         (spec.make_smoke, tspec.make_smoke)):
        got = bridge.config_from_dict(dataclasses.asdict(make()))
        assert got == t_make()
        assert dataclasses.asdict(got.ssd_cfg) == dataclasses.asdict(
            make().ssd_cfg)
        assert got.n_layers == make().n_layers and got.has_ssd
    full = tspec.make_config()
    assert full.n_layers == {"mamba2-1.3b": 48, "zamba2-7b": 81}[arch]
    assert not ttf.paged_supported(full)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_match_jax_layout(arch):
    """The port's own ``init_lm`` gives JAX's keys, shapes and dtypes at
    bf16 (the ``ssd`` groups' fp32 dt_bias, a_log and d_skip, the inner
    norm in bf16, zamba2's ``shared_attn`` group and no group at a shared
    site)."""
    jcfg = j_base.get(arch).make_smoke()
    jb = jax.eval_shape(lambda k: jtf.init_lm(k, jcfg, dtype=jnp.bfloat16),
                        jax.random.PRNGKey(0)).params
    tb = ttf.init_lm(bridge.config_from_dict(dataclasses.asdict(jcfg)),
                     seed=0, dtype=torch.bfloat16, device="cpu")
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(jb)[0]}
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in _flat(tb)} == want
    assert ("shared_attn" in tb) == (arch == "zamba2-7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count_matches_jax(arch):
    """The full config on the ``meta`` device against JAX's ``eval_shape``
    (tests/test_models_smoke.py:110-121)."""
    spec = j_base.get(arch)
    ax = jax.eval_shape(
        lambda k: jtf.init_lm(k, spec.make_config(), dtype=jnp.bfloat16),
        jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ax.params))
    leaves, _ = common.flatten(ttf.init_lm(t_base.get(arch).make_config(),
                                           device="meta"))
    assert sum(t.numel() for t in leaves) == want


def test_params_from_numpy_reads_the_ssd_norm():
    """The depth check reads ``norm_ssd`` in an SSD group and skips the
    shared site, which has no group."""
    jcfg, params, tcfg, _ = _models("zamba2-7b")
    tree = jax.tree.map(np.asarray, params)
    assert "pat2" not in tree
    tree["pat0"] = jax.tree.map(lambda a: a[:1], tree["pat0"])
    with pytest.raises(ValueError, match="pat0 is stacked 1 deep"):
        bridge.params_from_numpy(tree, tcfg, device="cpu")


# -----------------------------------------------------------------------------
# The models
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_grads_match_jax(arch):
    """``forward``'s logits within 1e-4, and ``loss_fn``'s loss and every
    gradient leaf within 2e-5 of ``jax.grad``'s (the SSD groups', the
    shared block's gathered over its sites, the conv weights' among
    them)."""
    jcfg, params, tcfg, tparams = _models(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 20))
    want = jax.jit(lambda p, t: jtf.forward(p, jcfg, t)[0])(
        params, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got, _ = ttf.forward(tparams, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    labels = rng.integers(0, jcfg.vocab, (2, 20))
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, jbatch)[0]))(params)
    leaves, rebuild = common.flatten(tparams)
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    loss, _ = ttf.loss_fn(rebuild(leaves), tcfg,
                          {"tokens": torch.from_numpy(toks).long(),
                           "labels": torch.from_numpy(labels).long()})
    grads = rebuild(list(torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=2e-5)
    jflat = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    tflat = dict(_flat(grads))
    assert tflat.keys() == jflat.keys()
    for k, w in jflat.items():
        np.testing.assert_allclose(tflat[k].numpy(), w, rtol=2e-5,
                                   atol=2e-5, err_msg=k)
    assert np.abs(jflat["['pat0']['ssd']['conv_b']"]).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """A 6-token prefill and 6 decode steps give the forward's last logits
    within 1e-3 (tests/test_models_smoke.py:60-77)."""
    _, _, tcfg, tparams = _models(arch)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, tcfg.vocab, (2, 12))).long()
    with torch.no_grad():
        full, _ = ttf.forward(tparams, tcfg, toks)
        _, caches = ttf.prefill(tparams, tcfg, toks[:, :6], max_len=12,
                                cache_dtype=torch.float32)
        assert _ssm_max(caches) > 1e-3
        for t in range(6, 12):
            last, caches = ttf.decode_step(tparams, tcfg, toks[:, t:t + 1],
                                           torch.tensor(t), caches)
    np.testing.assert_allclose(last[:, 0].numpy(),
                               full[:, -1, :tcfg.vocab].numpy(), atol=1e-3)


def _check_caches(jc, tc):
    """Every cache leaf of the port within 1e-5 of JAX's: an SSD block's
    four state leaves, a shared site's K, V and position tags."""
    assert set(jc) == set(tc)
    for key, entry in jc.items():
        if "ssd" in entry:
            for name in tssd.SSD_LEAVES:
                np.testing.assert_allclose(
                    getattr(tc[key]["ssd"], name).numpy(),
                    np.asarray(getattr(entry["ssd"], name)), atol=1e-5,
                    err_msg=f"{key}/{name}")
        else:
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    getattr(tc[key]["kv"], name).numpy(),
                    np.asarray(getattr(entry["kv"], name)), atol=1e-5,
                    err_msg=f"{key}/{name}")
            np.testing.assert_array_equal(tc[key]["pos"].numpy(),
                                          np.asarray(entry["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill of 11 tokens (a chunk and a padded tail) into a 16-row
    cache: the logits and every cache leaf within 1e-5 of JAX's, the SSM
    states nonzero; then 4 decode steps at per-slot positions, the logits
    and the states (updated in place) within 1e-5 of JAX's."""
    jcfg, params, tcfg, tparams = _models(arch)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (3, 15))
    lj, jc = jax.jit(lambda p, t: jtf.prefill(
        p, jcfg, t, max_len=16, cache_dtype=jnp.float32))(
        params, jnp.asarray(toks[:, :11], jnp.int32))
    decode = jax.jit(lambda p, t, pos, c: jtf.decode_step(p, jcfg, t, pos, c))
    with torch.no_grad():
        lt, tc = ttf.prefill(tparams, tcfg, _t(toks[:, :11]).long(),
                             max_len=16, cache_dtype=torch.float32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    _check_caches(jc, tc)
    assert _ssm_max(tc) > 1e-3 and _ssm_max(jc) > 1e-3
    pos = np.full(3, 11)
    for t in range(11, 15):
        lj, jc = decode(params, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                        jnp.asarray(pos), jc)
        with torch.no_grad():
            lt, tc2 = ttf.decode_step(tparams, tcfg,
                                      _t(toks[:, t:t + 1]).long(),
                                      _t(pos).long(), tc)
        assert tc2 is tc
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
        pos = pos + 1
    _check_caches(jc, tc)


# -----------------------------------------------------------------------------
# The engines
# -----------------------------------------------------------------------------

def _serve_kw(quant):
    return dict(max_slots=3, max_len=MAX_LEN, quant=quant)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


def _drain(eng, prompts):
    for p in prompts:
        eng.submit(p, max_tokens=NEW)
    return {r.uid: r.generated for r in eng.run_until_drained()}


def _acct(mod):
    return mod.CarbonAccountant(mod.AccountantConfig(
        device="tpu_v5e", n_devices=1, grid_mix="NY"))


def _jax_run(arch, quant):
    def make():
        jcfg, params, _, _ = _models(arch)
        acct = _acct(j_acct)
        eng = JServeEngine(params, jcfg, JServeConfig(**_serve_kw(quant)),
                           accountant=acct)
        return _drain(eng, _prompts(jcfg.vocab)), acct, eng
    return _cached(("jax", arch, quant), make)


def _port_run(arch, quant, **over):
    """The port's dense engine on the module's traffic; records each
    admission prefill's width and whether it was given lengths, and the
    requests admission sent back to the queue."""
    def make():
        _, _, tcfg, tparams = _models(arch)
        acct = _acct(t_acct)
        eng = ServeEngine(tparams, tcfg,
                          ServeConfig(device="cpu", **_serve_kw(quant),
                                      **over), accountant=acct)
        rec = {"calls": [], "requeued": 0}
        prefill, requeue = ttf.prefill, eng.scheduler.requeue_front

        def recorded_prefill(params, cfg, tokens, *a, lengths=None, **kw):
            rec["calls"].append((tuple(tokens.shape), lengths is None))
            out = prefill(params, cfg, tokens, *a, lengths=lengths, **kw)
            rec["ssm_max"] = max(rec.get("ssm_max", 0.0), _ssm_max(out[1]))
            return out

        def recorded_requeue(reqs):
            rec["requeued"] += len(reqs)
            return requeue(reqs)

        ttf.prefill = recorded_prefill
        eng.scheduler.requeue_front = recorded_requeue
        try:
            streams = _drain(eng, _prompts(tcfg.vocab))
        finally:
            ttf.prefill = prefill
        return streams, acct, eng, rec
    return _cached(("port", arch, quant, tuple(sorted(over.items()))), make)


@pytest.mark.parametrize("arch,quant", RUNS)
def test_greedy_streams_match_jax_and_reference(arch, quant):
    """Nine prompts of five lengths on three slots: every admission
    prefills prompts of one length, unpadded and with no ``lengths``, and
    sends the others back to the queue, in both engines alike; the port's
    streams equal the JAX engine's and the port's ``ReferenceEngine``'s
    (one prompt a prefill, one row a decode step), fp32 and int8."""
    got, _, eng, rec = _port_run(arch, quant)
    assert got == _jax_run(arch, quant)[0]
    assert all(len(s) == NEW for s in got.values())
    ref = ReferenceEngine(eng.params, eng.cfg,
                          ServeConfig(device="cpu", **_serve_kw(quant)))
    assert _drain(ref, _prompts(eng.cfg.vocab)) == got
    assert all(no_lengths and shape[1] in PROMPT_LENS
               for shape, no_lengths in rec["calls"])
    assert rec["requeued"] > 0 and rec["ssm_max"] > 1e-3
    assert len(rec["calls"]) > -(-len(PROMPT_LENS) // 3)
    if quant == "int8":
        assert eng.cfg.quant.weights_int8
        assert isinstance(eng.params["shared_attn"]["attn"]["wq"], dict)
        assert not isinstance(eng.params["pat0"]["ssd"]["w_x"], dict)


@pytest.mark.parametrize("arch,quant", RUNS)
def test_summary_and_accounting_equal_jax(arch, quant):
    """The summary's counts and the carbon report's modeled keys equal the
    JAX engine's; the bill counts an SSD block's ``w_z``, ``w_x`` and
    ``w_out`` (``SERVING_QUANT_KEYS``), not ``w_b``, ``w_c`` or ``w_dt``,
    and ``kv_bytes`` counts the shared sites' KV alone."""
    _, jacct, jeng = _jax_run(arch, quant)
    _, tacct, teng, _ = _port_run(arch, quant)
    wall = {"active_s", "operational_j", "operational_gco2",
            "amortized_fraction", "tokens_per_j", "j_per_token",
            "gco2_per_mtoken", "wall_s", "prefill_wall_s",
            "decode_tokens_per_s"}
    for want, got in ((jacct.report(), tacct.report()),
                      (jeng.summary(), teng.summary())):
        want = {k: v for k, v in want.items() if k not in wall}
        got = {k: v for k, v in got.items() if k not in wall}
        assert got.keys() == want.keys()
        for k, w in want.items():
            if isinstance(w, float):
                assert got[k] == pytest.approx(w, rel=1e-9, abs=0.0), k
            else:
                assert got[k] == w, k
    assert teng._matmul_elems == jeng._matmul_elems
    assert teng.kv_cache_bytes == jeng.kv_cache_bytes
    p, cfg = teng.params, teng.cfg
    ssd_keys = ("w_z", "w_x", "w_out")
    elems = sum(p[k]["ssd"][w].numel() for k in p if "ssd" in p.get(k, {})
                for w in ssd_keys)
    elems += p["embed"]["w"].numel()
    if "shared_attn" in p:
        sh = p["shared_attn"]
        elems += sum((v["q8"] if isinstance(v, dict) else v).numel()
                     for g in ("attn", "mlp") for v in sh[g].values())
    assert costing.matmul_weight_elems(p, cfg) == elems
    n_attn = sum(sp.kind == "attn" for sp in cfg.pattern) * cfg.repeats
    assert costing.attn_layers(cfg) == n_attn
    assert (teng.kv_cache_bytes == 0) == (n_attn == 0)


def test_nan_logits_quarantine_and_retry():
    """zamba2: NaN logits on one slot at tick 3 quarantine it once and
    retry its continuation (prompt plus committed tokens, re-prefilled
    from scratch, which rebuilds its SSM state) to the clean streams."""
    want = _port_run("zamba2-7b", "none")[0]
    got, _, eng, _ = _port_run(
        "zamba2-7b", "none",
        faults=FaultPlan.single("nan_logits", tick=3, seed=5))
    s = eng.summary()
    assert s["faults_injected"] == 1 and s["quarantined"] == 1
    assert s["recovery_tokens"] > 0
    assert got == want


def test_snapshot_restore_replays_the_journal(tmp_path):
    """mamba2: snapshots every 2 ticks, killed at tick 5; a fresh engine
    loads the tick-4 snapshot (SSD state under ``caches/<block>/conv_x``,
    ``conv_b``, ``conv_c``, ``ssm``), replays the journal's tail and
    drains to the clean streams."""
    want = _port_run("mamba2-1.3b", "none")[0]
    _, _, tcfg, tparams = _models("mamba2-1.3b")
    scfg = ServeConfig(device="cpu", **_serve_kw("none"),
                       checkpoint_dir=str(tmp_path), checkpoint_interval=2,
                       faults=FaultPlan.single("process_kill", tick=5,
                                               seed=1))
    eng = ServeEngine(tparams, tcfg, scfg)
    assert set(eng._device_tree()["caches"]["pat0"]) == set(tssd.SSD_LEAVES)
    for p in _prompts(tcfg.vocab):
        eng.submit(p, max_tokens=NEW)
    with pytest.raises(ProcessKilled, match="tick 5"):
        eng.run_until_drained()
    eng2 = ServeEngine(tparams, tcfg, scfg)
    got = {r.uid: r.generated for r in eng2.restore()}
    got.update({r.uid: r.generated for r in eng2.run_until_drained()})
    assert got == want
    assert eng2.summary()["replayed_ticks"] == 1
    assert _ssm_max(eng2.state.caches) > 1e-3


# -----------------------------------------------------------------------------
# Refusals
# -----------------------------------------------------------------------------

def test_paged_path_refused():
    """Both engines refuse the paged path for SSD/hybrid archs
    (tests/test_serve_paged.py:283), and so do the port's pool and
    launcher."""
    jcfg, _, tcfg, tparams = _models("zamba2-7b")
    with pytest.raises(NotImplementedError):
        JServeEngine({}, jcfg, JServeConfig(max_slots=1, paged=True))
    with pytest.raises(NotImplementedError, match="SSD"):
        ServeEngine(tparams, tcfg, ServeConfig(max_slots=1, paged=True,
                                               device="cpu"))
    with pytest.raises(NotImplementedError):
        ttf.init_paged_caches(tcfg, 4, 4, device="cpu")
    from repro_torch.launch import serve as launch
    with pytest.raises(NotImplementedError):
        launch.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                     "--paged", "--requests", "1"])


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_refused(arch):
    """``lengths`` raises in both packages before any parameter is read
    (tests/test_serve_core.py:334)."""
    jcfg, _, tcfg, _ = _models(arch)
    with pytest.raises(NotImplementedError):
        jtf.prefill({}, jcfg, jnp.zeros((2, 8), jnp.int32), max_len=16,
                    lengths=jnp.asarray([4, 8]))
    with pytest.raises(NotImplementedError, match="equal-length"):
        ttf.prefill({}, tcfg, torch.zeros((2, 8), dtype=torch.long),
                    max_len=16, lengths=torch.tensor([4, 8]))


def test_prompt_shorter_than_the_conv_window_refused():
    """A 2-token prompt (d_conv - 1 = 3): the JAX engine admits it and its
    admission scatter fails on the prefill's 2-row conv window (a latent
    reference fault, ROADMAP queue 3); the port refuses it at submit with
    a ``ValueError``, and its prefill refuses it too."""
    jcfg, params, tcfg, tparams = _models("mamba2-1.3b")
    assert tcfg.ssd_cfg.d_conv - 1 == 3
    jeng = JServeEngine(params, jcfg, JServeConfig(**_serve_kw("none")))
    jeng.submit(np.array([3, 4]), max_tokens=2)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jeng.step()
    eng = ServeEngine(tparams, tcfg,
                      ServeConfig(device="cpu", **_serve_kw("none")))
    with pytest.raises(ValueError, match="conv window"):
        eng.submit(np.array([3, 4]), max_tokens=2)
    assert not len(eng.scheduler)
    eng.submit(np.array([3, 4, 5]), max_tokens=2)
    assert len(eng.run_until_drained()) == 1
    with pytest.raises(ValueError, match="conv window"):
        ttf.prefill(tparams, tcfg, torch.tensor([[3, 4]]))


def test_zero_conv_init_leaves_the_state_dead():
    """The reason every test here draws live ``conv_b``/``conv_c``: on
    ``init_lm``'s own weights (both packages') every SSM state after a
    prefill is exactly zero."""
    jcfg = j_base.get("mamba2-1.3b").make_smoke()
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (1, 9))
    _, jc = jax.jit(lambda p, t: jtf.prefill(p, jcfg, t,
                                             cache_dtype=jnp.float32))(
        _init(jcfg), jnp.asarray(toks, jnp.int32))
    assert _ssm_max(jc) == 0.0
    tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
    with torch.no_grad():
        _, tc = ttf.prefill(ttf.init_lm(tcfg, device="cpu",
                                        dtype=torch.float32),
                            tcfg, _t(toks).long(),
                            cache_dtype=torch.float32)
    assert _ssm_max(tc) == 0.0
    assert isinstance(jc["pat0"]["ssd"], jssd.SSDState)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_and_example_serve_the_ssm_archs(arch, capsys):
    """``launch/serve.py --arch`` takes both archs (``--smoke``, and
    ``--repeats`` cutting zamba2's depth to one repeat and its tail), with
    ``--quant int8``, and so does the end-to-end example."""
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve as launch
    launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                 "3", "--max-tokens", "3", "--slots", "2", "--repeats", "1",
                 "--quant", "int8"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and '"bytes_moved"' in out
    serve_lm.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                   "--max-tokens", "2"])
    assert "decode ticks" in capsys.readouterr().out
