"""The MoE family on the port, against the JAX package on the same bridged
fp32 weights, on the CPU: moonshot-v1-16b-a3b (8 experts, top-2 in its
smoke config; 64, top-6 at full width) and kimi-k2-1t-a32b (12 experts,
top-3, GQA 8/2 and head dim 8 in smoke; 384, top-8 and head dim 112 at
full width).

An MoE block ranks the routes of every row of a call together and drops
those past its capacity, so a batch's rows are coupled: the port must
feed every call the rows the JAX engine feeds (dead slots, padding rows
and padding lanes included) for a live stream to come out the same. The
engine runs here use the configs' own capacity factors, at which routes
do drop, and hold the streams identical to the JAX engine's.

Bounds: forward logits within 1e-4 and the aux loss within rel 1e-5
(tests/test_torch_transformer.py's bound); prefill plus decode within 1e-3
of the forward (tests/test_models_smoke.py's bound) at a capacity where
nothing drops, and within 1e-4 of JAX's decode at the config's own;
paged_extend and paged_decode_step logits within 1e-4 and pools within
1e-5 (tests/test_torch_paged.py's bounds); greedy streams identical. The
JAX models and engine runs are cached per module.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.core import accounting as j_acct
from repro.models import transformer as jtf
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import snapshot as j_snapshot
from repro_torch import bridge
from repro_torch.configs import base as t_base
from repro_torch.core import accounting as t_acct
from repro_torch.models import costing as t_costing
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve import snapshot as t_snapshot


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


ARCHS = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
MAX_LEN = 40
PROMPT_LENS = (5, 13, 3, 19, 11, 1, 7)
NEW = 6
# engine modes: (arch, mode); three slots for seven prompts, so admissions
# are padded and slots die beside live ones
RUNS = (("moonshot-v1-16b-a3b", "dense"), ("moonshot-v1-16b-a3b", "paged"),
        ("moonshot-v1-16b-a3b", "int8"), ("moonshot-v1-16b-a3b", "spec"),
        ("kimi-k2-1t-a32b", "paged"))
_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _models(arch, cf=None):
    """(JAX cfg, JAX params, port cfg, port params) of ``arch``'s smoke
    config, with capacity factor ``cf`` when given (the same weights: the
    factor changes no parameter)."""
    def make():
        if cf is not None:
            jcfg, params, _, tparams = _models(arch)
            jcfg = dataclasses.replace(jcfg, moe_cfg=dataclasses.replace(
                jcfg.moe_cfg, capacity_factor=cf))
            return (jcfg, params,
                    bridge.config_from_dict(dataclasses.asdict(jcfg)),
                    tparams)
        jcfg = j_base.get(arch).make_smoke()
        params = jtf.init_lm(jax.random.PRNGKey(0), jcfg,
                             dtype=jnp.float32).params
        tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           tcfg, device="cpu")
        return jcfg, params, tcfg, tparams
    return _cached(("models", arch, cf), make)


def _t(a):
    return torch.from_numpy(np.array(a))


@contextlib.contextmanager
def _recording(rec):
    """Counts, in the port's calls: routes dropped and routed, the padding
    rows of admission calls (length 0)."""
    saved = tmoe.moe_capacity, ttf.prefill, ttf.paged_extend

    def moe_capacity(p, cfg, x, group_size=4096):
        _, ids, _ = tmoe.route(p, cfg, x.reshape(-1, x.shape[-1]))
        rec["dropped"] += int(tmoe.dropped_routes(cfg, ids, group_size).sum())
        rec["routes"] += ids.numel()
        return saved[0](p, cfg, x, group_size)

    def prefill(*a, lengths=None, **kw):
        if lengths is not None:
            rec["pad_rows"] += int((lengths == 0).sum())
        return saved[1](*a, lengths=lengths, **kw)

    def paged_extend(params, cfg, tokens, starts, lens, *a):
        rec["pad_rows"] += int((lens == 0).sum())
        return saved[2](params, cfg, tokens, starts, lens, *a)

    tmoe.moe_capacity, ttf.prefill, ttf.paged_extend = (
        moe_capacity, prefill, paged_extend)
    try:
        yield rec
    finally:
        tmoe.moe_capacity, ttf.prefill, ttf.paged_extend = saved


def _serve_kw(mode):
    kw = dict(max_slots=3, max_len=MAX_LEN)
    if mode != "dense":
        kw.update(paged=True, page_size=4, prefill_chunk=8)
    if mode == "int8":
        kw["quant"] = "int8"
    if mode == "spec":
        kw["spec_k"] = 4
    return kw


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


def _drain(eng, prompts, on_step=None):
    for p in prompts:
        eng.submit(p, max_tokens=NEW)
    done = []
    for _ in range(500):
        done += eng.step()
        if on_step is not None:
            on_step(eng)
        if not len(eng.scheduler) and all(r is None for r in eng.slot_req):
            break
    return {r.uid: r.generated for r in done}


def _acct(mod):
    return mod.CarbonAccountant(mod.AccountantConfig(
        device="tpu_v5e", n_devices=1, grid_mix="NY"))


def _jax_run(arch, mode):
    def make():
        jcfg, params, _, _ = _models(arch)
        acct = _acct(j_acct)
        eng = JServeEngine(params, jcfg, JServeConfig(**_serve_kw(mode)),
                           accountant=acct)
        return _drain(eng, _prompts(jcfg.vocab)), acct, eng
    return _cached(("jax", arch, mode), make)


def _port_run(arch, mode):
    def make():
        _, _, tcfg, tparams = _models(arch)
        acct = _acct(t_acct)
        rec = dict(dropped=0, routes=0, pad_rows=0, mixed_ticks=0)

        def on_step(eng):
            # the queue is empty and a slot is free beside live ones: the
            # next tick runs a dead slot's row in the MoE group
            live = [r is not None for r in eng.slot_req]
            if not len(eng.scheduler) and any(live) and not all(live):
                rec["mixed_ticks"] += 1

        eng = ServeEngine(tparams, tcfg,
                          ServeConfig(device="cpu", **_serve_kw(mode)),
                          accountant=acct)
        with _recording(rec):
            streams = _drain(eng, _prompts(tcfg.vocab), on_step)
        return streams, acct, eng, rec
    return _cached(("port", arch, mode), make)


# -----------------------------------------------------------------------------
# Configs and parameters
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_mirror_the_reference(arch):
    """The port's registry holds the arch, and its configs are the
    reference's, full size and smoke, through the bridge, ``moe_cfg`` and
    ``moe_group_size`` among the fields carried."""
    spec = j_base.get(arch)
    tspec = t_base.get(arch)
    assert tspec.family == "moe"
    assert tspec.active_fraction == spec.active_fraction
    for make, t_make in ((spec.make_config, tspec.make_config),
                         (spec.make_smoke, tspec.make_smoke)):
        got = bridge.config_from_dict(dataclasses.asdict(make()))
        assert got == t_make()
        assert got.moe_group_size == make().moe_group_size
        assert dataclasses.asdict(got.moe_cfg) == dataclasses.asdict(
            make().moe_cfg)
    full = tspec.make_config()
    assert full.resolved_head_dim == {"kimi-k2-1t-a32b": 112}.get(arch, 128)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_match(arch):
    """Every leaf of the JAX tree, the ``moe`` group's router and experts
    among them, with the port's shape."""
    _, params, tcfg, _ = _models(arch)
    tp = ttf.init_lm(tcfg, seed=0, dtype=torch.float32, device="cpu")
    want = {jax.tree_util.keystr(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", tuple(v.shape)

    assert dict(walk(tp)) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count_matches_jax(arch):
    """The full config's parameter count on the ``meta`` device equals the
    JAX ``eval_shape`` count (tests/test_models_smoke.py:110-121)."""
    from repro_torch.models import common
    spec = j_base.get(arch)
    ax = jax.eval_shape(
        lambda k: jtf.init_lm(k, spec.make_config(), dtype=jnp.bfloat16),
        jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ax.params))
    tp = ttf.init_lm(t_base.get(arch).make_config(), device="meta")
    leaves, _ = common.flatten(tp)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == want


def test_params_from_numpy_checks_the_experts():
    jcfg, params, tcfg, _ = _models("moonshot-v1-16b-a3b")
    tree = jax.tree.map(np.asarray, params)
    tree["pat0"]["moe"]["w_in"] = tree["pat0"]["moe"]["w_in"][:, :4]
    with pytest.raises(ValueError, match="experts"):
        bridge.params_from_numpy(tree, tcfg, device="cpu")


# -----------------------------------------------------------------------------
# The models
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match(arch):
    jcfg, params, tcfg, tparams = _models(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 20))
    want, waux = jtf.forward(params, jcfg, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got, gaux = ttf.forward(tparams, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(gaux) == pytest.approx(float(waux), rel=1e-5)
    assert float(gaux) > 0
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(np.roll(toks, -1, 1)).long()}
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    _, jm = jtf.loss_fn(params, jcfg, jb)
    with torch.no_grad():
        _, tm = ttf.loss_fn(tparams, tcfg, batch)
    assert float(tm["aux"]) == pytest.approx(float(jm["aux"]), rel=1e-5)
    assert float(tm["ce"]) == pytest.approx(float(jm["ce"]), rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode(arch):
    """At a capacity where nothing drops, a 6-token prefill and 6 decode
    steps give the forward's last logits (the groups differ, the routes
    do not); at the config's own capacity the decode logits equal JAX's."""
    jcfg, params, tcfg, tparams = _models(arch, cf=64.0)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 12))
    tt = torch.from_numpy(toks).long()
    rec = dict(dropped=0, routes=0, pad_rows=0)
    with torch.no_grad(), _recording(rec):
        full, _ = ttf.forward(tparams, tcfg, tt)
        _, caches = ttf.prefill(tparams, tcfg, tt[:, :6], max_len=12,
                                cache_dtype=torch.float32)
        for t in range(6, 12):
            last, caches = ttf.decode_step(tparams, tcfg, tt[:, t:t + 1],
                                           torch.tensor(t), caches)
    assert rec["dropped"] == 0 and rec["routes"] > 0
    np.testing.assert_allclose(last[:, 0].numpy(),
                               full[:, -1, :tcfg.vocab].numpy(), atol=1e-3)
    jcfg, params, tcfg, tparams = _models(arch)
    jt = jnp.asarray(toks, jnp.int32)
    _, jc = jtf.prefill(params, jcfg, jt[:, :6], max_len=12,
                        cache_dtype=jnp.float32)
    with torch.no_grad():
        _, tc = ttf.prefill(tparams, tcfg, tt[:, :6], max_len=12,
                            cache_dtype=torch.float32)
    pos = np.array([6, 6])
    for t in range(6, 12):
        jlast, jc = jtf.decode_step(params, jcfg, jt[:, t:t + 1],
                                    jnp.asarray(pos), jc)
        with torch.no_grad():
            tlast, tc = ttf.decode_step(tparams, tcfg, tt[:, t:t + 1],
                                        _t(pos).long(), tc)
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   atol=1e-4)
        pos = pos + 1


NPAGES, PS, NSLOTS, NBLK = 16, 4, 3, 5


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_extend_and_decode_step_match_jax(arch, cf):
    """Two extend chunks over three rows (the second with a dead row last,
    where the engine puts its padding rows; each chunk with padding lanes
    past a row's length, which join the MoE group), then three decode
    ticks with one lane inactive, at the config's own capacity factor and
    at 0.5, where routes drop."""
    jcfg, params, tcfg, tparams = _models(arch, cf)
    jc = jtf.init_paged_caches(jcfg, NPAGES, PS, dtype=jnp.float32)
    tc = ttf.init_paged_caches(tcfg, NPAGES, PS, dtype=torch.float32,
                               device="cpu")
    rng = np.random.default_rng(3)
    pt = rng.permutation(NPAGES)[:NSLOTS * NBLK].reshape(
        NSLOTS, NBLK).astype(np.int32)
    starts = np.zeros(NSLOTS, np.int32)
    rec = dict(dropped=0, routes=0, pad_rows=0)
    for chunk in ((7, 5, 8), (6, 3, 0)):
        lens = np.asarray(chunk, np.int32)
        toks = rng.integers(0, jcfg.vocab, (NSLOTS, 8)).astype(np.int32)
        lj, jc = jtf.paged_extend(params, jcfg, jnp.asarray(toks),
                                  jnp.asarray(starts), jnp.asarray(lens),
                                  jnp.asarray(pt), jc)
        with torch.no_grad(), _recording(rec):
            lt, tc = ttf.paged_extend(tparams, tcfg, _t(toks).long(),
                                      _t(starts).long(), _t(lens).long(),
                                      _t(pt), tc)
        live = lens > 0
        np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live],
                                   atol=1e-4)
        _check_pools(jc, tc)
        starts = starts + lens
    tok = rng.integers(0, jcfg.vocab, NSLOTS).astype(np.int32)
    pos = starts.copy()
    active = np.array([True, False, True])
    for _ in range(3):
        lj, jc = jtf.paged_decode_step(params, jcfg, jnp.asarray(tok[:, None]),
                                       jnp.asarray(pos), jnp.asarray(pt), jc,
                                       active=jnp.asarray(active))
        with torch.no_grad(), _recording(rec):
            lt, tc = ttf.paged_decode_step(tparams, tcfg,
                                           _t(tok[:, None]).long(),
                                           _t(pos).long(), _t(pt), tc,
                                           active=_t(active))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        _check_pools(jc, tc)
        tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)
        pos = pos + active
    if cf is not None:
        assert rec["dropped"] > 0


def _check_pools(jc, tc, sink=NPAGES):
    """Pools within 1e-5 outside the sink page."""
    for key, entry in jc.items():
        for name in ("k", "v"):
            want = np.delete(np.asarray(getattr(entry["kv"], name)), sink,
                             axis=1)
            got = np.delete(getattr(tc[key]["kv"], name).numpy(), sink,
                            axis=1)
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=key)


# -----------------------------------------------------------------------------
# The engine
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode", RUNS)
def test_greedy_streams_match_jax_engine(arch, mode):
    """Seven prompts of 1-19 tokens on three slots, six tokens each, at the
    config's own capacity factor: routes drop, admissions carry padding
    rows, and dead slots tick beside live ones, in both engines alike."""
    got, _, _, rec = _port_run(arch, mode)
    want = _jax_run(arch, mode)[0]
    assert got == want
    assert all(len(s) == NEW for s in got.values())
    assert rec["dropped"] > 0, rec
    assert rec["pad_rows"] > 0 and rec["mixed_ticks"] > 0, rec


@pytest.mark.parametrize("arch,mode", [RUNS[0], RUNS[1]])
def test_modeled_accounting_equals_jax(arch, mode):
    """The carbon report of the same run, modeled FLOPs, bytes and J/token
    among its keys, equals the JAX engine's: the experts are billed at
    top_k / n_experts (``costing.matmul_weight_elems``'s ``moe_frac``)."""
    _, jacct, jeng = _jax_run(arch, mode)
    _, tacct, teng, _ = _port_run(arch, mode)
    wall = {"active_s", "operational_j", "operational_gco2",
            "amortized_fraction", "tokens_per_j", "j_per_token",
            "gco2_per_mtoken"}
    want = {k: v for k, v in jacct.report().items() if k not in wall}
    got = {k: v for k, v in tacct.report().items() if k not in wall}
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=1e-9, abs=0.0), k
        else:
            assert got[k] == w, k
    assert teng._matmul_elems == jeng._matmul_elems
    # every expert billed as if it ran would be more
    m = teng.cfg.moe_cfg
    experts = sum(teng.params["pat0"]["moe"][k].numel()
                  for k in ("w_in", "w_gate", "w_out"))
    assert teng._matmul_elems == pytest.approx(
        t_costing.matmul_weight_elems(
            {k: v for k, v in teng.params.items()}, teng.cfg))
    assert (t_costing.matmul_weight_elems(teng.params, dataclasses.replace(
        teng.cfg, moe_cfg=dataclasses.replace(m, top_k=m.n_experts)))
        - teng._matmul_elems) == pytest.approx(
            experts * (1 - m.top_k / m.n_experts))


def test_snapshot_fingerprint_equals_jax():
    """``config_fingerprint`` of an MoE engine's serve config, as JAX's."""
    _, _, jeng = _jax_run("moonshot-v1-16b-a3b", "paged")
    _, _, teng, _ = _port_run("moonshot-v1-16b-a3b", "paged")
    assert (t_snapshot.config_fingerprint(teng.scfg)
            == j_snapshot.config_fingerprint(jeng.scfg))


@pytest.mark.parametrize("arch,extra", [
    ("moonshot-v1-16b-a3b", ["--paged", "--page-size", "4",
                             "--prefill-chunk", "8", "--spec-k", "4",
                             "--quant", "int8"]),
    ("kimi-k2-1t-a32b", ["--paged", "--page-size", "4", "--repeats", "1"])])
def test_launcher_and_example_serve_the_moe_archs(arch, extra, capsys):
    """``launch/serve.py --arch`` takes both archs (their smoke configs,
    ``--repeats`` cutting the depth), and so does the end-to-end
    example."""
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve as launch
    launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                 "3", "--max-tokens", "3", "--slots", "2"] + extra)
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and '"bytes_moved"' in out
    serve_lm.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                   "--max-tokens", "2"])
    assert "decode ticks" in capsys.readouterr().out
