"""Cell builder: (architecture x input shape x mesh) -> one runnable step
(mirror of ``repro.launch.cells``).

A cell packages what the dry-run and a card's run need:

* the step function (a training step, a prefill or a decode step);
* its arguments as **meta tensors**, the counterpart of the reference's
  zero-allocation ``ShapeDtypeStruct`` stand-ins: shapes and dtypes,
  nothing allocated, so a trillion-parameter cell builds on any machine;
* the placements of every argument on the mesh (``parallel.sharding``
  from the logical-axes trees, with the long-context rules at batch 1);
* the model-FLOPs inputs (parameter counts, tokens a step) and the
  analytic live-bytes estimate of a device.

``Cell.materialize(device, seed)`` builds real arguments of the same
shapes and dtypes (weights from the seed, random caches and tokens), and
``Cell.run(*args)`` takes one step. The decode cells put the batch at the
last position of the cache (``seq_len - 1``: every step attends the full
cache, the "32k KV" of ``decode_32k``), and an LM decode step hands
``decode_step`` that position once per row, the serving engine's form,
so its attention runs on K1. The overrides ``_fsdp`` (weights and
optimizer state also sharded over the DP axes), ``_weights_int8`` (the
linear weights served int8, every projection on K4) and
``_kv_seq_shard`` (KV caches sharded on the sequence over the model
axis) are honoured; the reference's TPU-only knobs (``remat``,
``decode_kernel``, ``flash_train``, ``sp_attention``, ``sp_residual``)
have no counterpart here and are recorded in ``Cell.notes``. An fp8 KV
cache (``kv_cache_dtype="fp8"``) raises ``ValueError``: no port path
decodes over one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state
from repro_torch.optim.adamw import opt_state_axes
from repro_torch.parallel import sharding as sh
from repro_torch.quant.int8 import quantize_params_for_serving
from repro_torch.train.loop import value_and_grad

PyTree = Any

PARAM_DTYPE = torch.bfloat16
CACHE_DTYPE = torch.bfloat16

# the reference's LMConfig knobs with no counterpart in the port
_TPU_KNOBS = ("remat", "decode_kernel", "flash_train", "sp_attention",
              "sp_residual", "kv_cache_dtype")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str                        # train | prefill | decode
    step_fn: Callable
    args_meta: Tuple                 # meta tensors, positional
    in_shardings: Tuple              # placements, per argument leaf
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    n_params_total: float
    n_params_active: float
    tokens_per_step: float
    rules: Any = None
    notes: str = ""
    # analytic live-bytes estimate a device: args + saved carries +
    # workspace (the reference's formula)
    analytic_live_bytes: float = 0.0
    cfg: Any = None
    materialize_fn: Optional[Callable] = None

    def materialize(self, device="cuda", seed: int = 0) -> Tuple:
        """Real arguments of the meta arguments' shapes and dtypes on
        ``device``: the weights from ``seed`` (``init_lm`` /
        ``init_encdec``), caches, tokens and frames drawn from it."""
        return self.materialize_fn(torch.device(device), seed)

    def run(self, *args):
        """One step on ``args`` (``materialize``'s): the step's outputs;
        a decode step's caches and a training step's params and optimizer
        state are updated in place (the reference donates them)."""
        return self.step_fn(*args)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [x for f in tree.__dataclass_fields__
                for x in _leaves(getattr(tree, f))]
    return [tree]


def tree_bytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for t in _leaves(tree)))


def local_bytes(tree, placements, mesh) -> float:
    """Bytes of ``tree``'s shards on one device under its placements (a
    tree of ``placements_for`` tuples, or one tuple for a lone tensor)."""
    out = 0.0
    pls = ([placements] if isinstance(tree, torch.Tensor)
           else _leaves(placements))
    for t, pl in zip(_leaves(tree), pls):
        shape = list(t.shape)
        for size, p in zip(mesh.sizes, pl):
            if p.is_shard():
                shape[p.dim] = -(-shape[p.dim] // size)
        out += math.prod(shape) * t.element_size()
    return out


def _live_bytes_estimate(mesh, *, kind: str, n_params: float,
                         n_layers: int, d_model: int, tokens: float,
                         opt_bytes_per_param: float = 4.0,
                         cache_bytes: float = 0.0) -> float:
    """Live bytes a device: params (+ grads) + optimizer + bf16 saved
    carries + 2 GB workspace (cells.py:84-98)."""
    n_model = mesh.shape.get("model", 1)
    n_dev = math.prod(mesh.shape.values())
    params_dev = n_params * 2.0 / n_model            # bf16, TP-sharded
    if kind == "train":
        opt_dev = n_params * opt_bytes_per_param / n_model
        grads_dev = params_dev                        # bf16 grads
        tokens_dev = tokens / max(n_dev // n_model, 1)
        carries_dev = n_layers * tokens_dev * d_model * 2.0
        return params_dev + opt_dev + grads_dev + carries_dev + 2e9
    return params_dev + cache_bytes / n_dev + 2e9


def _adamw_for(arch: cfgbase.ArchSpec) -> AdamWConfig:
    # memory-lean fleet default: bf16 moments, no fp32 master; kimi-k2 (1T)
    # drops to int8 moments
    state = "int8" if arch.params_nominal >= 5e11 else "bf16"
    return AdamWConfig(lr=3e-4, state_dtype=state, use_master=False,
                       grad_clip=1.0)


def _active_params(arch: cfgbase.ArchSpec, cfg, n_params: float) -> float:
    if arch.family != "moe":
        return n_params
    # experts contribute active_fraction; everything else fully active
    moe = cfg.moe_cfg
    expert_params = (cfg.repeats * len(cfg.pattern) * moe.n_experts
                     * 3 * moe.d_model * moe.d_ff)
    return n_params - expert_params * (1.0 - arch.active_fraction)


def _split_overrides(overrides: Optional[dict]):
    """(config overrides, cell flags, notes) of a cell's overrides."""
    overrides = dict(overrides or {})
    flags = {k: overrides.pop(k, False)
             for k in ("_fsdp", "_weights_int8", "_kv_seq_shard")}
    if overrides.get("kv_cache_dtype", "bf16") != "bf16":
        raise ValueError(f"kv_cache_dtype={overrides['kv_cache_dtype']!r}: "
                         f"the port's decode path has no fp8 cache")
    ignored = {k: overrides.pop(k) for k in _TPU_KNOBS if k in overrides}
    notes = (f"TPU-only knobs with no counterpart here: {ignored}"
             if ignored else "")
    return overrides, flags, notes


def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _randint(gen, high: int, shape, device) -> torch.Tensor:
    return torch.randint(0, high, tuple(shape), generator=gen, device=device,
                         dtype=torch.int32)


def _randn(gen, like: torch.Tensor, device) -> torch.Tensor:
    return torch.randn(tuple(like.shape), generator=gen, device=device,
                       dtype=torch.float32).to(like.dtype)


def _fill_cache_rows(gen, t: torch.Tensor, seq_dim: int, n_rows: int
                     ) -> None:
    """Rows [0, n_rows) along ``seq_dim`` of a cache tensor drawn in place
    (N(0, 1), or int8 codes in [-127, 127]): no copy of the cache."""
    rows = t.narrow(seq_dim, 0, n_rows)
    if t.dtype == torch.int8:
        rows.random_(-127, 128, generator=gen)
    else:
        rows.normal_(generator=gen)


# -----------------------------------------------------------------------------
# LM cells
# -----------------------------------------------------------------------------

def _lm_batch(cfg, shape: cfgbase.ShapeSpec, for_train: bool) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, s), torch.int32)}
    if for_train:
        batch["labels"] = _meta((b, s), torch.int32)
    if cfg.pos_emb == "mrope":
        batch["positions"] = _meta((b, s, 3), torch.int32)
    if cfg.vision_tokens > 0:
        batch["vision_embeds"] = _meta((b, cfg.vision_tokens, cfg.d_model),
                                       PARAM_DTYPE)
    return batch


def _lm_batch_axes(cfg, for_train: bool) -> dict:
    axes = {"tokens": ("batch", "seq")}
    if for_train:
        axes["labels"] = ("batch", "seq")
    if cfg.pos_emb == "mrope":
        axes["positions"] = ("batch", "seq", None)
    if cfg.vision_tokens > 0:
        axes["vision_embeds"] = ("batch", None, "embed")
    return axes


def _real_batch(meta: dict, vocab: int, gen, device) -> dict:
    out = {}
    for k, t in meta.items():
        if k == "positions":
            b, s, _ = t.shape
            pos = torch.arange(s, device=device, dtype=torch.int32)
            out[k] = pos[None, :, None].expand(b, s, 3).contiguous()
        elif t.dtype == torch.int32:
            out[k] = _randint(gen, vocab, t.shape, device)
        else:
            out[k] = _randn(gen, t, device)
    return out


def _lm_params(cfg, w8: bool, seed: int, device):
    params = tf_lib.init_lm(cfg, seed=seed, dtype=PARAM_DTYPE, device=device)
    if w8:
        params, _ = quantize_params_for_serving(params, tf_lib.lm_axes(cfg))
    return params


def build_lm_cell(arch: cfgbase.ArchSpec, shape: cfgbase.ShapeSpec, mesh, *,
                  overrides: Optional[dict] = None) -> Cell:
    cfg = arch.make_config()
    cfg_over, flags, notes = _split_overrides(overrides)
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    w8 = flags["_weights_int8"]
    if w8:
        # the served projections run on K4 (QuantPolicy weights "int8")
        cfg = dataclasses.replace(
            cfg, quant=dataclasses.replace(cfg.quant, weights="int8"))
    rules = (sh.LONG_CONTEXT_RULES if shape.global_batch == 1
             else sh.DEFAULT_RULES)
    param_rules = dict(rules)
    if flags["_fsdp"]:
        param_rules["embed"] = ("pod", "data")

    params = tf_lib.init_lm(cfg, dtype=PARAM_DTYPE, device="meta")
    params_axes = tf_lib.lm_axes(cfg)
    n_params = float(sum(t.numel() for t in _leaves(params)))
    if w8:
        params, params_axes = quantize_params_for_serving(params,
                                                          params_axes)
    param_shardings = sh.shardings_for_tree(params, params_axes, mesh,
                                            param_rules)
    n_active = _active_params(arch, cfg, n_params)
    b, s = shape.global_batch, shape.seq_len
    common_kw = dict(arch_id=arch.arch_id, shape_name=shape.name,
                     n_params_total=n_params, n_params_active=n_active,
                     rules=rules, notes=notes, cfg=cfg)

    if shape.kind == "train":
        opt_cfg = _adamw_for(arch)
        opt_state = init_opt_state(params, opt_cfg)
        _trainable(params)
        opt_shardings = sh.shardings_for_tree(
            opt_state, opt_state_axes(params_axes, opt_cfg), mesh,
            param_rules)
        batch = _lm_batch(cfg, shape, True)
        batch_shardings = sh.shardings_for_tree(
            batch, _lm_batch_axes(cfg, True), mesh, rules)

        def train_step(params, opt_state, batch):
            loss, aux, grads = value_and_grad(
                lambda p, bt: tf_lib.loss_fn(p, cfg, bt), params, batch)
            # gradients in the params' dtype, as the reference pins them
            grads = _cast_like(grads, params)
            new_p, new_s, om = apply_updates(params, grads, opt_state,
                                             opt_cfg)
            return new_p, new_s, {"loss": loss, **om}

        def materialize(device, seed):
            gen = _gen(device, seed)
            p = _trainable(_lm_params(cfg, w8, seed, device))
            return (p, init_opt_state(p, opt_cfg),
                    _real_batch(batch, cfg.vocab, gen, device))

        return Cell(
            kind="train", step_fn=train_step,
            args_meta=(params, opt_state, batch),
            in_shardings=(param_shardings, opt_shardings, batch_shardings),
            out_shardings=(param_shardings, opt_shardings, None),
            donate_argnums=(0, 1), tokens_per_step=b * s,
            analytic_live_bytes=_live_bytes_estimate(
                mesh, kind="train", n_params=n_params,
                n_layers=cfg.n_layers, d_model=cfg.d_model, tokens=b * s,
                opt_bytes_per_param=(2.0 if opt_cfg.state_dtype == "int8"
                                     else 4.0)),
            materialize_fn=materialize, **common_kw)

    caches = tf_lib.init_caches(cfg, b, s, CACHE_DTYPE, device="meta")

    if shape.kind == "prefill":
        batch = _lm_batch(cfg, shape, False)
        batch_shardings = sh.shardings_for_tree(
            batch, _lm_batch_axes(cfg, False), mesh, rules)
        cache_shardings = sh.shardings_for_tree(
            caches, tf_lib.caches_axes(cfg), mesh, rules)

        def prefill_step(params, batch):
            return tf_lib.prefill(params, cfg, batch["tokens"], max_len=s,
                                  vision_embeds=batch.get("vision_embeds"),
                                  cache_dtype=CACHE_DTYPE)

        def materialize(device, seed):
            return (_lm_params(cfg, w8, seed, device),
                    _real_batch(batch, cfg.vocab, _gen(device, seed),
                                device))

        return Cell(
            kind="prefill", step_fn=prefill_step, args_meta=(params, batch),
            in_shardings=(param_shardings, batch_shardings),
            out_shardings=(None, cache_shardings), donate_argnums=(),
            tokens_per_step=b * s,
            analytic_live_bytes=_live_bytes_estimate(
                mesh, kind="prefill", n_params=n_params,
                n_layers=cfg.n_layers, d_model=cfg.d_model, tokens=b * s,
                cache_bytes=tree_bytes(caches)),
            materialize_fn=materialize, **common_kw)

    # decode: "_kv_seq_shard" shards the KV caches on the sequence over the
    # model axis instead of on head_dim
    cache_rules = (dict(rules, seq="model") if flags["_kv_seq_shard"]
                   else rules)
    cache_shardings = sh.shardings_for_tree(
        caches, tf_lib.caches_axes(cfg), mesh, cache_rules)
    tok_spec = sh.spec_for((b, 1), ("batch", "seq"), mesh, rules)

    def decode(params, token, pos, caches):
        # one position per row: the serving engine's form, on K1
        return tf_lib.decode_step(params, cfg, token,
                                  pos.expand(token.shape[0]), caches)

    def materialize(device, seed):
        gen = _gen(device, seed)
        c = tf_lib.init_caches(cfg, b, s, CACHE_DTYPE, device=device)
        _fill_lm_caches(gen, c, s - 1)
        return (_lm_params(cfg, w8, seed, device),
                _randint(gen, cfg.vocab, (b, 1), device),
                torch.tensor(s - 1, dtype=torch.int32, device=device), c)

    return Cell(
        kind="decode", step_fn=decode,
        args_meta=(params, _meta((b, 1), torch.int32),
                   _meta((), torch.int32), caches),
        in_shardings=(param_shardings, sh.placements_for(tok_spec, mesh),
                      sh.placements_for((), mesh), cache_shardings),
        out_shardings=(None, cache_shardings), donate_argnums=(3,),
        tokens_per_step=b, materialize_fn=materialize, **common_kw)


def _trainable(params):
    """Every floating-point leaf requires grad (the training step
    differentiates them)."""
    for t in _leaves(params):
        if t.is_floating_point():
            t.requires_grad_(True)
    return params


def _cast_like(grads, params):
    if isinstance(grads, dict):
        return {k: _cast_like(g, params[k]) for k, g in grads.items()}
    return grads.to(params.dtype)


def _fill_lm_caches(gen, caches: dict, pos: int) -> None:
    """A cache that holds positions [0, pos) (the last clen of them in a
    ring, position p at row p % clen): random K/V rows and their position
    tags; SSD states N(0, 0.1)."""
    for entry in caches.values():
        if "ssd" in entry:
            for t in entry["ssd"].tensors():
                t.normal_(0.0, 0.1, generator=gen)
            continue
        tags = entry["pos"]
        clen = tags.shape[-1]
        kept = torch.arange(max(0, pos - clen), pos, device=tags.device)
        seq_dim = tags.dim() - 1
        for pair in (entry["kv"],) + ((entry["kv_scale"],)
                                      if "kv_scale" in entry else ()):
            for t in (pair.k, pair.v):
                _fill_cache_rows(gen, t, seq_dim, len(kept))
        tags[..., kept % clen] = kept.to(torch.int32)


# -----------------------------------------------------------------------------
# Encoder-decoder (whisper) cells
# -----------------------------------------------------------------------------

def build_encdec_cell(arch: cfgbase.ArchSpec, shape: cfgbase.ShapeSpec,
                      mesh, *, overrides: Optional[dict] = None) -> Cell:
    cfg = arch.make_config()
    cfg_over, _flags, notes = _split_overrides(overrides)
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    rules = (sh.LONG_CONTEXT_RULES if shape.global_batch == 1
             else sh.DEFAULT_RULES)
    params = encdec_lib.init_encdec(cfg, dtype=PARAM_DTYPE, device="meta")
    params_axes = encdec_lib.encdec_axes(cfg)
    param_shardings = sh.shardings_for_tree(params, params_axes, mesh, rules)
    n_params = float(sum(t.numel() for t in _leaves(params)))
    b, s = shape.global_batch, shape.seq_len
    frames = _meta((b, cfg.n_audio_ctx, cfg.d_model), PARAM_DTYPE)
    frames_pl = sh.placements_for(
        sh.spec_for(frames.shape, ("batch", None, "embed"), mesh, rules),
        mesh)
    tok_pl = sh.placements_for(sh.spec_for((b, s), ("batch", "seq"), mesh,
                                           rules), mesh)
    common_kw = dict(arch_id=arch.arch_id, shape_name=shape.name,
                     n_params_total=n_params, n_params_active=n_params,
                     rules=rules, notes=notes, cfg=cfg)

    def real_params(seed, device):
        return encdec_lib.init_encdec(cfg, seed=seed, dtype=PARAM_DTYPE,
                                      device=device)

    if shape.kind == "train":
        opt_cfg = _adamw_for(arch)
        opt_state = init_opt_state(params, opt_cfg)
        _trainable(params)
        opt_shardings = sh.shardings_for_tree(
            opt_state, opt_state_axes(params_axes, opt_cfg), mesh, rules)
        batch = {"frames": frames, "tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32)}

        def train_step(params, opt_state, batch):
            loss, aux, grads = value_and_grad(
                lambda p, bt: encdec_lib.loss_fn(p, cfg, bt), params, batch)
            new_p, new_s, om = apply_updates(params, grads, opt_state,
                                             opt_cfg)
            return new_p, new_s, {"loss": loss, **om}

        def materialize(device, seed):
            p = _trainable(real_params(seed, device))
            return (p, init_opt_state(p, opt_cfg),
                    _real_batch(batch, cfg.vocab, _gen(device, seed),
                                device))

        return Cell(kind="train", step_fn=train_step,
                    args_meta=(params, opt_state, batch),
                    in_shardings=(param_shardings, opt_shardings,
                                  {"frames": frames_pl, "tokens": tok_pl,
                                   "labels": tok_pl}),
                    out_shardings=(param_shardings, opt_shardings, None),
                    donate_argnums=(0, 1), tokens_per_step=b * s,
                    materialize_fn=materialize, **common_kw)

    if shape.kind == "prefill":
        batch = {"frames": frames, "tokens": _meta((b, s), torch.int32)}

        def prefill_step(params, batch):
            enc_out = encdec_lib.encode(params, cfg, batch["frames"])
            logits = encdec_lib.decode_train(params, cfg, batch["tokens"],
                                             enc_out)
            return logits[:, -1:]

        def materialize(device, seed):
            return (real_params(seed, device),
                    _real_batch(batch, cfg.vocab, _gen(device, seed),
                                device))

        return Cell(kind="prefill", step_fn=prefill_step,
                    args_meta=(params, batch),
                    in_shardings=(param_shardings,
                                  {"frames": frames_pl, "tokens": tok_pl}),
                    out_shardings=None, donate_argnums=(),
                    tokens_per_step=b * s, materialize_fn=materialize,
                    **common_kw)

    # decode
    caches = encdec_lib.init_dec_caches(cfg, b, s, CACHE_DTYPE,
                                        device="meta")
    cache_shardings = sh.shardings_for_tree(
        caches, encdec_lib.dec_caches_axes(), mesh, rules)
    tok1_pl = sh.placements_for(sh.spec_for((b, 1), ("batch", "seq"), mesh,
                                            rules), mesh)

    def decode(params, token, pos, caches):
        # a meta position holds no value; the cells decode at the cache's
        # last row, whatever stands for it costs the same
        return encdec_lib.decode_step(params, cfg, token,
                                      s - 1 if pos.is_meta else pos, caches)

    def materialize(device, seed):
        gen = _gen(device, seed)
        c = encdec_lib.init_dec_caches(cfg, b, s, CACHE_DTYPE, device=device)
        for t in (c["self"].k, c["self"].v):
            _fill_cache_rows(gen, t, 2, s - 1)
        for t in (c["cross"].k, c["cross"].v):
            _fill_cache_rows(gen, t, 2, t.shape[2])
        return (real_params(seed, device),
                _randint(gen, cfg.vocab, (b, 1), device),
                torch.tensor(s - 1, dtype=torch.int32, device=device), c)

    return Cell(kind="decode", step_fn=decode,
                args_meta=(params, _meta((b, 1), torch.int32),
                           _meta((), torch.int32), caches),
                in_shardings=(param_shardings, tok1_pl,
                              sh.placements_for((), mesh), cache_shardings),
                out_shardings=(None, cache_shardings), donate_argnums=(3,),
                tokens_per_step=b,
                analytic_live_bytes=_live_bytes_estimate(
                    mesh, kind="decode", n_params=n_params,
                    n_layers=cfg.n_layers, d_model=cfg.d_model, tokens=b,
                    cache_bytes=tree_bytes(caches)),
                materialize_fn=materialize, **common_kw)


# -----------------------------------------------------------------------------
# public entry
# -----------------------------------------------------------------------------

def build_cell(arch_id: str, shape_name: str, mesh,
               overrides: Optional[dict] = None, *,
               shape: Optional[cfgbase.ShapeSpec] = None) -> Cell:
    """The cell of ``arch_id`` at ``SHAPES[shape_name]`` (or ``shape``, a
    cut of it) on ``mesh``."""
    arch = cfgbase.get(arch_id)
    shape = shape or cfgbase.SHAPES[shape_name]
    if shape_name not in arch.shapes:
        raise ValueError(f"{arch_id} skips {shape_name}: {arch.notes}")
    if arch.kind == "lm":
        return build_lm_cell(arch, shape, mesh, overrides=overrides)
    if arch.kind == "encdec":
        return build_encdec_cell(arch, shape, mesh, overrides=overrides)
    raise ValueError(f"{arch_id} ({arch.kind}) has no mesh cells")

