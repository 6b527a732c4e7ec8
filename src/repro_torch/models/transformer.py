"""Decoder-only LM of the PyTorch port (mirror of
``repro.models.transformer``): attention, MoE, SSD and hybrid stacks.

The layer schedule is ``pattern x repeats + tail``, and parameters and
caches keep the JAX tree's layout: each ``pat{i}`` entry is stacked over
``repeats`` on a leading dim. A Python loop over the repeats stands in for
the original's ``lax.scan``; indexing the stacked tensors gives views, so
no layer's weights or cache are copied.

The decode step updates the KV cache in place (``index_put_``); that is the
counterpart of the JAX engine donating its cache to the jitted tick.
Per-slot positions send decode attention through ``kernels.ops`` (the K1
kernel on the card); a scalar position takes the masked ``sdpa`` path, as
in JAX. The paged pool (``init_paged_caches``) is updated in place too:
``paged_decode_step`` attends through K2, ``paged_extend`` through K3 and
the speculative ``paged_verify_step`` (T query lanes per slot) through K5.
M-RoPE (qwen2-vl: (B, S, 3) positions, text tokens on three equal
streams) and the stub vision frontend (``vision_embeds`` written over the
first tokens' embeddings) run on every path. Ring caches (gemma3's
window-sized caches, ``ring_cache``) run on the dense path only: a row
lands at slot ``pos % clen`` with its position tag, and attention over it
is the masked ``sdpa``, as in the reference; the paged path refuses them.
MoE blocks (``BlockSpec(moe=True)``, ``models.moe``) replace the FFN with
``moe_capacity`` on every path, grouped as the reference groups them: the
full-sequence passes (``forward``, ``prefill``, ``paged_extend``) in
groups of ``cfg.moe_group_size`` tokens, the decode and verify steps in
one group of every token of the call, dead slots and padding rows
included, so a batch's rows are no longer independent once routes drop.
SSD blocks (``BlockSpec(kind="ssd")``, ``models.ssd``: mamba2) run the
chunked scan on the full-sequence passes and the recurrent form at
decode, their state (three conv windows and the fp32 SSM state, an
``SSDState`` under the cache entry's ``"ssd"``) updated in place; blocks
marked ``shared_attn`` (zamba2) run the one ``shared_attn`` parameter
group (attention and a gated MLP) at every site, each site with its own
KV cache. SSD stacks serve on the dense path only (``paged_supported``),
and their prefill takes no ``lengths``: an SSM state integrates over
padding, so the engine admits equal-length prompts together.

Training: ``forward`` and ``loss_fn`` run the full sequence with autograd;
with ``positions=None`` attention goes through ``ops.flash_attention_train``
(K6 forward, K7 and K8 backward on the card), and ``rms_norm`` carries the
reference's custom backward.

The int8 serving mode (``QuantPolicy`` ``INT8_QUANT``, DESIGN.md §12):
``quantize_lm`` turns the linear weights into ``{"q8", "s8"}`` leaves,
every projection runs through ``layers.q8_matmul`` (K4 on the card), and
the KV cache or pool holds int8 codes plus one fp32 scale per (slot or
page row, position, kv-head) in a ``kv_scale`` pair, written by rowwise
quantization and read by the int8-KV modes of K1, K2 and K3.
"""


from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.kernels import ops
from repro_torch.models import common, layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.layers import AttnConfig, KVCache
from repro_torch.quant import int8 as int8_lib

PyTree = Any


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str = "attn"          # "attn" | "ssd"
    window: int = -1            # sliding window (attn); <0 = global
    moe: bool = False           # MoE FFN instead of dense FFN
    shared_attn: bool = False   # zamba2: use the single shared attention block
    has_ffn: bool = True        # pure mamba blocks have no separate FFN


QUANT_MODES = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Serving-time quantization policy (``weights``/``kv``: "none" |
    "int8")."""
    weights: str = "none"
    kv: str = "none"

    @property
    def weights_int8(self) -> bool:
        return self.weights == "int8"

    @property
    def kv_int8(self) -> bool:
        return self.kv == "int8"


INT8_QUANT = QuantPolicy(weights="int8", kv="int8")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The fields of ``repro.models.transformer.LMConfig`` that describe the
    model and its loss; the TPU-only knobs (sharding, remat, the Pallas
    switches ``decode_kernel`` and ``flash_train``) have no counterpart
    here (``bridge.config_from_dict`` drops them): the kernels' routes
    follow the reference's own eligibility alone. ``moe_group_size`` is
    kept: it sets which routes an MoE block drops."""
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[BlockSpec, ...]
    repeats: int
    tail: Tuple[BlockSpec, ...] = ()
    head_dim: Optional[int] = None
    act: str = "silu"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    pos_emb: str = "rope"                    # "rope" | "mrope" | "none"
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)
    tie_embeddings: bool = True
    vision_tokens: int = 0                   # qwen2-vl stub frontend
    logit_softcap: float = 0.0
    ring_cache: bool = False
    z_loss: float = 0.0                      # weight of the loss's z term
    mlp_gated: bool = True
    vocab_pad_multiple: int = 128
    quant: QuantPolicy = QuantPolicy()
    moe_cfg: Optional[moe_lib.MoEConfig] = None
    moe_group_size: int = 4096
    ssd_cfg: Optional[ssd_lib.SSDConfig] = None

    def __post_init__(self):
        for spec in tuple(self.pattern) + tuple(self.tail):
            if spec.kind not in ("attn", "ssd"):
                raise ValueError(f"{spec}: block kinds are attn and ssd")
            if spec.kind == "ssd" and self.ssd_cfg is None:
                raise ValueError(f"{spec}: an SSD block needs ssd_cfg")
            if spec.shared_attn and spec.kind != "attn":
                raise ValueError(f"{spec}: a shared block is attention")
            if spec.moe and self.moe_cfg is None:
                raise ValueError(f"{spec}: an MoE block needs moe_cfg")
        if self.pos_emb not in ("rope", "mrope", "none"):
            raise ValueError(f"pos_emb={self.pos_emb!r}: rope, mrope or "
                             f"none")
        if (self.quant.weights not in QUANT_MODES
                or self.quant.kv not in QUANT_MODES):
            raise ValueError(f"{self.quant}: quant modes are {QUANT_MODES}")

    @property
    def padded_vocab(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return ((self.vocab + m - 1) // m) * m

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats + len(self.tail)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def has_ssd(self) -> bool:
        """An SSD block's state integrates every step of its input, padding
        included, so its prompts are prefilled unpadded."""
        return any(sp.kind == "ssd"
                   for sp in tuple(self.pattern) + tuple(self.tail))

    @property
    def has_moe(self) -> bool:
        """An MoE block couples the rows of a call: its capacity ranks
        every row's routes together."""
        return any(sp.moe for sp in tuple(self.pattern) + tuple(self.tail))

    @property
    def use_int8_matmul(self) -> bool:
        """int8-served projections through K4. The JAX package also asks
        for its Pallas switch; the port has none (the tensors' device picks
        the kernel or its plain version)."""
        return self.quant.weights_int8

    def attn_cfg(self, window: int = -1) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.resolved_head_dim,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            causal=True, window=window, pos_emb=self.pos_emb,
            mrope_sections=self.mrope_sections,
            int8_kernel=self.use_int8_matmul)


# -----------------------------------------------------------------------------
# Parameter init
# -----------------------------------------------------------------------------

def _init_block(cfg: LMConfig, spec: BlockSpec, lead, **kw) -> dict:
    dev = kw["device"]
    if spec.kind == "ssd":
        # an SSD block has no FFN of its own (transformer.py:165-167)
        return {"norm_ssd": layers.init_rmsnorm(cfg.d_model, lead,
                                                device=dev),
                "ssd": ssd_lib.init_ssd(cfg.ssd_cfg, lead, **kw)}
    parts = {"norm_attn": layers.init_rmsnorm(cfg.d_model, lead, device=dev),
             "attn": layers.init_attention(cfg.attn_cfg(spec.window), lead,
                                           **kw)}
    if spec.has_ffn:
        parts["norm_ffn"] = layers.init_rmsnorm(cfg.d_model, lead, device=dev)
        if spec.moe:
            parts["moe"] = moe_lib.init_moe(cfg.moe_cfg, lead, **kw)
        else:
            parts["mlp"] = layers.init_mlp(cfg.d_model, cfg.d_ff, lead,
                                           gated=cfg.mlp_gated, **kw)
    return parts


def _has_shared(cfg: LMConfig) -> bool:
    return any(s.shared_attn for s in tuple(cfg.pattern) + tuple(cfg.tail))


def init_lm(cfg: LMConfig, *, seed: int = 0, dtype=torch.bfloat16,
            device="cuda") -> Dict[str, PyTree]:
    """Random weights from ``seed`` in the JAX tree's layout (``pat{i}``
    stacked over repeats; a shared site has no group of its own, and the
    one ``shared_attn`` group of attention and a gated MLP serves them
    all). The draws are torch's, not ``jax.random``'s.
    ``device="meta"`` builds the shapes alone (a full config's parameter
    count without its memory)."""
    meta = str(device) == "meta"
    dev = torch.device("meta") if meta else device_lib.resolve(device)
    gen = torch.Generator(device="cpu" if meta else dev).manual_seed(seed)
    kw = dict(generator=gen, device=dev, dtype=dtype)
    params: Dict[str, PyTree] = {
        "embed": layers.init_embed(cfg.padded_vocab, cfg.d_model, **kw)}
    for i, spec in enumerate(cfg.pattern):
        if not spec.shared_attn:
            params[f"pat{i}"] = _init_block(cfg, spec, (cfg.repeats,), **kw)
    for i, spec in enumerate(cfg.tail):
        if not spec.shared_attn:
            params[f"tail{i}"] = _init_block(cfg, spec, (), **kw)
    if _has_shared(cfg):
        # the reference's shared MLP takes init_mlp's default gating
        # (transformer.py:197-202)
        params["shared_attn"] = {
            "norm_attn": layers.init_rmsnorm(cfg.d_model, device=dev),
            "attn": layers.init_attention(cfg.attn_cfg(-1), **kw),
            "norm_ffn": layers.init_rmsnorm(cfg.d_model, device=dev),
            "mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, gated=True, **kw)}
    params["final_norm"] = layers.init_rmsnorm(cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        params["unembed"] = layers.init_unembed(cfg.d_model,
                                                cfg.padded_vocab, **kw)
    return params


def quantize_lm(params: PyTree) -> PyTree:
    """Weight-tree int8 quantization for serving (``weights_int8``), as
    ``repro.models.transformer.quantize_lm``: linear-layer leaves
    (``SERVING_QUANT_KEYS``) become ``{"q8": int8, "s8": fp32}`` with
    per-output-channel scales; embeddings, norms and routers pass through.
    A ``pat*`` group's leading repeats dim and an ``moe`` group's leading
    expert dim each keep their own scales. ``ssd`` groups stay in full
    precision, as the reference leaves them (their projections take no
    ``wl`` seam); the ``shared_attn`` group is quantized. Stacked leaves
    are quantized one layer (and one expert) at a time (the reduction
    never crosses them, so the codes are the same), which keeps the
    transient fp32 copy small: the stacked w_in of starcoder2-7b alone is
    10.9 GB in fp32."""

    def leaf(v: torch.Tensor, out_dims: int, lead: int) -> dict:
        if lead == 0:
            return int8_lib.quantize_weight(v, out_dims=out_dims)
        first = leaf(v[0], out_dims, lead - 1)
        q8 = torch.empty(v.shape, dtype=torch.int8, device=v.device)
        s8 = torch.empty((v.shape[0],) + tuple(first["s8"].shape),
                         dtype=torch.float32, device=v.device)
        for r in range(v.shape[0]):
            part = first if r == 0 else leaf(v[r], out_dims, lead - 1)
            q8[r] = part["q8"]
            s8[r] = part["s8"]
        return {"q8": q8, "s8": s8}

    def walk(p: dict, lead: int) -> dict:
        out = {}
        for k, v in p.items():
            if isinstance(v, dict):
                out[k] = v if "q8" in v or k == "ssd" else walk(
                    v, lead + (1 if k == "moe" else 0))
            elif (k in int8_lib.SERVING_QUANT_KEYS
                  and v.dim() >= lead + 2):
                out_dims = min(int8_lib.weight_out_dims(k),
                               v.dim() - lead - 1)
                out[k] = leaf(v, out_dims, lead)
            else:
                out[k] = v
        return out

    return {k: (walk(v, 1 if k.startswith("pat") else 0)
                if isinstance(v, dict) else v)
            for k, v in params.items()}


def _index(tree, r: int):
    """Layer ``r`` of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, KVCache):
        return KVCache(k=tree.k[r], v=tree.v[r])
    if isinstance(tree, ssd_lib.SSDState):
        return ssd_lib.SSDState(*(t[r] for t in tree.tensors()))
    return tree[r]


def _layers(params, cfg: LMConfig, caches) -> Iterator[tuple]:
    """(spec, layer params, layer cache) in execution order; a shared site
    gets the ``shared_attn`` group and its own cache."""
    shared = params.get("shared_attn")
    for r in range(cfg.repeats):
        for i, spec in enumerate(cfg.pattern):
            p = shared if spec.shared_attn else _index(params[f"pat{i}"], r)
            yield spec, p, _index(caches[f"pat{i}"], r)
    for i, spec in enumerate(cfg.tail):
        p = shared if spec.shared_attn else params[f"tail{i}"]
        yield spec, p, caches[f"tail{i}"]


def _unstacked(params, cfg: LMConfig) -> Iterator[tuple]:
    """(spec, layer params) in execution order, the ``shared_attn`` group
    at shared sites. The stacked ``pat{i}`` leaves are unbound once, so the
    backward stacks each leaf's gradient in one copy instead of scattering
    every layer's into a zero-filled stack."""
    shared = params.get("shared_attn")
    per_pat = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.shared_attn:
            per_pat[i] = [shared] * cfg.repeats
            continue
        leaves, rebuild = common.flatten(params[f"pat{i}"])
        cols = [torch.unbind(t, 0) for t in leaves]
        per_pat[i] = [rebuild([c[r] for c in cols])
                      for r in range(cfg.repeats)]
    for r in range(cfg.repeats):
        for i, spec in enumerate(cfg.pattern):
            yield spec, per_pat[i][r]
    for i, spec in enumerate(cfg.tail):
        yield spec, shared if spec.shared_attn else params[f"tail{i}"]


def _apply_block(p, cfg: LMConfig, spec: BlockSpec, x: torch.Tensor,
                 positions: torch.Tensor, arange_pos: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block over the full sequence (transformer.py:254): (x, the MoE
    aux loss or None). ``arange_pos``: ``positions`` is the synthesized
    0..S-1 arange, which makes the block's attention eligible for the
    flash kernels."""
    if spec.kind == "ssd":
        h = layers.rms_norm(p["norm_ssd"], x)
        return x + ssd_lib.ssd_block(p["ssd"], cfg.ssd_cfg, h), None
    acfg = cfg.attn_cfg(spec.window)
    h = layers.rms_norm(p["norm_attn"], x)
    x = x + layers.attention(p["attn"], acfg, h, positions,
                             arange_positions=arange_pos)
    return _ffn(p, cfg, spec, x, cfg.moe_group_size)


def _vision_overwrite(cfg: LMConfig, x: torch.Tensor,
                      vision_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The stub vision frontend (transformer.py:318-320): precomputed patch
    embeddings (B, V, d_model) replace the first V token embeddings."""
    if vision_embeds is None or cfg.vision_tokens <= 0:
        return x
    x = x.clone()
    x[:, :vision_embeds.shape[1]] = vision_embeds.to(x.dtype)
    return x


def forward(params, cfg: LMConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            vision_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (transformer.py:311): tokens (B, S) ->
    (logits (B, S, padded vocab) fp32, aux loss).

    With ``positions=None`` every attention block takes the flash route
    (K6, and K7/K8 in the backward, on the card; their plain versions on
    the CPU), but for M-RoPE, which takes the masked ``sdpa`` as in the
    reference; an explicit ``positions`` tensor ((B, S), or (B, S, 3)
    under M-RoPE) takes the masked ``sdpa`` too. ``vision_embeds`` (B, V,
    d_model) overwrite the first V embeddings when the config has a
    vision frontend. The reference's ``remat`` has no counterpart: the
    port keeps every layer's activations for the backward. The aux loss
    is the sum of the MoE blocks' router losses (0 without MoE).
    """
    b, s = tokens.shape
    x = _vision_overwrite(cfg, layers.embed(params["embed"], tokens),
                          vision_embeds)
    arange_pos = positions is None
    if positions is None:
        positions = layers.positions_for(
            cfg.pos_emb, torch.arange(s, device=tokens.device).expand(b, s))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, p in _unstacked(params, cfg):
        x, a = _apply_block(p, cfg, spec, x, positions, arange_pos=arange_pos)
        if a is not None:
            aux = aux + a
    x = layers.rms_norm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.apply_unembed(params["unembed"], x)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits, aux


def loss_fn(params, cfg: LMConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy plus the aux loss and the optional z-loss
    (transformer.py:360). ``batch``: ``tokens`` and ``labels`` (B, S),
    optional ``positions`` and ``loss_mask``. Returns (total, {"ce",
    "aux", "tokens"}), all device scalars."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          positions=batch.get("positions"),
                          vision_embeds=batch.get("vision_embeds"))
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - label_logit) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = nll.sum() / denom
    total = ce + aux
    if cfg.z_loss > 0:
        total = total + cfg.z_loss * ((logz * mask) ** 2).sum() / denom
    return total, {"ce": ce, "aux": aux, "tokens": denom}


# -----------------------------------------------------------------------------
# Caches (decode)
# -----------------------------------------------------------------------------

def _cache_len(cfg: LMConfig, spec: BlockSpec, max_len: int) -> int:
    """Rows of a layer's dense cache (transformer.py:383-386): a windowed
    layer's ring holds its window under ``ring_cache``, else ``max_len``."""
    if cfg.ring_cache and spec.window > 0:
        return min(spec.window, max_len)
    return max_len


def init_caches(cfg: LMConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda") -> Dict[str, PyTree]:
    """Cache tree: pattern positions stacked over repeats, tail single. Each
    attention cache holds ``kv`` (B, clen, Hkv, Dh) and per-row position
    tags ``pos`` (-1 = empty), clen = ``_cache_len``: ``max_len``, or a
    windowed layer's window under ``ring_cache`` (position p at row
    p % clen). Under ``cfg.quant.kv_int8`` K/V are int8 codes (``dtype``
    is ignored for them) and the cache gains a ``kv_scale`` pair (B, clen,
    Hkv) fp32. An SSD block's entry is ``{"ssd": SSDState}``: its conv
    windows in ``dtype``, its SSM state in fp32 (transformer.py:418)."""
    dev = device_lib.resolve(device)
    kvh, dh = cfg.n_kv_heads, cfg.resolved_head_dim

    def one(spec, lead):
        if spec.kind == "ssd":
            return {"ssd": ssd_lib.init_ssd_state(cfg.ssd_cfg, batch, dtype,
                                                  dev, lead)}
        clen = _cache_len(cfg, spec, max_len)
        entry = _kv_entry(cfg, lead + (batch, clen, kvh), dh, dtype, dev)
        entry["pos"] = torch.full(lead + (batch, clen), -1,
                                  dtype=torch.int32, device=dev)
        return entry

    caches: Dict[str, PyTree] = {}
    for i, spec in enumerate(cfg.pattern):
        caches[f"pat{i}"] = one(spec, (cfg.repeats,))
    for i, spec in enumerate(cfg.tail):
        caches[f"tail{i}"] = one(spec, ())
    return caches


def _kv_entry(cfg: LMConfig, rows, dh: int, dtype, dev) -> dict:
    """``{"kv"}`` K/V of ``rows + (dh,)`` zeros, plus the ``kv_scale``
    pair of ``rows`` fp32 zeros when the KV cache is int8."""
    kv_dtype = torch.int8 if cfg.quant.kv_int8 else dtype
    shape = tuple(rows) + (dh,)
    entry = {"kv": KVCache(k=torch.zeros(shape, dtype=kv_dtype, device=dev),
                           v=torch.zeros(shape, dtype=kv_dtype, device=dev))}
    if cfg.quant.kv_int8:
        entry["kv_scale"] = KVCache(
            k=torch.zeros(tuple(rows), dtype=torch.float32, device=dev),
            v=torch.zeros(tuple(rows), dtype=torch.float32, device=dev))
    return entry


def _write_kv(cache, idx, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """K/V rows written in place at ``idx`` (an index tuple for
    ``index_put_``): cast to the storage dtype, or, in an int8 cache,
    quantized rowwise into codes and one fp32 scale per (row, head)."""
    kv = cache["kv"]
    if "kv_scale" in cache:
        sc = cache["kv_scale"]
        k_q, k_s = int8_lib.quantize_rowwise(k_new)
        v_q, v_s = int8_lib.quantize_rowwise(v_new)
        kv.k.index_put_(idx, k_q)
        kv.v.index_put_(idx, v_q)
        sc.k.index_put_(idx, k_s)
        sc.v.index_put_(idx, v_s)
    else:
        kv.k.index_put_(idx, k_new.to(kv.k.dtype))
        kv.v.index_put_(idx, v_new.to(kv.v.dtype))


def _kv_scales(cache) -> dict:
    """The kernels' ``k_scale``/``v_scale`` arguments of a cache entry."""
    sc = cache.get("kv_scale")
    return ({} if sc is None else {"k_scale": sc.k, "v_scale": sc.v})


def _decode_attn(p, cfg: LMConfig, spec: BlockSpec, x, cache, pos):
    """One-token attention against the cache (a ring under
    ``ring_cache``), written in place at row ``pos % clen``.

    ``pos`` is a scalar shared by every row, or a (B,) vector of per-slot
    positions (the serving engine's slot-major batched decode). Per-slot
    positions over a full-length cache go through K1; a ring cache, whose
    rows are not the prefix [0, pos], and a scalar position take the
    tag-masked ``sdpa``, as in the reference (transformer.py:487).
    """
    acfg = cfg.attn_cfg(spec.window)
    b = x.shape[0]
    kv, tags = cache["kv"], cache["pos"]
    clen = kv.k.shape[1]
    batched_pos = pos.dim() > 0
    positions = pos[:, None] if batched_pos else pos.expand(b, 1)
    q, k_new, v_new = layers._project_qkv(
        p["attn"], acfg, x, layers.positions_for(cfg.pos_emb, positions))
    rows = torch.arange(b, device=x.device)
    if batched_pos:
        # one scatter row per sequence, in place: the counterpart of the
        # JAX tick's donated `.at[rows, slot].set` (transformer.py:469-471)
        slot = pos % clen
        _write_kv(cache, (rows, slot), k_new[:, 0], v_new[:, 0])
        tags.index_put_((rows, slot), pos.to(torch.int32))
    else:
        slot = int(pos) % clen
        _write_kv(cache, (rows, torch.full_like(rows, slot)), k_new[:, 0],
                  v_new[:, 0])
        tags[:, slot] = int(pos)
    if batched_pos and not cfg.ring_cache:
        # valid cache rows are the contiguous prefix [0, pos]: the kernel
        # masks by length, so dead and short slots cost no work; int8
        # caches hand it codes and scales, dequantized in the kernel
        out = ops.decode_attention(
            q[:, 0], kv.k, kv.v, (pos + 1).to(torch.int32),
            scale=acfg.scale, window=spec.window,
            **_kv_scales(cache))[:, None]
    else:
        k_at, v_at = kv.k, kv.v
        if "kv_scale" in cache:
            # dequantize at use, in q's dtype, as the JAX XLA branch does
            sc = cache["kv_scale"]
            k_at = int8_lib.dequantize_rowwise(kv.k, sc.k, dtype=q.dtype)
            v_at = int8_lib.dequantize_rowwise(kv.v, sc.v, dtype=q.dtype)
        mask = layers.attention_mask(positions, tags, causal=True,
                                     window=spec.window)
        mask &= (tags >= 0)[:, None, :]
        out = layers.sdpa(q, k_at, v_at, mask, acfg.scale)
    return layers.out_proj(p["attn"], acfg, out)


def _ffn(p, cfg: LMConfig, spec: BlockSpec, x,
         group_size: Optional[int] = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN with its residual: (x, the MoE aux loss or None).
    An MoE block runs ``moe_capacity`` in groups of ``group_size`` tokens,
    or in one group of every token of the call when it is None (the decode
    and verify steps, transformer.py:540, :883). Its experts dequantize
    int8 leaves through ``layers.wl``, as the reference's do, so K4 serves
    only the dense projections."""
    if not (spec.has_ffn or spec.shared_attn):
        return x, None
    h = layers.rms_norm(p["norm_ffn"], x)
    if spec.moe:
        y, aux = moe_lib.moe_capacity(
            p["moe"], cfg.moe_cfg, h,
            group_size or h.shape[0] * h.shape[1])
        return x + y, aux
    return x + layers.mlp(p["mlp"], h, cfg.act,
                          int8_kernel=cfg.use_int8_matmul), None


def decode_step(params, cfg: LMConfig, token: torch.Tensor, pos: torch.Tensor,
                caches: Dict[str, PyTree]
                ) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """One decode step. token (B,1) -> (logits (B,1,V) fp32, caches).

    pos is a 0-dim tensor (all rows at the same position) or (B,) (per-slot
    positions). ``caches`` is updated in place and returned.
    """
    x = layers.embed(params["embed"], token)
    for spec, p, cache in _layers(params, cfg, caches):
        if spec.kind == "ssd":
            h = layers.rms_norm(p["norm_ssd"], x)
            x = x + ssd_lib.ssd_block_decode(p["ssd"], cfg.ssd_cfg, h,
                                             cache["ssd"])[0]
            continue
        h = layers.rms_norm(p["norm_attn"], x)
        x = x + _decode_attn(p, cfg, spec, h, cache, pos)
        x, _ = _ffn(p, cfg, spec, x)
    return _lm_head(params, cfg, x), caches


# -----------------------------------------------------------------------------
# Paged KV cache: block pool + page-table indirection
# -----------------------------------------------------------------------------

def paged_supported(cfg: LMConfig) -> bool:
    """The paged path is attention-only (SSM states are not position-
    addressable) and replaces ring caches (pages are not reclaimed by
    window; window masking still applies)."""
    return (not cfg.ring_cache
            and all(sp.kind == "attn"
                    for sp in tuple(cfg.pattern) + tuple(cfg.tail)))


def init_paged_caches(cfg: LMConfig, num_pages: int, page_size: int,
                      dtype=torch.bfloat16, device="cuda"
                      ) -> Dict[str, PyTree]:
    """KV block pools: ``num_pages + 1`` pages of ``page_size`` tokens per
    attention layer, in ``init_caches``' tree (pattern positions stacked
    over repeats, tail single), pool-major instead of slot-major. The extra
    page is the **sink**: writes from dead and padded lanes land there, so
    the host allocator recycles pages without any device-side scrub. One
    page table, built by the serve engine, maps every layer's logical
    blocks to the same physical pages.

    No position tags: the engine keeps slot b's valid positions exactly
    ``[0, len_b)`` through its page chain, so validity is ``pos < len``.
    Under ``cfg.quant.kv_int8`` the pools hold int8 codes plus a
    ``kv_scale`` pair of (num_pages + 1, page_size, Hkv) fp32 scale pools,
    the dense int8 cache's representation."""
    if not paged_supported(cfg):
        raise NotImplementedError(
            "paged KV caches are attention-only and incompatible with "
            "ring_cache; use init_caches")
    dev = device_lib.resolve(device)
    rows = (num_pages + 1, page_size, cfg.n_kv_heads)

    def one(lead):
        return _kv_entry(cfg, lead + rows, cfg.resolved_head_dim, dtype, dev)

    caches: Dict[str, PyTree] = {}
    for i in range(len(cfg.pattern)):
        caches[f"pat{i}"] = one((cfg.repeats,))
    for i in range(len(cfg.tail)):
        caches[f"tail{i}"] = one(())
    return caches


def move_pages(caches: Dict[str, PyTree], src: torch.Tensor,
               dst: torch.Tensor) -> Dict[str, PyTree]:
    """Copy pool page ``src[i]`` -> ``dst[i]`` in every layer's K/V pool
    (and scale pool), in place: the device half of page-table compaction.
    ``pool[src]`` is gathered into a new tensor before ``pool[dst]`` is
    written, so a
    destination that is also a source reads its old bytes. Padding entries
    may point both at the sink page (a sink->sink copy is the identity).
    The caller owns the host-side invariants: destinations are freshly
    allocated private pages, sources are released after the copy."""
    src, dst = src.long(), dst.long()
    for key, entry in caches.items():
        pools = [entry["kv"].k, entry["kv"].v]
        if "kv_scale" in entry:
            pools += [entry["kv_scale"].k, entry["kv_scale"].v]
        for pool in pools:
            if key.startswith("pat"):               # stacked layers lead
                pool[:, dst] = pool[:, src]
            else:
                pool[dst] = pool[src]
    return caches


def cow_pages(caches: Dict[str, PyTree], page_table: torch.Tensor,
              src: torch.Tensor, dst: torch.Tensor, slot_idx: torch.Tensor,
              blk_idx: torch.Tensor, entry: torch.Tensor
              ) -> Tuple[Dict[str, PyTree], torch.Tensor]:
    """Copy-on-write divergence, device half, in place: duplicate pool
    pages ``src[i] -> dst[i]`` in every layer (``move_pages``) and redirect
    the forked slots' table entries ``page_table[slot_idx[i], blk_idx[i]]
    = entry[i]``. The (M,) index vectors are padded with sink->sink copies
    (the identity) and slot ids past the table's rows, which drop, so one
    code path serves every event count. A redirect without a byte copy
    (the last co-owner adopting a page, or a block with nothing committed
    yet) passes ``src == dst == sink``. The table write goes through a
    flat copy with one spare element that the dropped rows land in, so no
    mask leaves the device."""
    move_pages(caches, src, dst)
    b, nb = page_table.shape
    slot_idx, blk_idx = slot_idx.long(), blk_idx.long()
    keep = (slot_idx >= 0) & (slot_idx < b) & (blk_idx >= 0) & (blk_idx < nb)
    flat = torch.cat([page_table.reshape(-1), page_table.new_zeros(1)])
    flat[torch.where(keep, slot_idx * nb + blk_idx, b * nb)] = entry.to(
        flat.dtype)
    page_table.copy_(flat[:-1].view(b, nb))
    return caches, page_table


def _paged_decode_attn(p, cfg: LMConfig, spec: BlockSpec, x, cache, pos,
                       page_table, active):
    """One-token attention against the paged pool, written in place. ``pos``
    is (B,) per-slot positions; ``active`` routes dead lanes' writes to the
    sink page, since their table rows may name pages recycled to other
    slots, and so does a position past the table's capacity (the oracle
    drafter's passes reach it at the max_len edge), which would otherwise
    overwrite a row of the slot's last page."""
    acfg = cfg.attn_cfg(spec.window)
    b = x.shape[0]
    kv = cache["kv"]
    ps = kv.k.shape[1]
    nb = page_table.shape[1]
    sink = kv.k.shape[0] - 1
    q, k_new, v_new = layers._project_qkv(
        p["attn"], acfg, x, layers.positions_for(cfg.pos_emb, pos[:, None]))
    rows = torch.arange(b, device=x.device)
    blk = (pos // ps).clamp(0, nb - 1)
    page = torch.where(active & (pos < nb * ps), page_table[rows, blk].long(),
                       sink)
    off = pos % ps
    _write_kv(cache, (page, off), k_new[:, 0], v_new[:, 0])
    out = ops.paged_decode_attention(
        q[:, 0], kv.k, kv.v, page_table, (pos + 1).to(torch.int32),
        scale=acfg.scale, window=spec.window, **_kv_scales(cache))[:, None]
    return layers.out_proj(p["attn"], acfg, out)


def _paged_verify_attn(p, cfg: LMConfig, spec: BlockSpec, x, cache, pos,
                       page_table, active):
    """Multi-query attention of the speculative verify pass: T tokens per
    slot at positions ``pos + t``, every lane's K/V written in place
    through the table (int8 pools get codes and scales), then each lane
    attends the slot's chain causally *through the storage dtype*, its own
    lanes included (``ops.paged_verify_attention``, K5 on the card), as
    sequential ``paged_decode_step`` ticks would see it. Inactive slots'
    lanes and positions past the table's capacity write to the sink page.
    Rejected lanes need no cleanup: the engine does not advance ``pos``
    past the accepted prefix, and the next tick overwrites them."""
    acfg = cfg.attn_cfg(spec.window)
    b, t = x.shape[:2]
    kv = cache["kv"]
    ps = kv.k.shape[1]
    nb = page_table.shape[1]
    sink = kv.k.shape[0] - 1
    pos_abs = pos[:, None] + torch.arange(t, device=x.device)[None]  # (B, T)
    q, k_new, v_new = layers._project_qkv(
        p["attn"], acfg, x, layers.positions_for(cfg.pos_emb, pos_abs))
    rows = torch.arange(b, device=x.device)[:, None].expand(b, t)
    blk = (pos_abs // ps).clamp(0, nb - 1)
    writable = active[:, None] & (pos_abs < nb * ps)
    page = torch.where(writable, page_table[rows, blk].long(), sink)
    _write_kv(cache, (page, pos_abs % ps), k_new, v_new)
    # lengths count the lanes; a lane sunk past the capacity has no key
    # of its own, and the engine never emits from it
    out = ops.paged_verify_attention(
        q, kv.k, kv.v, page_table, (pos + t).to(torch.int32),
        scale=acfg.scale, window=spec.window, **_kv_scales(cache))
    return layers.out_proj(p["attn"], acfg, out)


def _paged_walk(params, cfg: LMConfig, tokens, pos, page_table, caches,
                active, attn) -> torch.Tensor:
    """Every layer of a paged step with ``attn`` as its attention; returns
    the logits of every token, (B, T, V) fp32."""
    if active is None:
        active = torch.ones(tokens.shape[0], dtype=torch.bool,
                            device=tokens.device)
    x = layers.embed(params["embed"], tokens)
    for spec, p, cache in _layers(params, cfg, caches):
        h = layers.rms_norm(p["norm_attn"], x)
        x = x + attn(p, cfg, spec, h, cache, pos, page_table, active)
        x, _ = _ffn(p, cfg, spec, x)
    return _lm_head(params, cfg, x)


def paged_decode_step(params, cfg: LMConfig, token: torch.Tensor,
                      pos: torch.Tensor, page_table: torch.Tensor,
                      caches: Dict[str, PyTree],
                      active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """One decode step against the paged pools. token (B,1), pos (B,)
    per-slot positions, page_table (B, NB) int32 -> (logits (B,1,V) fp32,
    caches), the pools updated in place.

    ``active`` (B,) bool: lanes that are really decoding. Inactive lanes
    still run through the batch, but their K/V writes go to the sink page.
    """
    return _paged_walk(params, cfg, token, pos, page_table, caches, active,
                       _paged_decode_attn), caches


def paged_verify_step(params, cfg: LMConfig, tokens: torch.Tensor,
                      pos: torch.Tensor, page_table: torch.Tensor,
                      caches: Dict[str, PyTree],
                      active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """Speculative verification step: score T tokens per slot in ONE
    forward pass against the paged pools, updated in place.

    tokens (B, T) — per slot, the pending token followed by T - 1 drafts;
    pos (B,) — cache length before the step (token t lands at ``pos + t``);
    page_table (B, NB) int32; ``active`` as in ``paged_decode_step``.
    Returns (logits (B, T, V) fp32, caches): row t is the distribution of
    the token after ``tokens[:, :t + 1]``, so draft t is checked against
    row t - 1 and row T - 1 gives the bonus token. Attention reads every
    key through the storage dtype, so lane t's logits are what a plain
    ``paged_decode_step`` at ``pos + t`` would give.
    """
    return _paged_walk(params, cfg, tokens, pos, page_table, caches, active,
                       _paged_verify_attn), caches


def paged_extend(params, cfg: LMConfig, tokens: torch.Tensor,
                 starts: torch.Tensor, lens: torch.Tensor,
                 page_table: torch.Tensor, caches: Dict[str, PyTree]
                 ) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """Extend-prefill: run a chunk of prompt tokens against pre-populated
    paged caches. The one primitive behind suffix-after-prefix-hit
    admission and chunked prefill.

    tokens: (B, C) right-padded chunk per row; starts: (B,) absolute
    position of each row's first chunk token; lens: (B,) valid tokens per
    row (0 = dead row: its writes go to the sink page); page_table: (B, NB)
    int32, ROW-major (row j's pages, not slot j's). Each layer writes the
    chunk's K/V into the rows' pages in place, then each chunk query
    attends the cached window [0, start) read from the pool plus the chunk
    itself in full precision (``ops.paged_prefill_attention``, K3 on the
    card): dense-prefill numerics for the chunk, decode numerics for the
    cached part.

    Returns per-row logits at the chunk's last valid token, (B, 1, V) fp32
    — meaningful only for rows whose prompt ends in this chunk.
    """
    b, c = tokens.shape
    nb = page_table.shape[1]
    dev = tokens.device
    x = layers.embed(params["embed"], tokens)
    rel = torch.arange(c, device=dev)[None]                       # (1, C)
    valid = rel < lens[:, None]                                   # (B, C)
    pos_abs = starts.long()[:, None] + rel                        # (B, C)
    positions = layers.positions_for(cfg.pos_emb, pos_abs)
    rows = torch.arange(b, device=dev)[:, None].expand(b, c)
    starts32, lens32 = starts.to(torch.int32), lens.to(torch.int32)
    for spec, p, cache in _layers(params, cfg, caches):
        acfg = cfg.attn_cfg(spec.window)
        kv = cache["kv"]
        ps = kv.k.shape[1]
        sink = kv.k.shape[0] - 1
        h = layers.rms_norm(p["norm_attn"], x)
        q, k_new, v_new = layers._project_qkv(p["attn"], acfg, h, positions)
        # scatter the chunk's K/V into the rows' pages (invalid lanes ->
        # sink); rope-rotated K is what lands in the pool, as in prefill
        blk = (pos_abs // ps).clamp(0, nb - 1)
        page = torch.where(valid, page_table[rows, blk].long(), sink)
        off = pos_abs % ps
        _write_kv(cache, (page, off), k_new, v_new)
        out = ops.paged_prefill_attention(
            q, k_new.to(q.dtype), v_new.to(q.dtype), kv.k, kv.v, page_table,
            starts32, lens32, scale=acfg.scale, window=spec.window,
            **_kv_scales(cache))
        x = x + layers.out_proj(p["attn"], acfg, out)
        x, _ = _ffn(p, cfg, spec, x, cfg.moe_group_size)
    # per-row last valid chunk token (rows are right-padded to C)
    idx = (lens.long() - 1).clamp(0, c - 1)
    x_last = x[torch.arange(b, device=dev), idx][:, None]
    return _lm_head(params, cfg, x_last), caches


def _lm_head(params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """final norm -> (un)tied unembed -> softcap -> true-vocab slice."""
    x = layers.rms_norm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.apply_unembed(params["unembed"], x)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits[..., :cfg.vocab]


# -----------------------------------------------------------------------------
# Prefill: forward + cache construction
# -----------------------------------------------------------------------------

def prefill(params, cfg: LMConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None,
            vision_embeds: Optional[torch.Tensor] = None,
            cache_dtype=torch.bfloat16,
            lengths: Optional[torch.Tensor] = None):
    """Process a prompt batch, returning (last-token logits (B,1,V), caches).

    ``lengths`` (B,) enables padded multi-prompt prefill: rows are
    right-padded to a shared length S, logits are taken at ``lengths - 1``
    per row, and cache position tags past each row's length are -1. Full
    attention here is plain PyTorch (``layers.sdpa``), as it is XLA in JAX.
    A cache shorter than the prompt (a ring, or ``max_len`` < S) keeps the
    last clen positions, position p at row p % clen (the reference's ring
    branch). ``vision_embeds`` as in ``forward``.

    An SSD block runs the chunked scan and stores, per row, the last
    d_conv - 1 *pre-activation* conv inputs and the final SSM state
    (transformer.py:1284-1305). Its state would integrate the padding, so
    ``lengths`` raises ``NotImplementedError`` for an SSD arch, as in the
    reference, and so does a prompt shorter than d_conv - 1 tokens, whose
    conv windows the reference leaves short (it fails later, at the
    engine's scatter or the next decode step).
    """
    b, s = tokens.shape
    max_len = max_len or s
    dev = tokens.device
    if cfg.has_ssd:
        if lengths is not None:
            raise NotImplementedError(
                "padded prefill is attention-only; group equal-length "
                "prompts for SSD archs")
        if s < cfg.ssd_cfg.d_conv - 1:
            raise ValueError(f"a prompt of {s} tokens is shorter than the "
                             f"SSD conv window's {cfg.ssd_cfg.d_conv - 1}")
    caches = init_caches(cfg, b, max_len, cache_dtype, device=dev)
    x = _vision_overwrite(cfg, layers.embed(params["embed"], tokens),
                          vision_embeds)
    pos1d = torch.arange(s, device=dev).expand(b, s)
    positions = layers.positions_for(cfg.pos_emb, pos1d)
    rows = torch.arange(b, device=dev)[:, None]
    for spec, p, cache in _layers(params, cfg, caches):
        if spec.kind == "ssd":
            x = x + _fill_ssd(p, cfg.ssd_cfg, x, cache["ssd"])
            continue
        acfg = cfg.attn_cfg(spec.window)
        h = layers.rms_norm(p["norm_attn"], x)
        q, k, v = layers._project_qkv(p["attn"], acfg, h, positions)
        if s > layers._CHUNKED_SDPA_THRESHOLD:
            out = layers.sdpa_q_chunked(q, k, v, pos1d, pos1d, causal=True,
                                        window=spec.window, scale=acfg.scale)
        else:
            mask = layers.attention_mask(pos1d, pos1d, causal=True,
                                         window=spec.window)
            out = layers.sdpa(q, k, v, mask, acfg.scale)
        x = x + layers.out_proj(p["attn"], acfg, out)
        # prompt K/V enter the cache in its storage form (int8 caches get
        # codes and scales, the representation decode appends); attention
        # above used the full-precision K/V. The cache keeps positions
        # [s0, s), each at row pos % clen
        clen = cache["pos"].shape[-1]
        s0 = max(0, s - clen)
        kept = torch.arange(s0, s, device=dev)
        slots = kept % clen
        _write_kv(cache, (rows, slots[None]), k[:, s0:], v[:, s0:])
        tags = kept.to(torch.int32).expand(b, s - s0)
        if lengths is not None:
            tags = torch.where(tags < lengths[:, None], tags, -1)
        cache["pos"][:, slots] = tags.to(torch.int32)
        x, _ = _ffn(p, cfg, spec, x, cfg.moe_group_size)
    if lengths is not None:
        x_last = x[torch.arange(b, device=x.device), lengths.long() - 1][:, None]
    else:
        x_last = x[:, -1:]
    return _lm_head(params, cfg, x_last), caches


def _fill_ssd(p, scfg: ssd_lib.SSDConfig, x: torch.Tensor,
              state: ssd_lib.SSDState) -> torch.Tensor:
    """An SSD block's prefill: its output, with ``state`` written in place
    (the conv windows from the last d_conv - 1 pre-activation inputs, cast
    to the cache dtype, and the final SSM state)."""
    h = layers.rms_norm(p["norm_ssd"], x)
    z, xin, b_raw, c_raw, dt_raw = ssd_lib._projections(p["ssd"], scfg, h)
    w = scfg.d_conv - 1
    state.conv_x.copy_(xin[:, -w:])
    state.conv_b.copy_(b_raw[:, -w:])
    state.conv_c.copy_(c_raw[:, -w:])
    y, final = ssd_lib.ssd_scan(p["ssd"], scfg, z, xin, b_raw, c_raw, dt_raw)
    state.ssm.copy_(final)
    return y
