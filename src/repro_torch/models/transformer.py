"""Decoder-only LM of the PyTorch port, attention-only (mirror of
``repro.models.transformer``).

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
``paged_decode_step`` attends through K2 and ``paged_extend`` through K3.
SSD, MoE, shared attention, M-RoPE, ring caches and the int8 modes are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.layers import AttnConfig, KVCache

PyTree = Any


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str = "attn"          # "attn" | "ssd"
    window: int = -1            # sliding window (attn); <0 = global
    moe: bool = False           # MoE FFN instead of dense FFN
    shared_attn: bool = False   # zamba2: use the single shared attention block
    has_ffn: bool = True        # pure mamba blocks have no separate FFN


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Serving-time quantization policy (``weights``/``kv``: "none" |
    "int8"). Only "none" is ported so far."""
    weights: str = "none"
    kv: str = "none"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The fields of ``repro.models.transformer.LMConfig`` that describe the
    model; the TPU-only knobs (sharding, remat, the Pallas switches) have no
    counterpart here (``bridge.config_from_dict`` drops them)."""
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
    pos_emb: str = "rope"                    # "rope" | "none"
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    ring_cache: bool = False
    mlp_gated: bool = True
    vocab_pad_multiple: int = 128
    quant: QuantPolicy = QuantPolicy()

    def __post_init__(self):
        for spec in tuple(self.pattern) + tuple(self.tail):
            if spec.kind != "attn" or spec.moe or spec.shared_attn:
                raise NotImplementedError(
                    f"{spec}: SSD, MoE and shared-attention blocks are not "
                    f"ported yet")
        if self.pos_emb not in ("rope", "none"):
            raise NotImplementedError(f"pos_emb={self.pos_emb!r} is not "
                                      f"ported yet")
        if self.ring_cache:
            raise NotImplementedError("ring caches are not ported yet")
        if self.quant != QuantPolicy():
            raise NotImplementedError(f"{self.quant}: the int8 modes are not "
                                      f"ported yet")

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

    def attn_cfg(self, window: int = -1) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.resolved_head_dim,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            causal=True, window=window, pos_emb=self.pos_emb)


# -----------------------------------------------------------------------------
# Parameter init
# -----------------------------------------------------------------------------

def _init_block(cfg: LMConfig, spec: BlockSpec, lead, **kw) -> dict:
    dev = kw["device"]
    parts = {"norm_attn": layers.init_rmsnorm(cfg.d_model, lead, device=dev),
             "attn": layers.init_attention(cfg.attn_cfg(spec.window), lead,
                                           **kw)}
    if spec.has_ffn:
        parts["norm_ffn"] = layers.init_rmsnorm(cfg.d_model, lead, device=dev)
        parts["mlp"] = layers.init_mlp(cfg.d_model, cfg.d_ff, lead,
                                       gated=cfg.mlp_gated, **kw)
    return parts


def init_lm(cfg: LMConfig, *, seed: int = 0, dtype=torch.bfloat16,
            device="cuda") -> Dict[str, PyTree]:
    """Random weights from ``seed`` in the JAX tree's layout (``pat{i}``
    stacked over repeats). The draws are torch's, not ``jax.random``'s."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=gen, device=dev, dtype=dtype)
    params: Dict[str, PyTree] = {
        "embed": layers.init_embed(cfg.padded_vocab, cfg.d_model, **kw)}
    for i, spec in enumerate(cfg.pattern):
        params[f"pat{i}"] = _init_block(cfg, spec, (cfg.repeats,), **kw)
    for i, spec in enumerate(cfg.tail):
        params[f"tail{i}"] = _init_block(cfg, spec, (), **kw)
    params["final_norm"] = layers.init_rmsnorm(cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        params["unembed"] = layers.init_unembed(cfg.d_model,
                                                cfg.padded_vocab, **kw)
    return params


def _index(tree, r: int):
    """Layer ``r`` of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, KVCache):
        return KVCache(k=tree.k[r], v=tree.v[r])
    return tree[r]


def _layers(params, cfg: LMConfig, caches) -> Iterator[tuple]:
    """(spec, layer params, layer cache) in execution order."""
    for r in range(cfg.repeats):
        for i, spec in enumerate(cfg.pattern):
            yield (spec, _index(params[f"pat{i}"], r),
                   _index(caches[f"pat{i}"], r))
    for i, spec in enumerate(cfg.tail):
        yield spec, params[f"tail{i}"], caches[f"tail{i}"]


# -----------------------------------------------------------------------------
# Caches (decode)
# -----------------------------------------------------------------------------

def init_caches(cfg: LMConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda") -> Dict[str, PyTree]:
    """Cache tree: pattern positions stacked over repeats, tail single. Each
    attention cache holds ``kv`` (B, max_len, Hkv, Dh) and per-row position
    tags ``pos`` (-1 = empty)."""
    dev = device_lib.resolve(device)
    kvh, dh = cfg.n_kv_heads, cfg.resolved_head_dim

    def one(lead):
        shape = lead + (batch, max_len, kvh, dh)
        return {"kv": KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                              v=torch.zeros(shape, dtype=dtype, device=dev)),
                "pos": torch.full(lead + (batch, max_len), -1,
                                  dtype=torch.int32, device=dev)}

    caches: Dict[str, PyTree] = {}
    for i in range(len(cfg.pattern)):
        caches[f"pat{i}"] = one((cfg.repeats,))
    for i in range(len(cfg.tail)):
        caches[f"tail{i}"] = one(())
    return caches


def _out_proj(p, out: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", out, wo)."""
    wo = p["attn"]["wo"]
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.to(out.dtype).reshape(h * k, d)


def _decode_attn(p, cfg: LMConfig, spec: BlockSpec, x, cache, pos):
    """One-token attention against the cache, written in place.

    ``pos`` is a scalar shared by every row, or a (B,) vector of per-slot
    positions (the serving engine's slot-major batched decode).
    """
    acfg = cfg.attn_cfg(spec.window)
    b = x.shape[0]
    kv, tags = cache["kv"], cache["pos"]
    clen = kv.k.shape[1]
    batched_pos = pos.dim() > 0
    positions = pos[:, None] if batched_pos else pos.expand(b, 1)
    q, k_new, v_new = layers._project_qkv(p["attn"], acfg, x, positions)
    if batched_pos:
        # one scatter row per sequence, in place: the counterpart of the
        # JAX tick's donated `.at[rows, slot].set` (transformer.py:469-471)
        rows = torch.arange(b, device=x.device)
        slot = pos % clen
        kv.k.index_put_((rows, slot), k_new[:, 0].to(kv.k.dtype))
        kv.v.index_put_((rows, slot), v_new[:, 0].to(kv.v.dtype))
        tags.index_put_((rows, slot), pos.to(torch.int32))
        # valid cache rows are the contiguous prefix [0, pos]: the kernel
        # masks by length, so dead and short slots cost no work
        out = ops.decode_attention(
            q[:, 0], kv.k, kv.v, (pos + 1).to(torch.int32),
            scale=acfg.scale, window=spec.window)[:, None]
    else:
        slot = int(pos) % clen
        kv.k[:, slot] = k_new[:, 0].to(kv.k.dtype)
        kv.v[:, slot] = v_new[:, 0].to(kv.v.dtype)
        tags[:, slot] = int(pos)
        mask = layers.attention_mask(positions, tags, causal=True,
                                     window=spec.window)
        mask &= (tags >= 0)[:, None, :]
        out = layers.sdpa(q, kv.k, kv.v, mask, acfg.scale)
    return _out_proj(p, out)


def _ffn(p, cfg: LMConfig, spec: BlockSpec, x):
    if not spec.has_ffn:
        return x
    h = layers.rms_norm(p["norm_ffn"], x)
    return x + layers.mlp(p["mlp"], h, cfg.act)


def decode_step(params, cfg: LMConfig, token: torch.Tensor, pos: torch.Tensor,
                caches: Dict[str, PyTree]
                ) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
    """One decode step. token (B,1) -> (logits (B,1,V) fp32, caches).

    pos is a 0-dim tensor (all rows at the same position) or (B,) (per-slot
    positions). ``caches`` is updated in place and returned.
    """
    x = layers.embed(params["embed"], token)
    for spec, p, cache in _layers(params, cfg, caches):
        h = layers.rms_norm(p["norm_attn"], x)
        x = x + _decode_attn(p, cfg, spec, h, cache, pos)
        x = _ffn(p, cfg, spec, x)
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
    Pools are fp only (``LMConfig`` refuses the int8 modes until they are
    ported)."""
    if not paged_supported(cfg):
        raise NotImplementedError(
            "paged KV caches are attention-only and incompatible with "
            "ring_cache; use init_caches")
    dev = device_lib.resolve(device)
    shape = (num_pages + 1, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)

    def one(lead):
        return {"kv": KVCache(
            k=torch.zeros(lead + shape, dtype=dtype, device=dev),
            v=torch.zeros(lead + shape, dtype=dtype, device=dev))}

    caches: Dict[str, PyTree] = {}
    for i in range(len(cfg.pattern)):
        caches[f"pat{i}"] = one((cfg.repeats,))
    for i in range(len(cfg.tail)):
        caches[f"tail{i}"] = one(())
    return caches


def move_pages(caches: Dict[str, PyTree], src: torch.Tensor,
               dst: torch.Tensor) -> Dict[str, PyTree]:
    """Copy pool page ``src[i]`` -> ``dst[i]`` in every layer's K/V pool, in
    place: the device half of page-table compaction. ``pool[src]`` is
    gathered into a new tensor before ``pool[dst]`` is written, so a
    destination that is also a source reads its old bytes. Padding entries
    may point both at the sink page (a sink->sink copy is the identity).
    The caller owns the host-side invariants: destinations are freshly
    allocated private pages, sources are released after the copy."""
    src, dst = src.long(), dst.long()
    for key, entry in caches.items():
        for pool in (entry["kv"].k, entry["kv"].v):
            if key.startswith("pat"):               # stacked layers lead
                pool[:, dst] = pool[:, src]
            else:
                pool[dst] = pool[src]
    return caches


def _paged_decode_attn(p, cfg: LMConfig, spec: BlockSpec, x, cache, pos,
                       page_table, active):
    """One-token attention against the paged pool, written in place. ``pos``
    is (B,) per-slot positions; ``active`` routes dead lanes' writes to the
    sink page, since their table rows may name pages recycled to other
    slots."""
    acfg = cfg.attn_cfg(spec.window)
    b = x.shape[0]
    kv = cache["kv"]
    ps = kv.k.shape[1]
    nb = page_table.shape[1]
    sink = kv.k.shape[0] - 1
    q, k_new, v_new = layers._project_qkv(p["attn"], acfg, x, pos[:, None])
    rows = torch.arange(b, device=x.device)
    blk = (pos // ps).clamp(0, nb - 1)
    page = torch.where(active, page_table[rows, blk].long(), sink)
    off = pos % ps
    kv.k.index_put_((page, off), k_new[:, 0].to(kv.k.dtype))
    kv.v.index_put_((page, off), v_new[:, 0].to(kv.v.dtype))
    out = ops.paged_decode_attention(
        q[:, 0], kv.k, kv.v, page_table, (pos + 1).to(torch.int32),
        scale=acfg.scale, window=spec.window)[:, None]
    return _out_proj(p, out)


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
    if active is None:
        active = torch.ones(token.shape[0], dtype=torch.bool,
                            device=token.device)
    x = layers.embed(params["embed"], token)
    for spec, p, cache in _layers(params, cfg, caches):
        h = layers.rms_norm(p["norm_attn"], x)
        x = x + _paged_decode_attn(p, cfg, spec, h, cache, pos, page_table,
                                   active)
        x = _ffn(p, cfg, spec, x)
    return _lm_head(params, cfg, x), caches


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
    rows = torch.arange(b, device=dev)[:, None].expand(b, c)
    starts32, lens32 = starts.to(torch.int32), lens.to(torch.int32)
    for spec, p, cache in _layers(params, cfg, caches):
        acfg = cfg.attn_cfg(spec.window)
        kv = cache["kv"]
        ps = kv.k.shape[1]
        sink = kv.k.shape[0] - 1
        h = layers.rms_norm(p["norm_attn"], x)
        q, k_new, v_new = layers._project_qkv(p["attn"], acfg, h, pos_abs)
        # scatter the chunk's K/V into the rows' pages (invalid lanes ->
        # sink); rope-rotated K is what lands in the pool, as in prefill
        blk = (pos_abs // ps).clamp(0, nb - 1)
        page = torch.where(valid, page_table[rows, blk].long(), sink)
        off = pos_abs % ps
        kv.k.index_put_((page, off), k_new.to(kv.k.dtype))
        kv.v.index_put_((page, off), v_new.to(kv.v.dtype))
        out = ops.paged_prefill_attention(
            q, k_new.to(q.dtype), v_new.to(q.dtype), kv.k, kv.v, page_table,
            starts32, lens32, scale=acfg.scale, window=spec.window)
        x = x + _out_proj(p, out)
        x = _ffn(p, cfg, spec, x)
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
            max_len: Optional[int] = None, cache_dtype=torch.bfloat16,
            lengths: Optional[torch.Tensor] = None):
    """Process a prompt batch, returning (last-token logits (B,1,V), caches).

    ``lengths`` (B,) enables padded multi-prompt prefill: rows are
    right-padded to a shared length S, logits are taken at ``lengths - 1``
    per row, and cache position tags past each row's length are -1. Full
    attention here is plain PyTorch (``layers.sdpa``), as it is XLA in JAX.
    """
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise NotImplementedError("a prompt longer than the cache needs the "
                                  "ring-cache branch, which is not ported yet")
    caches = init_caches(cfg, b, max_len, cache_dtype, device=tokens.device)
    x = layers.embed(params["embed"], tokens)
    pos1d = torch.arange(s, device=tokens.device).expand(b, s)
    tag_row = torch.arange(s, dtype=torch.int32, device=tokens.device)
    if lengths is not None:
        tag_row = torch.where(tag_row[None] < lengths[:, None], tag_row, -1)
    for spec, p, cache in _layers(params, cfg, caches):
        acfg = cfg.attn_cfg(spec.window)
        h = layers.rms_norm(p["norm_attn"], x)
        q, k, v = layers._project_qkv(p["attn"], acfg, h, pos1d)
        if s > layers._CHUNKED_SDPA_THRESHOLD:
            out = layers.sdpa_q_chunked(q, k, v, pos1d, pos1d, causal=True,
                                        window=spec.window, scale=acfg.scale)
        else:
            mask = layers.attention_mask(pos1d, pos1d, causal=True,
                                         window=spec.window)
            out = layers.sdpa(q, k, v, mask, acfg.scale)
        x = x + _out_proj(p, out)
        kv = cache["kv"]
        kv.k[:, :s] = k.to(kv.k.dtype)
        kv.v[:, :s] = v.to(kv.v.dtype)
        cache["pos"][:, :s] = tag_row
        x = _ffn(p, cfg, spec, x)
    if lengths is not None:
        x_last = x[torch.arange(b, device=x.device), lengths.long() - 1][:, None]
    else:
        x_last = x[:, -1:]
    return _lm_head(params, cfg, x_last), caches
