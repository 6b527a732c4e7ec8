"""Encoder-decoder transformer of the PyTorch port (mirror of
``repro.models.encdec``; Whisper-large-v3's backbone).

The audio conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, n_audio_ctx, d_model), adds sinusoidal
positions and runs bidirectional attention (the masked ``sdpa``); the
decoder runs causal self-attention, cross-attention over the encoder's
output and learned positions. Decode keeps a self-attention KV cache and
the cross-attention K/V built once from the encoder's output (the "cross
cache").

The teacher-forced decoder's self-attention takes the flash route
(``positions=None``: K6 forward, K7/K8 backward on the card), as every
LM's does; an explicit ``positions`` tensor takes the masked ``sdpa``. The
reference's ``jax.checkpoint`` around each layer has no counterpart: the
port keeps every layer's activations for the backward. ``decode_step``
writes the self cache in place (the JAX scan returns new caches) and
refuses a position past the cache, which ``dynamic_update_slice`` would
clamp into the last row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.models import common, layers
from repro_torch.models.layers import AttnConfig, KVCache

# learned decoder positions, sized for the reference's shape grid
# (encdec.py:89)
MAX_DEC_POS = 32768


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_audio_ctx: int = 1500
    act: str = "gelu"
    # the reference's context-parallel switch for 20 heads on a 16-way
    # mesh axis; kept so a config crosses over whole, read by nothing (one
    # card has no mesh), as ``flash_vjp`` has no counterpart either
    sp_attention: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab + 127) // 128) * 128

    def attn_cfg(self, causal: bool) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv_heads=self.n_heads, head_dim=self.head_dim,
                          qkv_bias=True, causal=causal, pos_emb="none")

    @property
    def n_layers(self) -> int:
        return self.n_enc_layers + self.n_dec_layers


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position embedding (length, channels), fp32:
    sin of position x timescale in the first half, cos in the second, each
    step in fp32 as the reference takes it."""
    log_timescale = torch.log(torch.tensor(10000.0, device=device)) \
        / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32,
                          device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# -----------------------------------------------------------------------------
# Parameters
# -----------------------------------------------------------------------------

def _init_enc_block(cfg: EncDecConfig, lead, **kw) -> dict:
    dev = kw["device"]
    return {"norm_attn": layers.init_layernorm(cfg.d_model, lead, device=dev),
            "attn": layers.init_attention(cfg.attn_cfg(causal=False), lead,
                                          **kw),
            "norm_ffn": layers.init_layernorm(cfg.d_model, lead, device=dev),
            "mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, lead, gated=False,
                                   **kw)}


def _init_dec_block(cfg: EncDecConfig, lead, **kw) -> dict:
    dev = kw["device"]
    return {"norm_self": layers.init_layernorm(cfg.d_model, lead, device=dev),
            "self_attn": layers.init_attention(cfg.attn_cfg(causal=True),
                                               lead, **kw),
            "norm_cross": layers.init_layernorm(cfg.d_model, lead,
                                                device=dev),
            "cross_attn": layers.init_attention(cfg.attn_cfg(causal=False),
                                                lead, **kw),
            "norm_ffn": layers.init_layernorm(cfg.d_model, lead, device=dev),
            "mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, lead, gated=False,
                                   **kw)}


def init_encdec(cfg: EncDecConfig, *, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> Dict[str, dict]:
    """Random weights from ``seed`` with the reference's distributions and
    shapes (encdec.py:87-103): the tied embedding over ``padded_vocab``,
    ``pos_dec`` truncated normal of 0.01 over ``MAX_DEC_POS`` rows, the
    ``enc`` and ``dec`` blocks stacked on a leading layer axis (as
    ``vmap_init`` stacks them), the layer norms fp32. The draws are
    torch's, not ``jax.random``'s. ``device="meta"`` builds the shapes
    alone (a full config's parameter count without its memory)."""
    meta = str(device) == "meta"
    dev = torch.device("meta") if meta else device_lib.resolve(device)
    gen = torch.Generator(device="cpu" if meta else dev).manual_seed(seed)
    kw = dict(generator=gen, device=dev, dtype=dtype)
    return {
        "embed": layers.init_embed(cfg.padded_vocab, cfg.d_model, **kw),
        "pos_dec": common.trunc_normal((MAX_DEC_POS, cfg.d_model), 0.01,
                                       **kw),
        "enc": _init_enc_block(cfg, (cfg.n_enc_layers,), **kw),
        "dec": _init_dec_block(cfg, (cfg.n_dec_layers,), **kw),
        "norm_enc": layers.init_layernorm(cfg.d_model, device=dev),
        "norm_dec": layers.init_layernorm(cfg.d_model, device=dev),
    }


def _mlp(p, cfg: EncDecConfig, x: torch.Tensor) -> torch.Tensor:
    """A block's MLP; its GELU is ``layers.gelu``, XLA's op order, so a
    bf16 block gives the reference's bits."""
    if cfg.act != "gelu":
        return layers.mlp(p, x, cfg.act)
    h = layers.gelu(x @ layers.wl(p["w_in"], x.dtype))
    return h @ layers.wl(p["w_out"], x.dtype)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# -----------------------------------------------------------------------------
# Encoder and teacher-forced decoder
# -----------------------------------------------------------------------------

def encode(params, cfg: EncDecConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, n_audio_ctx, d_model), the stub frontend's embeddings ->
    the encoder's output, in the frames' dtype. Bidirectional attention
    through the masked ``sdpa``."""
    b, s, _ = frames.shape
    x = frames + sinusoids(s, cfg.d_model, frames.device).to(
        frames.dtype)[None]
    acfg = cfg.attn_cfg(causal=False)
    positions = torch.arange(s, device=frames.device).expand(b, s)
    for i in range(cfg.n_enc_layers):
        p = _layer(params["enc"], i)
        h = layers.layer_norm(p["norm_attn"], x)
        x = x + layers.attention(p["attn"], acfg, h, positions)
        h = layers.layer_norm(p["norm_ffn"], x)
        x = x + _mlp(p["mlp"], cfg, h)
    return layers.layer_norm(params["norm_enc"], x)


def decode_train(params, cfg: EncDecConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, S) -> logits (B, S, padded
    vocab) fp32. With ``positions=None`` the causal self-attention takes
    the flash route (K6, and K7/K8 under autograd, on the card); explicit
    (B, S) arange positions take the masked ``sdpa``."""
    b, s = tokens.shape
    x = layers.embed(params["embed"], tokens)
    x = x + params["pos_dec"][:s].to(x.dtype)[None]
    self_cfg, cross_cfg = cfg.attn_cfg(True), cfg.attn_cfg(False)
    for i in range(cfg.n_dec_layers):
        p = _layer(params["dec"], i)
        h = layers.layer_norm(p["norm_self"], x)
        x = x + layers.attention(p["self_attn"], self_cfg, h, positions)
        h = layers.layer_norm(p["norm_cross"], x)
        x = x + layers.cross_attention(p["cross_attn"], cross_cfg, h,
                                       enc_out)
        h = layers.layer_norm(p["norm_ffn"], x)
        x = x + _mlp(p["mlp"], cfg, h)
    x = layers.layer_norm(params["norm_dec"], x)
    return layers.unembed(params["embed"], x)


def loss_fn(params, cfg: EncDecConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy of the teacher-forced decoder on ``frames`` (B,
    n_audio_ctx, d_model), ``tokens`` and ``labels`` (B, S), and optional
    ``positions`` (B, S) for the decoder (encdec.py:153-162). The
    logsumexp runs over the padded vocab, as the reference's does.
    Returns (ce, {"ce", "tokens"}), device scalars."""
    enc_out = encode(params, cfg, batch["frames"])
    logits = decode_train(params, cfg, batch["tokens"], enc_out,
                          positions=batch.get("positions"))
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = torch.mean(logz - ll)
    return ce, {"ce": ce, "tokens": torch.tensor(
        float(labels.numel()), dtype=torch.float32, device=ce.device)}


def encdec_axes(cfg: EncDecConfig) -> Dict[str, dict]:
    """The logical axes of ``init_encdec``'s tree, leaf for leaf: the
    reference's ``init_encdec(...).axes`` (encdec.py:87). Builds no
    tensor."""
    st = ("stack",)
    return {
        "embed": layers.embed_axes(),
        "pos_dec": ("seq", "embed"),
        "enc": {"norm_attn": layers.layernorm_axes(st),
                "attn": layers.attention_axes(cfg.attn_cfg(False), st),
                "norm_ffn": layers.layernorm_axes(st),
                "mlp": layers.mlp_axes(st, gated=False)},
        "dec": {"norm_self": layers.layernorm_axes(st),
                "self_attn": layers.attention_axes(cfg.attn_cfg(True), st),
                "norm_cross": layers.layernorm_axes(st),
                "cross_attn": layers.attention_axes(cfg.attn_cfg(False), st),
                "norm_ffn": layers.layernorm_axes(st),
                "mlp": layers.mlp_axes(st, gated=False)},
        "norm_enc": layers.layernorm_axes(),
        "norm_dec": layers.layernorm_axes(),
    }


def dec_caches_axes() -> Dict[str, dict]:
    """The logical axes of ``init_dec_caches``'s tree (the reference's
    ``_ENC_CACHE_AXES``, cells.py:297-303)."""
    kv = ("stack", "batch", "seq", "heads", "head_dim")
    return {"self": {"k": kv, "v": kv}, "cross": {"k": kv, "v": kv}}


# -----------------------------------------------------------------------------
# Serving
# -----------------------------------------------------------------------------

def init_dec_caches(cfg: EncDecConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16, device="cuda") -> Dict[str, KVCache]:
    """Zero caches: ``self`` (L, B, max_len, H, Dh) and ``cross`` (L, B,
    n_audio_ctx, H, Dh)."""
    dev = (torch.device("meta") if str(device) == "meta"
           else device_lib.resolve(device))

    def kv(slen):
        shape = (cfg.n_dec_layers, batch, slen, cfg.n_heads, cfg.head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev))

    return {"self": kv(max_len), "cross": kv(cfg.n_audio_ctx)}


def build_cross_cache(params, cfg: EncDecConfig,
                      enc_out: torch.Tensor) -> KVCache:
    """Every decoder layer's cross-attention K and V of the encoder's
    output, (L, B, S, H, Dh) in ``enc_out``'s dtype, biases added."""
    ks, vs = [], []
    for i in range(cfg.n_dec_layers):
        p = _layer(params["dec"], i)["cross_attn"]
        k = layers._project(enc_out, p["wk"])
        v = layers._project(enc_out, p["wv"])
        ks.append(k + p["bk"].to(k.dtype))
        vs.append(v + p["bv"].to(v.dtype))
    return KVCache(k=torch.stack(ks), v=torch.stack(vs))


def decode_step(params, cfg: EncDecConfig, token: torch.Tensor, pos,
                caches: Dict[str, KVCache]
                ) -> Tuple[torch.Tensor, Dict[str, KVCache]]:
    """One decoder token for the batch: token (B, 1), ``pos`` a scalar
    position shared by the batch (an int or a 0-d tensor). Writes each
    layer's K and V into ``caches["self"]`` at ``pos`` in place and
    attends over rows [0, pos]; the cross attention reads
    ``caches["cross"]``. Returns (logits (B, 1, vocab) fp32, caches).
    Raises ValueError for a ``pos`` outside the self cache, where the
    reference's ``dynamic_update_slice`` clamps the write into the last
    row and attends at the clamped position (ROADMAP queue 3)."""
    pos = int(pos)
    kself, vself = caches["self"].k, caches["self"].v
    max_len = kself.shape[2]
    if not 0 <= pos < max_len:
        raise ValueError(f"decode_step: pos {pos} outside the self cache "
                         f"of {max_len} rows")
    b = token.shape[0]
    x = layers.embed(params["embed"], token)
    x = x + params["pos_dec"][pos].to(x.dtype)
    self_cfg, cross_cfg = cfg.attn_cfg(True), cfg.attn_cfg(False)
    positions = torch.full((b, 1), pos, device=x.device)
    mask = (torch.arange(max_len, device=x.device) <= pos)[None, None, :]
    kcross, vcross = caches["cross"].k, caches["cross"].v
    mask_c = torch.ones((b, 1, kcross.shape[2]), dtype=torch.bool,
                        device=x.device)
    for i in range(cfg.n_dec_layers):
        p = _layer(params["dec"], i)
        h = layers.layer_norm(p["norm_self"], x)
        q, k_new, v_new = layers._project_qkv(p["self_attn"], self_cfg, h,
                                              positions)
        kself[i, :, pos] = k_new[:, 0].to(kself.dtype)
        vself[i, :, pos] = v_new[:, 0].to(vself.dtype)
        out = layers.sdpa(q, kself[i], vself[i], mask, self_cfg.scale)
        x = x + layers.out_proj(p["self_attn"], self_cfg, out)
        h = layers.layer_norm(p["norm_cross"], x)
        pc = p["cross_attn"]
        qc = layers._project(h, pc["wq"])
        qc = qc + pc["bq"].to(qc.dtype)
        out_c = layers.sdpa(qc, kcross[i], vcross[i], mask_c, cross_cfg.scale)
        x = x + layers.out_proj(pc, cross_cfg, out_c)
        h = layers.layer_norm(p["norm_ffn"], x)
        x = x + _mlp(p["mlp"], cfg, h)
    x = layers.layer_norm(params["norm_dec"], x)
    logits = layers.unembed(params["embed"], x)
    return logits[..., :cfg.vocab], caches
