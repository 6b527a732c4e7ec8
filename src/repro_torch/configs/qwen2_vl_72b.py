"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Mirror of ``repro.configs.qwen2_vl_72b``. Backbone only: the vision tower
is a stub, precomputed patch embeddings (B, 1024, d_model) written over
the front of the sequence (``transformer.forward``'s ``vision_embeds``),
plus (B, S, 3) t/h/w M-RoPE position ids. The TPU knob ``remat`` of the
original has no counterpart on one card and is left out.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import BlockSpec, LMConfig

VISION_TOKENS = 1024


def make_config() -> LMConfig:
    return LMConfig(
        name="qwen2-vl-72b",
        d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064,
        head_dim=128, qkv_bias=True,
        pattern=(BlockSpec(),), repeats=80,
        pos_emb="mrope", mrope_sections=(16, 24, 24),
        vision_tokens=VISION_TOKENS,
        act="silu", rope_theta=1e6,
        tie_embeddings=False,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="qwen2vl-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
        qkv_bias=True, pattern=(BlockSpec(),), repeats=2,
        pos_emb="mrope", mrope_sections=(2, 3, 3), vision_tokens=4,
        act="silu", tie_embeddings=False,
    )


SPEC = ArchSpec(
    arch_id="qwen2-vl-72b", family="vlm", kind="lm",
    make_config=make_config, make_smoke=make_smoke,
    params_nominal=72e9, long_context_ok=False,
    source="arXiv:2409.12191; hf",
    notes="vision frontend stubbed (1024 patch embeddings); M-RoPE is real "
          "(3 position streams over disjoint frequency sections); "
          "full attention -> long_500k skipped",
)
