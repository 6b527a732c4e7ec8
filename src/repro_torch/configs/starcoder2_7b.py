"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE. [arXiv:2402.19173; hf]

Mirror of ``repro.configs.starcoder2_7b``. The TPU sharding knobs of the
original (``sp_attention``, ``sp_residual``, ``remat``) have no counterpart
on one card and are left out.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import BlockSpec, LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="starcoder2-7b",
        d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432, vocab=49152,
        head_dim=128,
        pattern=(BlockSpec(),), repeats=32,
        act="gelu", mlp_gated=False, rope_theta=1e5,
        tie_embeddings=True,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="starcoder2-smoke",
        d_model=72, n_heads=6, n_kv_heads=2, d_ff=144, vocab=128, head_dim=16,
        pattern=(BlockSpec(),), repeats=3,
        act="gelu", mlp_gated=False,
    )


SPEC = ArchSpec(
    arch_id="starcoder2-7b", family="dense", kind="lm",
    make_config=make_config, make_smoke=make_smoke,
    params_nominal=7e9, long_context_ok=False,
    source="arXiv:2402.19173; hf",
    notes="pure full attention, GQA rep 9",
)
