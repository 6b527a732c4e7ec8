"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]

Mirror of ``repro.configs.kimi_k2_1t_a32b``: ~1.03T total, ~30B active
parameters. The real model uses MLA; the assigned spec says GQA kv=8, which
is what both packages implement. Head dim 112 runs the SIMT kernels of the
serve path's attention. One card holds one layer at full width (18.2 G
parameters, 36.4 GB in bf16): ``--repeats`` cuts the depth.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import BlockSpec, LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="kimi-k2-1t-a32b",
        d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840,
        head_dim=112,
        pattern=(BlockSpec(moe=True),), repeats=61,
        moe_cfg=MoEConfig(d_model=7168, d_ff=2048, n_experts=384, top_k=8,
                          capacity_factor=1.25),
        act="silu", rope_theta=50000.0,
        tie_embeddings=True, moe_group_size=4096,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="kimi-smoke",
        d_model=64, n_heads=8, n_kv_heads=2, d_ff=48, vocab=128, head_dim=8,
        pattern=(BlockSpec(moe=True),), repeats=2,
        moe_cfg=MoEConfig(d_model=64, d_ff=48, n_experts=12, top_k=3,
                          capacity_factor=2.0),
        act="silu", moe_group_size=64,
    )


SPEC = ArchSpec(
    arch_id="kimi-k2-1t-a32b", family="moe", kind="lm",
    make_config=make_config, make_smoke=make_smoke,
    params_nominal=1e12, long_context_ok=False,
    active_fraction=8.0 / 384.0,
    source="arXiv:2501.kimi2 (paper-table); unverified",
    notes="384 experts = 24/rank on 16-way model axis; kv=8 < 16 -> KV "
          "replicated; full attention -> long_500k skipped",
)
