"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576
vocab=49152 — llama-arch code model. [arXiv:2405.04324; hf]

Mirror of ``repro.configs.granite_34b``: MQA, so one KV head serves a GQA
group of 48. The TPU knob ``remat`` of the original has no counterpart on
one card and is left out.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import BlockSpec, LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="granite-34b",
        d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152,
        head_dim=128,
        pattern=(BlockSpec(),), repeats=88,
        act="gelu", mlp_gated=False, rope_theta=10000.0,
        tie_embeddings=True,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="granite-smoke",
        d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=128, head_dim=16,
        pattern=(BlockSpec(),), repeats=3,
        act="gelu", mlp_gated=False,
    )


SPEC = ArchSpec(
    arch_id="granite-34b", family="dense", kind="lm",
    make_config=make_config, make_smoke=make_smoke,
    params_nominal=34e9, long_context_ok=False,
    source="arXiv:2405.04324; hf",
    notes="MQA (kv=1): KV replicates across TP ranks; deepest dense stack "
          "(88L); pure full attention -> long_500k skipped",
)
