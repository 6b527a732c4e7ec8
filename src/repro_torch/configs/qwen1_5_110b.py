"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias. [hf:Qwen/Qwen1.5-0.5B (family); hf]

Mirror of ``repro.configs.qwen1_5_110b``: QKV bias, an untied head and a
gated SiLU MLP. The TPU knob ``remat`` of the original has no
counterpart on one card and is left out.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import BlockSpec, LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-110b",
        d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152, vocab=152064,
        head_dim=128, qkv_bias=True,
        pattern=(BlockSpec(),), repeats=80,
        act="silu", mlp_gated=True, rope_theta=1e6,
        tie_embeddings=False,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="qwen1.5-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
        qkv_bias=True, pattern=(BlockSpec(),), repeats=3,
        act="silu", tie_embeddings=False,
    )


SPEC = ArchSpec(
    arch_id="qwen1.5-110b", family="dense", kind="lm",
    make_config=make_config, make_smoke=make_smoke,
    params_nominal=110e9, long_context_ok=False,
    source="hf:Qwen/Qwen1.5 family",
    notes="largest dense arch in the pool; QKV bias exercises the bias path; "
          "pure full attention -> long_500k skipped",
)
