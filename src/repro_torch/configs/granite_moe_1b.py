"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8  [hf:ibm-granite/granite-3.0-1b-a400m-base]."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite_moe_1b", arch_type="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab=49155, act="silu",
        n_experts=32, moe_top_k=8, d_ff_expert=512,
        tie_embeddings=True, compute_dtype="bfloat16", microbatch=8,
        fl_local_steps=4,
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab=512, n_experts=4, moe_top_k=2, d_ff_expert=128,
        compute_dtype="float32", microbatch=1)
