"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936
— qk_norm, GQA  [hf:Qwen/Qwen3-8B family]."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3_0p6b", arch_type="dense", source="hf:Qwen/Qwen3-8B (0.6b member)",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, vocab=151936, act="silu", qk_norm=True,
        rope_theta=1_000_000.0, tie_embeddings=True,
        compute_dtype="bfloat16", microbatch=4,
        fl_local_steps=4,
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, compute_dtype="float32", microbatch=1)
