"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000
— GeGLU, head_dim=256, MQA  [arXiv:2403.08295]."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma_2b", arch_type="dense", source="arXiv:2403.08295",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab=256000, act="geglu", scale_embed=True,
        tie_embeddings=True, compute_dtype="bfloat16", microbatch=4,
        fl_local_steps=2,
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=512, vocab=512, compute_dtype="float32", microbatch=1)
