"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality)  [arXiv:2405.21060].

d_inner = 2*d_model = 1536, head_dim 64 -> 24 SSM heads, 1 B/C group.
long_500k decode is native: O(1) recurrent state per layer.
"""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2_130m", arch_type="ssm", source="arXiv:2405.21060",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab=50280, attn_kind="none", block_kind="ssm",
        ssm_state=128, ssm_heads=24, ssm_head_dim=64, ssm_groups=1,
        ssm_chunk=128, tie_embeddings=True, microbatch=8,
        fl_local_steps=5,
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=128, ssm_state=16, ssm_heads=4, ssm_head_dim=32,
        ssm_groups=1, ssm_chunk=8, vocab=512, microbatch=1)
