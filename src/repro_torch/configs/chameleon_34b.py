"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion, VQ image tokens  [arXiv:2405.09818].

Early fusion means images are VQ codes in the shared 65536 vocab: the
decoder sees one interleaved token stream, so the vision "frontend stub"
is simply pre-tokenized input (no VQ-GAN here; DESIGN.md §5).
E=1 + FSDP (34B replica too large for one client slice with optimizer state).
"""

from repro_torch.core.fediac import FediACConfig

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="chameleon_34b", arch_type="vlm", source="arXiv:2405.09818",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22016, vocab=65536, act="silu", qk_norm=True,
        frontend="vq_stub", tie_embeddings=False,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        grad_dtype="bfloat16", residual_dtype="bfloat16",
        fediac=FediACConfig(vote_chunk=4096, work_dtype="bfloat16",
                            granularity="tensor"),
        fsdp=True, microbatch=8, fl_local_steps=1,
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, param_dtype="float32", compute_dtype="float32",
        fsdp=False, microbatch=1)
