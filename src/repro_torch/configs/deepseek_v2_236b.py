"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff_expert=1536
vocab=102400, MLA kv_lora=512, 2 shared + 160 routed experts top-6
[arXiv:2405.04434].

MLA dims per the paper: qk_nope 128, qk_rope 64, v_head 128, q_lora 1536.
First layer is dense (d_ff 12288).  E=1 (synchronous compressed
data-parallel) + FSDP: a 236B per-client replica cannot exist, so FediAC
runs as the compressed all-reduce (DESIGN.md §2).
"""

from repro_torch.core.fediac import FediACConfig

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek_v2_236b", arch_type="moe", source="arXiv:2405.04434",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=12288, vocab=102400, act="silu", attn_kind="mla",
        kv_lora_rank=512, q_lora_rank=1536, qk_rope_dim=64, qk_nope_dim=128,
        v_head_dim=128, mla_absorbed=True,
        n_experts=160, n_shared_experts=2, moe_top_k=6, d_ff_expert=1536,
        first_dense_layers=1, d_ff_dense=12288, capacity_factor=1.0,
        tie_embeddings=False, param_dtype="bfloat16", compute_dtype="bfloat16",
        grad_dtype="bfloat16", residual_dtype="bfloat16",
        fediac=FediACConfig(vote_chunk=4096, work_dtype="bfloat16",
                            granularity="tensor"),
        fsdp=True, microbatch=32, fl_local_steps=1,
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512, kv_lora_rank=32, q_lora_rank=48, qk_rope_dim=16,
        qk_nope_dim=32, v_head_dim=32, n_experts=4, n_shared_experts=1,
        moe_top_k=2, d_ff_expert=64, first_dense_layers=1, d_ff_dense=256,
        param_dtype="float32", compute_dtype="float32", fsdp=False, microbatch=1)
