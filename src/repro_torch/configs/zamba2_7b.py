"""zamba2-7b [hybrid] — Mamba2 backbone + ONE shared attn+MLP block.
[arXiv:2411.15242; unverified]

81 Mamba2 (SSD, state=64) layers; the single weight-shared attention+MLP
block is applied every 6th layer (13 applications, each with its own KV
cache at serve time). ssm head_dim=64 -> 112 heads at d_inner=7168.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32,
    d_ff=14336, vocab=32000, rope_theta=10_000.0,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv=4,
    d_ff=128, vocab=256,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4,
    attn_every=2, ssd_chunk=32,
    attn_chunk_q=64, attn_chunk_k=64, remat=False,
)
