"""dbrx-132b [moe] — 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv=8,
    d_ff=10752, vocab=100352, rope_theta=500_000.0,
    n_experts=16, top_k=4, capacity_factor=1.25, moe_group=512,
)

SMOKE = ModelConfig(
    name="dbrx-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=96, vocab=256,
    n_experts=4, top_k=2, moe_group=64,
    attn_chunk_q=64, attn_chunk_k=64, remat=False,
)
