"""granite-moe-1b-a400m [moe] — 32 experts top-8, fine-grained d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8,
    d_ff=512, vocab=49155, rope_theta=10_000.0,
    n_experts=32, top_k=8, capacity_factor=1.25, moe_group=512,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=32, vocab=256,
    n_experts=8, top_k=2, moe_group=64,
    attn_chunk_q=64, attn_chunk_k=64, remat=False,
)
