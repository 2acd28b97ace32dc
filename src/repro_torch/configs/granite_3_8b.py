"""granite-3-8b [dense] — GQA. [hf:ibm-granite/granite-3.0 family; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8,
    d_ff=12800, vocab=49155, rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=96, vocab=250,      # deliberately off the 128-pad grid
    attn_chunk_q=64, attn_chunk_k=64, remat=False,
)
