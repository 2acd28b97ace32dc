"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, d_ff=0 (projections live
inside the blocks). [arXiv:2405.04517; unverified]

48 blocks at the paper's 7:1 ratio -> 42 mLSTM + 6 sLSTM (slstm_every=8).
mLSTM: matrix memory, chunkwise-parallel training; sLSTM: scalar memory,
lax.scan recurrence. 4 heads at d_model=2048.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv=4,
    d_ff=0, vocab=50304,
    slstm_every=8, mlstm_proj=2, ssm_conv=4,
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=2, n_kv=2,
    d_ff=0, vocab=256,
    slstm_every=2, mlstm_proj=2, ssm_conv=4, ssd_chunk=32,
    remat=False,
)
