"""xlstm-125m [ssm]: 12 blocks d_model=768, 4 heads, sLSTM + mLSTM mix,
d_ff=0 (projections live inside the blocks), vocab=50304
[arXiv:2405.04517].  Recurrent -> long_500k RUNS."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm_125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    attention="none",
    ssm=SSMConfig(kind="xlstm", state_dim=192, slstm_every=4, chunk=128),
    subquadratic=True,
)
