"""zamba2-7b [hybrid]: 81L d_model=3584, Mamba2 backbone (ssm_state=64) with
a SHARED attention+MLP block applied periodically (32H kv=32, d_ff=14336)
[arXiv:2411.15242].  Sub-quadratic -> long_500k RUNS."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2_7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    attention="full",          # the shared block's attention
    ssm=SSMConfig(kind="mamba2", state_dim=64, expand=2, head_dim=64),
    shared_attn_every=6,       # shared block every 6 mamba layers
    subquadratic=True,
)
