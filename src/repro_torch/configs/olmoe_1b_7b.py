"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff(expert)=1024,
vocab=50304, MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe_1b_7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,                  # all FFN capacity lives in the experts
    vocab_size=50304,
    attention="full",
    moe=MoEConfig(num_experts=64, experts_per_token=8, d_ff_expert=1024),
    subquadratic=False,
)
