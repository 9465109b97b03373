"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192,
vocab=202048, MoE 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4_scout_17b_a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=0,
    vocab_size=202048,
    attention="full",
    moe=MoEConfig(num_experts=16, experts_per_token=1, d_ff_expert=8192),
    subquadratic=False,
)
