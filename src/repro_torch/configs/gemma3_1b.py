"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
5:1 local:global attention, 128k context. [hf:google/gemma-3-1b-pt].
Local layers decode against ring buffers of ``local_window`` slots, global
layers against full append caches."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,             # gemma3 uses wide heads
    d_ff=6912,
    vocab_size=262144,
    attention="local_global",
    local_global_ratio=5,     # 5 local : 1 global
    local_window=512,
    rope_theta=1000000.0,
    subquadratic=True,
)
