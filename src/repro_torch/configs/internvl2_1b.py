"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655.  InternViT frontend + Qwen2-class LM backbone
[arXiv:2404.16821; hf].  Vision frontend is a stub: input_specs feeds
precomputed patch embeddings prepended to the token stream."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2_1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    attention="full",
    frontend="vision",
    num_patches=256,
    subquadratic=False,
)
