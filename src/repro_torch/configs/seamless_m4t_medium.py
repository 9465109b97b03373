"""seamless-m4t-medium [audio]: enc-dec multimodal backbone.
12L enc + 12L dec, d_model=1024, 16H (GQA kv=16), d_ff=4096, vocab=256206.
[arXiv:2308.11596; hf].  Audio frontend is a stub: input_specs feeds
precomputed frame embeddings (DESIGN.md §4)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless_m4t_medium",
    family="audio",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    attention="full",
    frontend="audio",
    subquadratic=False,       # full attention -> long_500k skipped
)
