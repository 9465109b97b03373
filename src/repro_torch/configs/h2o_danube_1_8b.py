"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000.  llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf].  Every layer decodes against a ring buffer of
``window`` slots."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o_danube_1_8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attention="swa",
    window=4096,
    subquadratic=True,
)
