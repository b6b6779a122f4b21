"""IBM Granite 3 8B: dense GQA decoder. [hf:ibm-granite/granite-3.0; hf]

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155 (note: the published
vocab is not a multiple of 16, so the embed shards on d_model only).
"""
from repro_torch.models.config import HADConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    pad_vocab_to_multiple=128,
    had=HADConfig(),
    trainable="all",
    remat=True,
)
