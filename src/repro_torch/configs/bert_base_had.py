"""BERT-Base as evaluated in the paper (GLUE, ctx 256, N=30)."""
from repro_torch.models.config import HADConfig, ModelConfig

CONFIG = ModelConfig(
    name="bert-base-had",
    family="encoder",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=30522,
    pad_vocab_to_multiple=128,
    causal=False,
    pos="learned",
    max_pos=512,
    act="gelu",
    had=HADConfig(topn_frac=30 / 256),   # paper: N=30 at ctx 256
    trainable="all",
    remat=False,
)
