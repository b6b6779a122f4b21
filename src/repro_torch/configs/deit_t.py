"""DeiT-Tiny as evaluated in the paper (fig. 3 N-sweep, table 2)."""
from repro_torch.models.config import HADConfig, ModelConfig

CONFIG = ModelConfig(
    name="deit-t",
    family="encoder",
    n_layers=12,
    d_model=192,
    n_heads=3,
    n_kv_heads=3,
    head_dim=64,
    d_ff=768,
    vocab_size=1000,
    pad_vocab_to_multiple=128,
    causal=False,
    pos="learned",
    max_pos=256,
    frontend_dim=192,
    act="gelu",
    had=HADConfig(topn_frac=30 / 197, n_min=8),
    trainable="all",
    remat=False,
)
