"""DeiT-Base as evaluated in the paper (ImageNet, 197 patch tokens)."""
from repro_torch.models.config import HADConfig, ModelConfig

CONFIG = ModelConfig(
    name="deit-b",
    family="encoder",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=1000,            # ImageNet classes
    pad_vocab_to_multiple=128,
    causal=False,
    pos="learned",
    max_pos=256,
    frontend_dim=768,           # patch embeddings (stub frontend)
    act="gelu",
    had=HADConfig(topn_frac=30 / 197, n_min=8),  # paper fig. 3: N=30
    trainable="all",
    remat=False,
)
