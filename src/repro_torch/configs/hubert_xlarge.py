"""HuBERT X-Large: bidirectional audio encoder. [arXiv:2106.07447]

48L d_model=1280 16H (full MHA kv=16, head_dim 80) d_ff=5120, 504 output
classes. The conv feature extractor is a stub: `input_specs` feeds
precomputed [B, S, 512] frame embeddings (assignment note). Encoder-only:
no decode shapes (DESIGN.md §6); prefill_32k runs as a full encode.

This is the paper's home turf — BiT/HAD target exactly this
encoder-attention setting (BERT-style), so the full recipe applies.
"""
from repro_torch.models.config import HADConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    pad_vocab_to_multiple=128,
    causal=False,
    pos="learned",
    max_pos=32768,
    frontend_dim=512,
    act="gelu",
    had=HADConfig(),
    trainable="all",
    remat=True,
)
