"""Llama 3.2 Vision 11B: text decoder with cross-attention image layers.
[hf:meta-llama/Llama-3.2-11B-Vision]

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer
cross-attends to vision-tower patch embeddings (stubbed per the assignment:
`input_specs` feeds precomputed [B, 1601, 1280] patch embeddings).

HAD applies to BOTH self- and cross-attention: image keys binarize exactly
like text keys (DESIGN.md §6).
"""
from repro_torch.models.config import HADConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    layer_pattern="AAAAC",
    n_image_tokens=1601,
    frontend_dim=1280,
    had=HADConfig(),
    trainable="all",
    remat=True,
)
