"""Mamba2 130M: attention-free SSD. [arXiv:2405.21060]

24L d_model=768, ssm_state=128, expand=2 (d_inner 1536, 24 SSD heads of 64).

HAD-applicability: NONE — there are no keys/queries to binarize
(DESIGN.md §6). The arch runs the standard CE pretrain path and native
recurrent-state serving; long_500k decode is O(1) state per token.
"""
from repro_torch.models.config import HADConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    pad_vocab_to_multiple=128,
    layer_pattern="M",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    had=HADConfig(enabled=False),
    trainable="all",
    remat=True,
)
