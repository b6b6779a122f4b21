"""Granite 4.0-H Small (32B total, 9B active): Mamba2 mixers with NoPE GQA
attention at one layer in ten, an MoE FFN with a shared expert at every
layer. [hf:ibm-granite/granite-4.0-h-small config.json]

40L d_model=4096: layers 5, 15, 25 and 35 attention (32 query / 8 kv heads
of 128, no positional encoding), the other 36 Mamba2 (128 heads of 64,
d_state 128, one B/C group, conv 4 over x, B and C with a bias, SSD chunk
256, gate before the norm); 72 experts of width 768, top-10, plus a shared
SwiGLU expert of 1536; vocab 100352, tied embeddings; embeddings x12,
residual branches x0.22, logits / 16, attention scale 1/128.

The port alone has it (the JAX package has no twin: it lacks the
published mixer, the shared expert and the multipliers).
"""
from repro_torch.models.config import HADConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    n_experts=72,
    experts_per_token=10,
    moe_every=1,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_mixer="published",
    shared_expert_width=1536,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    layer_pattern="MMMMMAMMMM",
    pos="none",
    norm_eps=1e-5,
    tie_embeddings=True,
    had=HADConfig(),
    trainable="attention",
    remat=True,
)
