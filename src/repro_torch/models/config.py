"""Model + HAD configuration dataclasses (jax-free copy of
``repro.models.config``).

One ModelConfig covers every assigned architecture family (dense GQA, MoE,
SSM, hybrid, VLM, encoder); configs/<arch>.py files instantiate it with the
exact published hyperparameters. Every field the JAX package has, ``reduced()`` and
``HADConfig.topn`` match the JAX package's; only ``dtype`` differs, naming
a torch dtype. The fields below "published Mamba2 mixer, shared expert and
multipliers" are the port's own (the JAX package has no such model): their
defaults add no operation, so every configuration that leaves them alone
computes what the JAX package's does.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class HADConfig:
    """Hamming Attention Distillation settings (paper §3)."""

    enabled: bool = True
    topn_frac: float = 0.117      # N / context (paper: 30/256)
    n_min: int = 16
    n_max: int = 4096
    sigma_init: float = 1.0       # before Eq. 12 estimation
    # kept for field parity with the JAX config: the port dispatches by
    # tensor device instead (kernels on CUDA, plain versions on the CPU)
    use_kernels: bool = False
    kernel_block_q: int = 256
    kernel_block_t: int = 512

    def topn(self, context_len: int) -> int:
        from repro_torch.core.topn import scale_n_with_context
        return scale_n_with_context(context_len, frac=self.topn_frac,
                                    n_min=self.n_min, n_max=self.n_max)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "encoder"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1            # MoE FFN every k-th layer (jamba: 2)
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64           # SSD chunk length

    # --- published Mamba2 mixer, shared expert and multipliers (port) ---
    # the Mamba2 mixer's form: "jax", the JAX package's (the conv over x
    # alone, unbiased; rmsnorm(y) * silu(z)), or "published", Mamba2's
    # (the conv, with a bias, over x, B and C together; the gate before
    # the norm: rmsnorm(y * silu(z)))
    ssm_mixer: Literal["jax", "published"] = "jax"
    # a SwiGLU expert of this width that every token passes through, added
    # to the routed experts' sum (published `shared_intermediate_size`)
    shared_expert_width: int = 0
    # token embeddings x embedding_multiplier; each mixer's and FFN's
    # output x residual_multiplier before it joins the residual stream;
    # logits / logits_scaling; attention_multiplier replaces head_dim^-0.5
    # as the logit scale (0: head_dim^-0.5). 1 (0) adds no operation.
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0

    # --- layer pattern (hybrid / vlm) ---
    # string over {'A': attention, 'M': mamba, 'C': cross-attention};
    # n_layers % len(pattern) == 0; the pattern repeats in groups and the
    # group is scanned over for compile-time compactness.
    layer_pattern: str = "A"

    # --- VLM / audio frontend stubs ---
    n_image_tokens: int = 0
    frontend_dim: int = 0         # encoder/vlm stub embedding dim

    # --- misc arch ---
    causal: bool = True
    pos: Literal["rope", "learned", "none"] = "rope"
    max_pos: int = 0              # learned-pos table size (encoders)
    # pad embed/lm_head vocab dim to this multiple: keeps the (huge) f32
    # logits shardable over the model axis when the published vocab isn't
    # divisible (granite 49155, mamba2 50280, hubert 504). Losses mask the
    # pad columns so the math is identical (tests: test_vocab_padding).
    pad_vocab_to_multiple: int = 1
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: Literal["swiglu", "gelu"] = "swiglu"
    tie_embeddings: bool = False

    # --- HAD ---
    had: HADConfig = HADConfig()

    # --- training/runtime ---
    trainable: Literal["all", "attention"] = "all"
    remat: bool = True
    param_dtype: str = "bfloat16"
    q_block: int = 512            # distill attention query chunk

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.n_heads:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0
        assert self.n_layers % len(self.layer_pattern) == 0, \
            (self.name, self.n_layers, self.layer_pattern)
        assert self.ssm_mixer in ("jax", "published"), self.ssm_mixer

    @property
    def padded_vocab(self) -> int:
        m = max(self.pad_vocab_to_multiple, 1)
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def dh(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def group_size(self) -> int:
        return len(self.layer_pattern)

    @property
    def dtype(self):
        import torch
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.param_dtype]

    @property
    def has_attention(self) -> bool:
        return any(ch in ("A", "C") for ch in self.layer_pattern)

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def attn_scale(self) -> float:
        """The attention logit scale before HAD's sigmas: the published
        attention_multiplier, or head_dim^-0.5."""
        return self.attention_multiplier or self.dh ** -0.5

    @property
    def ssm_conv_width(self) -> int:
        """Channels of the SSM's depthwise conv: x (d_inner), plus B and C
        (2 ssm_state) in the published mixer."""
        return self.d_inner + (2 * self.ssm_state
                                if self.ssm_mixer == "published" else 0)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        small = dict(
            n_layers=max(2 * len(self.layer_pattern) // len(self.layer_pattern),
                         1) * len(self.layer_pattern),
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 256),
            head_dim=16 if self.n_heads else 0,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            shared_expert_width=min(self.shared_expert_width, 128),
            n_image_tokens=min(self.n_image_tokens, 8),
            frontend_dim=min(self.frontend_dim, 32) if self.frontend_dim else 0,
            param_dtype="float32",
            q_block=32,
        )
        # keep one group of the original pattern
        small["n_layers"] = len(self.layer_pattern)
        if self.n_heads and small["n_heads"] % max(small["n_kv_heads"], 1):
            small["n_kv_heads"] = 1
        small.update(overrides)
        return dataclasses.replace(self, **small)
