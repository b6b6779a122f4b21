"""Shared model-pattern × serving-feature validation.

The single place where restrictions tying a ``ServeConfig`` to a model's
``layer_pattern`` are expressed.  Engine and ModelRunner both call
``validate_serve_features`` so the rules cannot drift apart; the
Scheduler stays pattern-agnostic and receives only the resolved
``state_layers`` count.

Since the paged recurrent-state pools landed, engines with SSM or
cross-attention layers accept ``prefix_cache`` and ``swap_pages`` like
pure-transformer engines do; the remaining restrictions are about
configuration coherence, not model family.
"""
from __future__ import annotations

from typing import Tuple

STATE_LAYER_CHARS = "MC"


def state_layer_positions(layer_pattern: str) -> Tuple[int, ...]:
    """Pattern positions whose layers carry per-slot recurrent/cross state."""
    return tuple(i for i, ch in enumerate(layer_pattern)
                 if ch in STATE_LAYER_CHARS)


def resolve_state_pages(scfg) -> int:
    """Entries in the pooled state allocation (explicit or auto-sized).

    Auto default: one live entry per slot, times 4 when prefix caching is
    on so checkpoints have headroom before they start evicting each other.
    """
    if scfg.state_pages is not None:
        return int(scfg.state_pages)
    return scfg.batch_slots * (4 if scfg.prefix_cache else 1)


def validate_serve_features(layer_pattern: str, scfg) -> None:
    """Raise ValueError when scfg requests features the model can't serve."""
    n_state = len(state_layer_positions(layer_pattern))
    if scfg.state_pages is not None:
        if not scfg.paged:
            raise ValueError("state_pages requires paged=True")
        if n_state == 0:
            raise ValueError(
                "state_pages is only meaningful for models with SSM or "
                f"cross-attention layers (pattern {layer_pattern!r} has none)")
        if scfg.state_pages < scfg.batch_slots:
            raise ValueError(
                f"state_pages ({scfg.state_pages}) must cover one live entry "
                f"per slot (batch_slots={scfg.batch_slots})")
        # With prefix caching every admission may pin a restore-source
        # checkpoint while also allocating a live entry; 2x batch_slots
        # guarantees an unpinned entry always exists for the live side.
        if scfg.prefix_cache and scfg.state_pages < 2 * scfg.batch_slots:
            raise ValueError(
                f"state_pages ({scfg.state_pages}) must be >= "
                f"2*batch_slots ({2 * scfg.batch_slots}) with prefix_cache")
    if scfg.page_topn is not None and "A" not in layer_pattern:
        raise ValueError(
            "page_topn requires self-attention layers "
            f"(pattern {layer_pattern!r} has no 'A')")


def mesh_model_size(scfg) -> int:
    """Size of ``ServeConfig.mesh``'s "model" axis (1 when unset).

    Duck-typed on ``mesh.shape`` (a mapping of axis name -> size) so this
    module — like the scheduler — never imports jax.
    """
    mesh = getattr(scfg, "mesh", None)
    if mesh is None:
        return 1
    try:
        return int(dict(mesh.shape).get("model", 1))
    except (TypeError, ValueError, AttributeError):
        raise ValueError(
            f"ServeConfig.mesh must expose a mapping-like .shape with a "
            f"'model' axis (got {mesh!r})") from None


def validate_serve_mesh(cfg, scfg) -> None:
    """Raise ValueError when the mesh cannot shard this model's heads.

    Serving TP shards the KV pools (and wq/wk/wv) over whole GQA kv-head
    groups, so the mesh's model axis must divide ``ModelConfig.n_kv_heads``
    exactly — GSPMD-style padding would break the bit-identical parity
    pins. Pure-SSM patterns (no attention layers) have nothing to shard
    and run replicated under any mesh.
    """
    tp = mesh_model_size(scfg)
    if tp <= 1:
        return
    hk = int(getattr(cfg, "n_kv_heads", 0) or 0)
    if "A" not in cfg.layer_pattern and "C" not in cfg.layer_pattern:
        return
    if hk % tp != 0:
        raise ValueError(
            f"mesh model axis ({tp}) must divide ModelConfig.n_kv_heads "
            f"({hk}): serving shards the KV pools over whole GQA kv-head "
            f"groups. Pick a --mesh-model / ServeConfig.mesh model-axis "
            f"size from the divisors of n_kv_heads, or repack the model's "
            f"heads.")
