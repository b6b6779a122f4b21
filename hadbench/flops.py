"""Model FLOPs a served token needs: the matrix products of every layer
(active experts only for MoE, with the router), plus the E.V products
of the keys HAD keeps (at least min(N, context) a query head a layer),
and the head where the token's logits are computed: every decode token,
and of a prefill chunk its last position alone (the runner computes a
chunk's logits there only). The integer scores on binarized keys are not FLOPs; the
kernel rooflines count them. The benchmark's own formula, in the spirit
of ``repro_torch.launch.roofline.model_flops`` (2 x active parameters a
token, forward only)."""
from __future__ import annotations


def per_token(port: dict, context: int, n: int, head: bool = True
              ) -> float:
    """FLOPs of one token whose attention sees `context` keys, N = n,
    with the head's if `head`."""
    d, f, v = port["d_model"], port["d_ff"], port["vocab_size"]
    h, hk, dh = port["n_heads"], port["n_kv_heads"], port["head_dim"]
    proj = d * h * dh + 2 * d * hk * dh + h * dh * d
    e = port.get("n_experts", 0)
    ffn = (3 * d * f * port["experts_per_token"] + d * e if e
           else 3 * d * f)
    ev = h * dh * min(n, context)
    return 2.0 * (port["n_layers"] * (proj + ffn + ev) + head * d * v)
