"""Per-chip pricing of a dry-run cell on the production mesh (16x16, or
2x16x16 with pods), from the sharding rules alone: the port's answer to
the JAX dry run's compile of 256-512 fake devices.

* **Arguments, exactly.** Each leaf of the cell's meta build (train:
  teacher, the student's own tensors, AdamW's moments, count, step, or the
  pretrain state; serve: parameters, dense caches) and each input takes
  its ``distributed.sharding.shard_shape`` under ``param_spec`` /
  ``cache_spec`` / ``batch_spec``, as JAX's dry run assigns them: the
  pretrain state is always FSDP (JAX ``abstract_pretrain_state``); the
  distill state and serving follow `use_fsdp`. A layer tensor is priced
  on its JAX shape, a leading groups axis of 1 before its own: the rules
  never shard that axis, and the MoE rules read the rank. A dense
  self-attention cache leaf of the port has one position more than JAX's
  (its trash position, ROADMAP §3 "Dropped writes"); positions [0,
  max_len) are priced under JAX's spec for JAX's shape (a spec on 32769
  positions would shard nothing), and the trash position as one position
  per chip, its sequence axis replicated ("trash" part).
* **Collectives, by formula** (`collectives`), per chip and step, ring
  algorithms over a group of n chips holding S bytes each after the
  collective (all-gather) or before it (reduce-scatter, all-reduce):
  all-gather and reduce-scatter move S (n - 1) / n, all-reduce 2 S (n -
  1) / n, all-to-all S (n - 1) / n of a buffer of S.
  - FSDP: every leaf sharded over the data axes is all-gathered for each
    forward, again for the remat backward's recompute, once per
    microbatch; the teacher's too in a distill step. Trainable leaves'
    gradients are reduce-scattered over the data axes when FSDP-sharded,
    else all-reduced over them, once per microbatch.
  - TP activations, the carry pattern of JAX's ``transformer.py``
    (``CARRY_PATTERN``; serving is always "b.."): each sublayer (mixer,
    FFN) of each pass of a layer moves its [b, S, D] output across the
    model axis: "sp" ("bq.", sequence parallel) an all-gather before and
    a reduce-scatter after, "dp" ("b..") one all-reduce of the partial
    sums: the same bytes, but "sp" saves each layer's carry at 1/16 and
    "dp" whole (``saved_carries_bytes``). Passes: a student or pretrained
    model forward, backward and (with remat) recompute; the teacher
    forward and recompute.
  - The "b.m" logits: serving gathers the vocabulary-sharded last logits
    [b, 1, V] (float32) over the model axis; training all-reduces each
    row's max and sum of exponentials (two float32) over it, forward and
    backward.
  - MoE: dispatch and combine are an all-to-all each over the model axis
    (experts sharded over it, JAX ``moe.py``'s "be.." constraints), of
    the [groups, E, capacity, D] expert buffer, each pass.
  - A cache whose sequence axis is sharded (decode_32k over "model",
    long_500k over every axis): a decode all-reduces each (row, head)'s
    (d + 1)-bin histogram (int32) and softmax partials (max, denominator,
    Dv sums; float32) over the sharding axes; a prefill all-gathers the
    layer's new K bits and V over them.
* **Link rates: an H100 cluster's, not ICI's.** Chips are numbered with
  the model axis innermost, 8 to an HGX H100 node: a group inside one
  node moves at NVLink's ``roofline.LINK_BW`` (450 GB/s a direction), a
  group that spans nodes at the node's network rate a GPU, NET_BW (8 x
  400 Gb/s ConnectX-7 NICs a node: 50 GB/s a GPU; NVIDIA DGX H100 data
  sheet). A collective is priced at the slowest link its group crosses;
  on these meshes the model axis (16) already spans two nodes.
* **Compute and HBM, a lower bound.** The cell's step is counted on the
  meta device (``launch.op_cost.Counter``; kernels report their work from
  shapes) at one data replica's batch, and the mesh's global step is the
  data-axis replicas' steps (a replicated batch, B not divisible by the
  data axes, is counted once); each chip gets an even share. What SPMD
  would compute redundantly -- smollm's 3 kv heads over a model axis of
  16, a replicated batch -- is not priced. See ``dryrun.mesh_terms``.
"""
from __future__ import annotations

import math

from repro_torch.checkpoint.bridge import SEP, jax_key
from repro_torch.core import hamming
from repro_torch.distributed import sharding as SH
from repro_torch.launch import roofline as RL
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

NODE_GPUS = 8
NET_BW = 50e9              # bytes/s a GPU across nodes: 8 x 400 Gb/s a node
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")


def use_fsdp(cfg: ModelConfig, *, train: bool) -> bool:
    """JAX's rule (``repro.launch.dryrun.use_fsdp``): FSDP only when
    (params + optimizer state) / TP exceeds ~2 GB a chip."""
    tp = 16
    params = M.param_count(cfg)
    if train:
        trainable = (params if cfg.trainable == "all"
                     else M.trainable_param_count(cfg))
        per_chip = (2 * params + 8 * trainable) / tp
    else:
        per_chip = 2 * params / tp
    return per_chip > 2e9


def data_size(mesh) -> int:
    return SH.axis_size(mesh, SH.batch_axes(mesh))


def default_grad_accum(shape: M.ShapeSpec, mesh) -> int:
    """JAX's ``default_grad_accum``: about 2 sequences a chip a
    microbatch."""
    per_replica = max(shape.global_batch // max(data_size(mesh), 1), 1)
    accum = max(per_replica // 2, 1)
    while per_replica % accum:
        accum -= 1
    return accum


def replica_batch(shape: M.ShapeSpec, mesh) -> tuple[int, int]:
    """(sequences a data replica holds, replicas that hold different
    ones): the batch over the data axes when it divides (JAX
    ``batch_spec``), else the whole batch, replicated."""
    d = data_size(mesh)
    if shape.global_batch % d == 0:
        return shape.global_batch // d, d
    return shape.global_batch, 1


# ---------------------------------------------------------------------------
# per-chip arguments
# ---------------------------------------------------------------------------

def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def leaf_spec(cfg: ModelConfig, name: str, shape, mesh, *, fsdp: bool):
    """(JAX shape, spec) of a model tensor by its port name: layer tensors
    get JAX's leading groups axis (of 1)."""
    key, g = jax_key(cfg, name)
    jshape = tuple(shape) if g is None else (1,) + tuple(shape)
    return jshape, SH.param_spec(key.split(SEP), jshape, mesh,
                                 fsdp_enabled=fsdp)


def tensor_bytes(cfg: ModelConfig, named: dict, mesh, *, fsdp: bool) -> int:
    """Per-chip bytes of model tensors (or moments keyed like them)."""
    total = 0
    for name, t in named.items():
        jshape, spec = leaf_spec(cfg, name, t.shape, mesh, fsdp=fsdp)
        total += _nbytes(SH.shard_shape(jshape, spec, mesh), t.dtype)
    return total


def input_bytes(cfg: ModelConfig, shape: M.ShapeSpec, mesh) -> int:
    total = 0
    for spec in M.input_specs(cfg, shape).values():
        sp = SH.batch_spec(spec.shape, mesh, global_batch=shape.global_batch)
        total += _nbytes(SH.shard_shape(spec.shape, sp, mesh), spec.dtype)
    return total


def train_parts(cfg: ModelConfig, state: dict, shape: M.ShapeSpec, mesh, *,
                fsdp: bool) -> dict:
    """Per-chip argument bytes of a train cell's state (a meta build) by
    part, and its inputs. The pretrain state is FSDP whatever `fsdp`."""
    opt = state["opt"]
    if "teacher" in state:
        params = tensor_bytes(cfg, T.named_tensors(state["teacher"]), mesh,
                              fsdp=fsdp)
        student = tensor_bytes(cfg, T.student_tensors(cfg, state["student"]),
                               mesh, fsdp=fsdp)
    else:
        fsdp = True
        params = tensor_bytes(cfg, T.named_tensors(state["params"]), mesh,
                              fsdp=fsdp)
        student = 0
    moments = sum(tensor_bytes(cfg, opt[m], mesh, fsdp=fsdp)
                  for m in ("mu", "nu"))
    return {"params": params, "student": student,
            "opt": moments + opt["count"].element_size(),
            "step": state["step"].element_size(),
            "inputs": input_bytes(cfg, shape, mesh)}


def _cache_leaves(cfg: ModelConfig, caches: list[dict]):
    for kind, cache in zip(T.layer_kinds(cfg), caches):
        for name, leaf in cache.items():
            yield kind, name, leaf


SEQ_AXIS = {"k_bits": 3, "v": 2, "k": 2}   # of a port cache leaf [B, ...]


def cache_parts(cfg: ModelConfig, caches: list[dict], shape: M.ShapeSpec,
                mesh) -> dict:
    """Per-chip bytes of the dense serving caches: "caches" priced on
    JAX's shapes and spec (positions [0, max_len) of a self-attention
    leaf), "trash" the port's extra position of each self-attention
    leaf, one a chip (its batch sharding kept, its sequence axis
    replicated)."""
    caches_b = trash_b = 0
    for kind, name, leaf in _cache_leaves(cfg, caches):
        jshape = (1,) + tuple(leaf.shape)
        seq = SEQ_AXIS.get(name)
        if kind == "A" and seq is not None:
            jshape = jshape[:seq + 1] + (jshape[seq + 1] - 1,) + \
                jshape[seq + 2:]
        spec = SH.cache_spec(name, jshape, mesh,
                             global_batch=shape.global_batch)
        caches_b += _nbytes(SH.shard_shape(jshape, spec, mesh), leaf.dtype)
        if kind == "A" and seq is not None:
            one = jshape[:seq + 1] + (1,) + jshape[seq + 2:]
            entries = list(spec) + [None] * (len(one) - len(spec))
            entries[seq + 1] = None
            trash_b += _nbytes(SH.shard_shape(one, SH.Spec(*entries), mesh),
                               leaf.dtype)
    return {"caches": caches_b, "trash": trash_b}


def seq_axes(cfg: ModelConfig, shape: M.ShapeSpec, mesh):
    """The mesh axes a dense self-attention cache's sequence axis is
    sharded over (JAX ``cache_spec`` on its v leaf), or None."""
    jshape = (1, shape.global_batch, cfg.n_kv_heads, shape.seq_len, cfg.dh)
    return SH.cache_spec("v", jshape, mesh,
                         global_batch=shape.global_batch)[3]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def group_bw(mesh, axes) -> float:
    """The rate of a collective over `axes`: NVLink when its group of
    chips lies inside one node (chips numbered row-major over the mesh
    axes, the model axis innermost), else the network's."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = list(mesh.shape)
    strides = {}
    step = 1
    for name in reversed(names):
        strides[name] = step
        step *= mesh.shape[name]
    span = 1 + sum((mesh.shape[a] - 1) * strides[a] for a in axes)
    return RL.LINK_BW if span <= NODE_GPUS else NET_BW


class Collectives:
    """Per-chip bytes by kind, and their time at each group's rate."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.bytes = {k: 0.0 for k in KINDS}
        self.seconds = 0.0

    def add(self, kind: str, size: float, axes, times: float = 1) -> None:
        """`times` collectives of `kind` over `axes` on S = `size` bytes
        (formulas: module docstring)."""
        n = SH.axis_size(self.mesh, axes)
        if n <= 1 or size <= 0 or times <= 0:
            return
        moved = size * (n - 1) / n * (2 if kind == "all-reduce" else 1)
        self.bytes[kind] += moved * times
        self.seconds += moved * times / group_bw(self.mesh, axes)

    def as_dict(self) -> dict:
        return {k: v for k, v in self.bytes.items() if v}


def _sublayers(cfg: ModelConfig) -> int:
    """Sublayers a layer moves its output across the model axis for: the
    mixer and the FFN."""
    return cfg.n_layers * (1 + (cfg.d_ff > 0 or cfg.n_experts > 0))


def _moe_layers(cfg: ModelConfig) -> int:
    return sum(T.layer_uses_moe(cfg, i) for i in range(cfg.n_layers))


def _expert_buffer(cfg: ModelConfig, tokens: int, *, train: bool) -> int:
    """Bytes of the [groups, E, capacity, D] expert buffer of `tokens`."""
    shape = moe.train_group_shape if train else moe.group_shape
    g, _, cap = shape(tokens, cfg)
    return g * cfg.n_experts * cap * cfg.d_model * cfg.dtype.itemsize


def _fsdp_leaves(cfg: ModelConfig, named: dict, mesh, *, fsdp: bool):
    """(per-chip bytes, sharded over the data axes) of each tensor."""
    fa = set(SH.fsdp_axes(mesh))
    for name, t in named.items():
        jshape, spec = leaf_spec(cfg, name, t.shape, mesh, fsdp=fsdp)
        used = set()
        for e in spec:
            if e is not None:
                used.update((e,) if isinstance(e, str) else e)
        yield (_nbytes(SH.shard_shape(jshape, spec, mesh), t.dtype),
               bool(used & fa))


def train_collectives(cfg: ModelConfig, state: dict, shape: M.ShapeSpec,
                      mesh, *, fsdp: bool, carry: str, accum: int
                      ) -> tuple[Collectives, int]:
    """(collectives, saved carry bytes) of one train step a chip."""
    col = Collectives(mesh)
    fa = SH.fsdp_axes(mesh)
    f = SH.axis_size(mesh, fa)
    remat = 1 if cfg.remat else 0
    distill = "teacher" in state
    if not distill:
        fsdp = True
    trainable = (T.student_tensors(cfg, state["student"]) if distill
                 else T.named_tensors(state["params"]))
    # FSDP gathers: forward (+ remat recompute) a microbatch
    gathered = dict(trainable)
    if distill:
        gathered.update(T.named_tensors(state["teacher"]))
    for nbytes, sharded in _fsdp_leaves(cfg, gathered, mesh, fsdp=fsdp):
        if sharded:
            col.add("all-gather", nbytes * f, fa, times=accum * (1 + remat))
    # gradients, a microbatch
    for nbytes, sharded in _fsdp_leaves(cfg, trainable, mesh, fsdp=fsdp):
        if sharded:
            col.add("reduce-scatter", nbytes * f, fa, times=accum)
        else:
            col.add("all-reduce", nbytes, fa, times=accum)
    # TP activations of a replica's microbatch, every pass
    b_rep, _ = replica_batch(shape, mesh)
    b = max(b_rep // accum, 1)
    act = b * shape.seq_len * cfg.d_model * cfg.dtype.itemsize
    passes = (2 + remat) + ((1 + remat) if distill else 0)
    per_pass = _sublayers(cfg) * passes * accum
    if carry == "sp":
        col.add("all-gather", act, "model", times=per_pass)
        col.add("reduce-scatter", act, "model", times=per_pass)
    else:
        col.add("all-reduce", act, "model", times=per_pass)
    # the "b.m" logits: a row's max and sum, forward and backward
    models = 2 if distill else 1
    col.add("all-reduce", b * shape.seq_len * 2 * 4, "model",
            times=accum * (models + 1))
    n_moe = _moe_layers(cfg)
    if n_moe:
        buf = _expert_buffer(cfg, b * shape.seq_len, train=True)
        col.add("all-to-all", buf / SH.axis_size(mesh, "model"), "model",
                times=2 * n_moe * passes * accum)
    share = SH.axis_size(mesh, "model") if carry == "sp" else 1
    saved = (cfg.n_layers * act // share * models) if cfg.remat else 0
    return col, saved


def serve_collectives(cfg: ModelConfig, params: dict, shape: M.ShapeSpec,
                      mesh, *, fsdp: bool) -> Collectives:
    """The collectives of one serve step a chip (carry "b..")."""
    col = Collectives(mesh)
    fa = SH.fsdp_axes(mesh)
    f = SH.axis_size(mesh, fa)
    for nbytes, sharded in _fsdp_leaves(cfg, params, mesh, fsdp=fsdp):
        if sharded:
            col.add("all-gather", nbytes * f, fa)
    b, _ = replica_batch(shape, mesh)
    s = shape.seq_len if shape.kind == "prefill" else 1
    act = b * s * cfg.d_model * cfg.dtype.itemsize
    col.add("all-reduce", act, "model", times=_sublayers(cfg))
    col.add("all-gather", b * cfg.padded_vocab * 4, "model")
    n_moe = _moe_layers(cfg)
    if n_moe:
        buf = _expert_buffer(cfg, b * s, train=False)
        col.add("all-to-all", buf / SH.axis_size(mesh, "model"), "model",
                times=2 * n_moe)
    axes = seq_axes(cfg, shape, mesh) if cfg.n_heads else None
    n_attn = T.layer_kinds(cfg).count("A")
    if axes is not None and n_attn:
        binary = bool(cfg.had.enabled and cfg.has_attention)
        if shape.kind == "decode":
            # each chip's rows: its replica's (all when replicated)
            stats = b * cfg.n_heads * ((cfg.dh + 1) * 4 + (2 + cfg.dh) * 4)
            col.add("all-reduce", stats, axes, times=n_attn)
        else:
            k = (b * cfg.n_kv_heads * s * hamming.packed_words(cfg.dh) * 4
                 if binary
                 else b * cfg.n_kv_heads * s * cfg.dh * cfg.dtype.itemsize)
            v = b * cfg.n_kv_heads * s * cfg.dh * cfg.dtype.itemsize
            col.add("all-gather", k + v, axes, times=n_attn)
    return col


def chips(mesh) -> int:
    return math.prod(mesh.shape.values())


def mesh_name(mesh) -> str:
    return "x".join(str(v) for v in mesh.shape.values())

