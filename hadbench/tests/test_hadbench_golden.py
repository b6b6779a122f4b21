"""Golden readings of the harness, taken on the commit before the model
modules (``hadbench/reference/__init__.py``) and held against their
seam: the same seed draws the same weights (sha256 of each tensor, first
16 hex digits) and the same reference logits, the model module gives the
same FLOPs a token, and `run.kernel_shapes` the same shapes as each cell's
traced run built in place. Every value was read on that commit's code."""
import hashlib

import numpy as np
import pytest

from hadbench import manifest, program, reference, run, tiny

BENCH = manifest.load()
SEED = 11
# two fixed sequences over the tiny vocabulary (256), longer than N (16)
SEQS = [(np.arange(48) * 37 + 5) % 256, (np.arange(29) * 101 + 17) % 256]

WEIGHTS = {
    "smollm-135m": {
        "embed": "58468c089400efd9",
        "final_norm.w": "2f20cd03c9cd392a",
        "blocks.0.norm1.w": "2f20cd03c9cd392a",
        "blocks.0.mixer.wq": "9c4b30ab9c61bf26",
        "blocks.0.mixer.wk": "935ccc4b1901d4a9",
        "blocks.0.mixer.wv": "c8ca34f413b58ede",
        "blocks.0.mixer.wo": "1231a8bc980e45dc",
        "blocks.0.norm2.w": "2f20cd03c9cd392a",
        "blocks.0.ffn.w1": "a35feff9559d0d4a",
        "blocks.0.ffn.w2": "34b5c46f9de9bb14",
        "blocks.0.ffn.w3": "50aff82489d46679",
        "blocks.1.norm1.w": "2f20cd03c9cd392a",
        "blocks.1.mixer.wq": "f06466d32f4980f7",
        "blocks.1.mixer.wk": "bd1b845a47089022",
        "blocks.1.mixer.wv": "b32382c1a55ab3a2",
        "blocks.1.mixer.wo": "ef1179c57b6fdac5",
        "blocks.1.norm2.w": "2f20cd03c9cd392a",
        "blocks.1.ffn.w1": "05ca69a8986f11cd",
        "blocks.1.ffn.w2": "fe9f0feb46971a01",
        "blocks.1.ffn.w3": "8b66ef05555cf400",
    },
    "dbrx-132b-l8": {
        "embed": "58468c089400efd9",
        "lm_head": "ca32f8550665c671",
        "final_norm.w": "2f20cd03c9cd392a",
        "blocks.0.norm1.w": "2f20cd03c9cd392a",
        "blocks.0.mixer.wq": "9c4b30ab9c61bf26",
        "blocks.0.mixer.wk": "935ccc4b1901d4a9",
        "blocks.0.mixer.wv": "c8ca34f413b58ede",
        "blocks.0.mixer.wo": "1231a8bc980e45dc",
        "blocks.0.norm2.w": "2f20cd03c9cd392a",
        "blocks.0.ffn.router": "2694448474218b1c",
        "blocks.0.ffn.w1": "be00753136f3df96",
        "blocks.0.ffn.w2": "1d24d00ce30902c1",
        "blocks.0.ffn.w3": "919f410e209801a7",
        "blocks.1.norm1.w": "2f20cd03c9cd392a",
        "blocks.1.mixer.wq": "f06466d32f4980f7",
        "blocks.1.mixer.wk": "bd1b845a47089022",
        "blocks.1.mixer.wv": "b32382c1a55ab3a2",
        "blocks.1.mixer.wo": "ef1179c57b6fdac5",
        "blocks.1.norm2.w": "2f20cd03c9cd392a",
        "blocks.1.ffn.router": "27275141fcd50bc2",
        "blocks.1.ffn.w1": "ed99c804397164ae",
        "blocks.1.ffn.w2": "116aa867e20dd4f7",
        "blocks.1.ffn.w3": "3adb26d3d6a7b537",
    },
}
LOGITS = {
    "smollm-135m": ["008a13e452b6ec14", "c3a031cb6793fdf7"],
    "dbrx-132b-l8": ["f48bbc9f9ffff61d", "5ce5dea4a5b26f2a"],
}
# (context, n, head) -> FLOPs of one token, published port blocks
FLOPS = {
    "smollm-135m": {
        (1, 1737, True): 268994304.0,
        (1, 1737, False): 212371200.0,
        (10240, 1737, True): 328990464.0,
        (10240, 1737, False): 272367360.0,
        (512, 359, True): 281366784.0,
        (512, 359, False): 224743680.0,
    },
    "dbrx-132b-l8": {
        (1, 1737, True): 15327657984.0,
        (1, 1737, False): 14094532608.0,
        (10240, 1737, True): 15498313728.0,
        (10240, 1737, False): 14265188352.0,
        (512, 359, True): 15362850816.0,
        (512, 359, False): 14129725440.0,
    },
}
SHAPES = {
    "smollm-135m.doc_turns": dict(
        n_heads=9, n_kv_heads=3, head_dim=64, topn=1737,
        page_size=16, attn_layers=30, batch_slots=32),
    "dbrx-132b-l8.reasoning": dict(
        n_heads=48, n_kv_heads=8, head_dim=128, topn=359,
        page_size=16, attn_layers=8, batch_slots=8),
    "smollm-135m.short_chat": dict(
        n_heads=9, n_kv_heads=3, head_dim=64, topn=150,
        page_size=16, attn_layers=30, batch_slots=32),
}


one_thread = pytest.fixture(autouse=True)(tiny.one_thread)


def _sha(t) -> str:
    data = t.detach().contiguous().cpu().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def _module(config: str):
    return reference.module(
        manifest.reference_name(manifest.read_json("configs", config)))


@pytest.mark.parametrize("config", sorted(WEIGHTS))
def test_the_seed_draws_the_same_weights(config):
    port = tiny.port(config)
    model = program.build_model(port, seed=SEED, device="cpu",
                                rules=_module(config).draw_rules)
    assert {n: _sha(p) for n, p in model.named_parameters()} == \
        WEIGHTS[config]


@pytest.mark.parametrize("config", sorted(LOGITS))
def test_the_reference_gives_the_same_logits(config):
    ref = _module(config).Reference(tiny.port(config), seed=SEED,
                                    max_len=128, device="cpu")
    logits = ref.logits(SEQS, [np.arange(len(s)) for s in SEQS])
    assert [_sha(x) for x in logits] == LOGITS[config]


@pytest.mark.parametrize("config", sorted(FLOPS))
def test_the_module_counts_the_same_flops(config):
    port = manifest.read_json("configs", config)["port"]
    per_token = _module(config).flops_per_token
    got = {(c, n, head): per_token(port, c, n, head=head)
           for c, n, head in FLOPS[config]}
    assert got == FLOPS[config]


@pytest.mark.parametrize("workload", sorted(SHAPES))
def test_the_kernel_shapes_are_the_same(workload):
    cell = manifest.cell(BENCH, workload)
    got = run.kernel_shapes(cell["config"]["port"],
                            cell["traffic"]["engine"],
                            reference.module(cell["reference"]))
    assert got == SHAPES[workload]
