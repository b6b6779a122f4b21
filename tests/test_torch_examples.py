"""The examples' PyTorch twins (``examples/torch_*.py``) on the CPU.

Each twin runs and its own checks hold: ``torch_long_context_serve`` with
no flag and with each of --paged, --prefix-cache, --swap-pages 16 and
--page-topn 4 at the JAX example's 512-token context (swap-outs happen;
prefix repeats equal firsts; full-coverage page-topn equals dense; packed
serving equals the dense +-1 path; ragged equals sequential);
``torch_quickstart`` whole; ``torch_distill_encoder`` at reduced step
counts. Against JAX: the quickstart's sigma estimate on JAX's teacher
(converted with ``params_from_numpy``) and JAX's data equals JAX's
``estimate_and_set_sigmas`` (rtol 1e-5). The twins import no jax. The
twins' training loops are held against JAX step by step in
``tests/test_torch_examples_train.py``.
"""
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data import lm_stream as jlm_stream
from repro.models import ModelConfig as JModelConfig
from repro.models import model as JM
from repro.models.config import HADConfig as JHADConfig
from repro.train import estimate_and_set_sigmas as jestimate
from repro_torch.checkpoint import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("torch_quickstart", "torch_long_context_serve",
         "torch_distill_encoder")


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [[], ["--paged"], ["--prefix-cache"],
                                   ["--swap-pages", "16"],
                                   ["--page-topn", "4"]],
                         ids=["dense", "paged", "prefix", "swap", "topn"])
def test_long_context_serve_checks_hold(flags, capsys):
    out = _twin("torch_long_context_serve").main(["--device", "cpu"]
                                                 + flags)
    text = capsys.readouterr().out
    assert "ragged continuous batching == sequential" in text
    assert "packed-bit ragged serving == dense ±1 evaluation path" in text
    assert [len(t) for t in out["tokens"]] == [12, 12, 12]
    if flags[:1] == ["--swap-pages"]:
        assert out["stats"]["swap_outs"] > 0
    if flags[:1] == ["--prefix-cache"]:
        assert "tokens bit-identical" in text
    if flags[:1] == ["--page-topn"]:
        assert "bit-identical to dense" in text


def test_long_context_serve_raises_where_a_check_fails(monkeypatch):
    """The checks are live: with the pool sized four times the workload's
    footprint nothing is ever swapped out, and the swap-out check raises,
    as the JAX example's assertion does."""
    mod = _twin("torch_long_context_serve")
    real = mod.pages_needed
    monkeypatch.setattr(mod, "pages_needed", lambda n, p: 4 * real(n, p))
    model = mod.T.init_params(mod.CFG, mod.torch.Generator().manual_seed(0))
    with pytest.raises(AssertionError, match="never forced a swap-out"):
        mod.serve_demo(mod.CFG, model, "cpu", ctx=64, gen=4, page_size=16,
                       swap_pages=16, prefill_chunk=32)


def test_quickstart_runs(capsys):
    out = _twin("torch_quickstart").main(["--device", "cpu"])
    assert np.isfinite(out["sigma_q"]) and out["sigma_q"] > 0
    assert out["had"].shape == out["fp"].shape == (2, 8)
    assert "greedy-token agreement" in capsys.readouterr().out


def test_quickstart_sigma_equals_jax():
    """Eq. 12 on the quickstart's model: the twin's estimate on JAX's
    weights and the same stream (lm_stream, seed 0, five batches) equals
    JAX's, every layer's sigma_q and sigma_k."""
    mod = _twin("torch_quickstart")
    c = mod.CFG
    jcfg = JModelConfig(
        name=c.name, family=c.family, n_layers=c.n_layers,
        d_model=c.d_model, n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
        head_dim=c.head_dim, d_ff=c.d_ff, vocab_size=c.vocab_size,
        had=JHADConfig(topn_frac=c.had.topn_frac, n_min=c.had.n_min),
        param_dtype=c.param_dtype, q_block=c.q_block, remat=c.remat)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    teacher = params_from_numpy(jax.tree.map(np.asarray, params), c)
    jdata = ({k: jnp.asarray(v) for k, v in b.items()}
             for b in jlm_stream(vocab=c.vocab_size, batch=4, seq=32,
                                 seed=0))
    want = jestimate(params, jcfg, jdata, n_batches=5)
    sq = mod.estimate_sigmas(teacher, c, mod.make_data(c, "cpu"))
    mixer = want["blocks"]["pos0"]["mixer"]
    np.testing.assert_allclose(sq, float(mixer["sigma_q"][0]), rtol=1e-5)
    for i, blk in enumerate(teacher.blocks):
        np.testing.assert_allclose(float(blk.mixer.sigma_q),
                                   float(mixer["sigma_q"][i]), rtol=1e-5)
        np.testing.assert_allclose(float(blk.mixer.sigma_k),
                                   float(mixer["sigma_k"][i]), rtol=1e-5)


def test_distill_encoder_runs(capsys):
    """The example's pipeline at reduced step counts: both accuracies on
    the 15 held-out batches."""
    out = _twin("torch_distill_encoder").run("cpu", steps_teacher=20,
                                             steps_per_stage=2)
    for k in ("teacher_acc", "student_acc"):
        assert 0.0 <= out[k] <= 1.0
        assert out[k] * 480 == int(round(out[k] * 480))
    text = capsys.readouterr().out
    assert "teacher accuracy" in text and "HAD student accuracy" in text


def test_twins_import_no_jax():
    code = ("import importlib.util, sys\n"
            f"for name in {TWINS!r}:\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        name, f'examples/{name}.py')\n"
            "    spec.loader.exec_module(\n"
            "        importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_twins_default_to_the_card():
    """Without --device cpu a twin raises on a machine with no card."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for name in TWINS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _twin(name).main([])
