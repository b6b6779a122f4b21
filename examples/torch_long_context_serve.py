"""Long-context continuous-batching serving with the HAD binary K cache, on
the PyTorch port (the twin of ``examples/long_context_serve.py``: same
flags, sizes and seeds, same checks).

Mixed prompt lengths share one ragged decode batch, a late-arriving
request re-fills a freed slot mid-stream, the K cache is stored
bit-packed (16x smaller than bf16), and attention reads only ~N of the
context's V rows. Checked: the binarized scheduler reproduces (a) the
dense +-1 evaluation path and (b) one-request-at-a-time sequential
serving.

Run:  PYTHONPATH=src python examples/torch_long_context_serve.py \\
          [--paged] [--prefix-cache] [--swap-pages N] [--page-topn N] \\
          [--device cpu]

--paged serves from the paged KV cache: one shared pool of fixed-size
pages addressed per slot through a block table -- same tokens, checked.
--prefix-cache (implies --paged) serves a second wave sharing the first
wave's contexts from the content-addressed page index; its tokens must
equal the first wave's. --swap-pages N (implies --paged) undersizes the
pool so that pool pressure evicts a resident to an N-page host swap pool
and restores it verbatim; a swap-out must happen. --page-topn N (implies
--paged) decodes page-sparse: full coverage must equal the dense walk,
then the top-N run shows the traffic / quality trade.

The card is the default (``--device cuda``; with no card it raises).
`serve_demo` takes the config, the weights and the sizes (the JAX
example's as defaults), so a caller can pass JAX's weights converted with
``repro_torch.checkpoint.params_from_numpy`` and a shorter context.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import hamming
from repro_torch.models import transformer as T
from repro_torch.models.config import HADConfig, ModelConfig
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.paged import pages_needed
from repro_torch.serve.runner import resolve_device

CTX, GEN = 512, 12

CFG = ModelConfig(
    name="long-serve", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256,
    had=HADConfig(topn_frac=0.117, n_min=8),
    param_dtype="float32", q_block=64, remat=False)


def serve_demo(cfg: ModelConfig, model: T.Transformer, device, *,
               ctx: int = CTX, gen: int = GEN, paged: bool = False,
               page_size: int = 64, prefix_cache: bool = False,
               swap_pages: int = 0, page_topn: int = 0,
               prefill_chunk: int = 128, seed: int = 1) -> dict:
    """The example's run; raises AssertionError where a check fails.
    Returns the first wave's tokens by request and the engine's stats."""
    paged = paged or prefix_cache or bool(swap_pages) or bool(page_topn)
    n = cfg.had.topn(ctx + gen)
    print(f"context {ctx}, top-N {n} "
          f"({100 * n / (ctx + gen):.1f}% of keys attended)")

    # cache byte accounting (per layer)
    w = hamming.packed_words(cfg.dh)
    k_fp = ctx * cfg.n_kv_heads * cfg.dh * 2
    k_bits = ctx * cfg.n_kv_heads * w * 4
    print(f"K cache/layer: bf16 {k_fp / 1024:.0f} KiB -> packed "
          f"{k_bits / 1024:.0f} KiB ({k_fp / k_bits:.0f}x smaller)")

    # three requests with DIFFERENT context lengths; the third arrives late
    rng = np.random.default_rng(seed)
    lens = [ctx, ctx // 2, ctx // 4]
    prompts = [rng.integers(0, cfg.vocab_size, size=s) for s in lens]

    def engine(**kw):
        base = dict(max_len=ctx + gen, batch_slots=2, binary=True,
                    prefill_chunk=prefill_chunk)
        return Engine(cfg, model, ServeConfig(**{**base, **kw}),
                      device=device)

    # --swap-pages: undersize the device pool so the demo preempts (the
    # two first-wave prompts alone overflow it), with host swap space
    # absorbing the evictions instead of recompute
    n_pages = None
    if swap_pages:
        need = pages_needed(ctx + gen, page_size)
        n_pages = max(need, (2 * need * 2) // 3)
    eng = engine(paged=paged, page_size=page_size, n_pages=n_pages,
                 prefix_cache=prefix_cache, swap_pages=swap_pages)
    if paged:
        a = eng.allocator
        print(f"paged KV cache: {a.n_pages} pages x {a.page_size} tokens "
              f"(block table [{eng.scfg.batch_slots}, {eng.max_blocks}])")
    ids = [eng.submit(p, max_new_tokens=gen) for p in prompts[:2]]
    results = {}
    for _ in range(3):                  # two residents decode a few steps...
        for fr in eng.step():
            results[fr.request_id] = fr.tokens
    ids.append(eng.submit(prompts[2], max_new_tokens=gen))  # ...one more
    results.update(eng.run())
    print(f"mixed-length generations ({lens=}):")
    for rid, s in zip(ids, lens):
        print(f"  req {rid} (ctx {s}): {results[rid].tolist()}")
    if paged:
        a = eng.allocator
        print(f"pool watermark: {a.peak_in_use}/{a.n_pages} pages "
              f"({a.peak_in_use * a.page_size} tokens resident at peak vs "
              f"{eng.scfg.batch_slots * eng.scfg.max_len} dense-reserved)")
    stats = dict(eng.stats)
    if swap_pages:
        assert eng.stats["swap_outs"] > 0, \
            "undersized pool never forced a swap-out"
        print(f"swap-out preemption: {eng.stats['swap_outs']} evictions to "
              f"the host pool (peak {eng.swap.peak_in_use}/"
              f"{eng.swap.capacity} pages), {eng.stats['swapped_tokens']} "
              f"tok restored verbatim, {eng.stats['replayed_tokens']} tok "
              f"re-prefilled, {eng.stats['swap_out_bytes']} B out / "
              f"{eng.stats['swap_in_bytes']} B in — generations still "
              f"sequential-identical (checked below) ✓")

    # prefix caching: a repeat wave sharing the same long contexts
    # prefills only its unmatched tail -- and must generate the SAME tokens
    if prefix_cache:
        cold_prefill = eng.stats["prefill_tokens"]
        eng.reset_stats()
        wave2 = [eng.submit(p, max_new_tokens=gen) for p in prompts]
        repeats = eng.run()
        for rid, first_rid in zip(wave2, ids):
            assert (repeats[rid] == results[first_rid]).all(), \
                "cached-prefix serving != cold serving"
        print(f"prefix cache: repeat wave prefilled "
              f"{eng.stats['prefill_tokens']} tok vs {cold_prefill} cold "
              f"({eng.stats['cached_tokens']} tok served from cached pages, "
              f"{eng.prefix.hits} page hits) — tokens bit-identical ✓")

    # page-sparse decode: full-coverage N must be bit-identical to the
    # dense walk; the requested (aggressive) N shows the traffic/quality
    # trade
    if page_topn:
        def sparse_run(ptn):
            e = engine(paged=True, page_size=page_size, page_topn=ptn)
            rids = [e.submit(p, max_new_tokens=gen) for p in prompts]
            out = e.run()
            return [out[r] for r in rids], dict(e.stats)

        dense_toks, dense_st = sparse_run(None)
        full_toks, _ = sparse_run(eng.max_blocks)    # N covers every page
        for a_, b_ in zip(dense_toks, full_toks):
            assert (a_ == b_).all(), "full-coverage page-topn != dense walk"
        sparse_toks, sparse_st = sparse_run(page_topn)
        total = sum(len(t) for t in dense_toks)
        match = sum(int(x == y) for a_, b_ in zip(dense_toks, sparse_toks)
                    for x, y in zip(a_, b_))
        print(f"page-sparse decode: top-{eng.max_blocks} (all pages) "
              f"bit-identical to dense ✓; top-{page_topn} attends "
              f"{sparse_st['decode_pages_touched']} pages vs "
              f"{dense_st['decode_pages_touched']} dense "
              f"(~{sparse_st['decode_hbm_bytes']} vs "
              f"{dense_st['decode_hbm_bytes']} B KV read), "
              f"{match}/{total} tokens match")

    # cross-check 1: the dense +-1 evaluation path agrees on the first token
    with torch.no_grad():
        for rid, p in zip(ids, prompts):
            tokens = torch.as_tensor(p[None], dtype=torch.int32,
                                     device=device)
            full = T.forward(model, {"tokens": tokens}, cfg=cfg,
                             mode="had_eval", att={"n": n})
            first = int(torch.argmax(full.logits[0, -1, :cfg.vocab_size]))
            assert results[rid][0] == first, "packed path != dense ±1 path"
    print("packed-bit ragged serving == dense ±1 evaluation path ✓")

    # cross-check 2: one-request-at-a-time sequential serving agrees exactly
    for rid, p in zip(ids, prompts):
        solo = engine(batch_slots=1)
        sid = solo.submit(p, max_new_tokens=gen)
        ref = solo.run()[sid]
        assert (ref == results[rid]).all(), \
            "ragged batch != sequential serving"
    print("ragged continuous batching == sequential single-request "
          "serving ✓")
    return {"tokens": [results[rid] for rid in ids], "stats": stats}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (block tables) instead of dense")
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="automatic prefix caching (implies --paged): "
                         "repeat requests reuse their predecessors' KV pages")
    ap.add_argument("--swap-pages", type=int, default=0,
                    help="page-aligned swap-out preemption (implies "
                         "--paged): overcommits the pool and parks evicted "
                         "residents' pages in an N-page host pool")
    ap.add_argument("--page-topn", type=int, default=0,
                    help="two-phase page-sparse decode (implies --paged): "
                         "attend only the top-N pages plus the frontier")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = T.init_params(CFG, torch.Generator().manual_seed(0),
                          device=device)
    return serve_demo(CFG, model, device, paged=args.paged,
                      page_size=args.page_size,
                      prefix_cache=args.prefix_cache,
                      swap_pages=args.swap_pages, page_topn=args.page_topn)


if __name__ == "__main__":
    main()
