"""Serving command line of the port: requests through ``ServeEngine.serve`` on
one device (the colocated part of the JAX package's ``launch/serve.py``).

  python -m repro_torch.launch.serve --arch stlt-base --requests 8 \
      --prompt-len 512 --max-new 32 --prefill-chunk 512 --system-prompt-len 512
  python -m repro_torch.launch.serve --arch stlt-base --reduced --device cpu \
      --requests 6 --slots 3 --max-new 8 --prefill-chunk 16 --system-prompt-len 24
  python -m repro_torch.launch.serve --arch smollm-360m --variant stlt \
      --prefill-chunk 512 --spec-k 4 --spec-draft nodes --spec-draft-nodes 8
  python -m repro_torch.launch.serve --arch smollm-360m --max-len 2048 \
      --prefill-chunk 512 --spec-k 4
  python -m repro_torch.launch.serve --arch recurrentgemma-9b --variant stlt \
      --prefill-chunk 512 --max-len 4096
  python -m repro_torch.launch.serve --arch xlstm-350m --prefill-chunk 512 --spec-k 4
  python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b --variant stlt --reduced \
      --device cpu --requests 4 --slots 2 --max-new 8 --prefill-chunk 16

(with ``src`` on ``PYTHONPATH``). ``--mode continuous`` (default) is the
slot-level scheduler, ``--mode wave`` the admission-wave baseline.
``--prefill-chunk N`` admits prompts N tokens per tick, every co-pending
admission in one masked dispatch (``--sequential-admission``: one request
per tick, natural-length tails). ``--system-prompt-len K`` prepends a
shared K-token system prompt to every request, warms it into the prefix
cache and reports the prefill skipped. ``--variant native`` (default)
serves the architecture as published (``smollm-360m``: softmax attention
with RoPE and a KV cache of ``--max-len`` positions, which every request's
prompt and budget must fit; a ``local_attn`` ring, as in
``recurrentgemma-9b``, does not bound them), ``--variant stlt`` its STLT
form. For a bf16 config (every arch but ``stlt-base``), as in the JAX CLI,
the matrices of more than 65,536 elements are cast to the activation dtype;
the nodes, norms, biases, small params, the rg-LRU's and the mLSTM's conv
taps and the mLSTM's gate projections stay fp32. A MoE model routes the
tokens of each dispatch together: an expert's capacity depends on the
dispatch's token count, so a stream need not equal its request served
alone once a dispatch drops (``models/moe.py``).
``--spec-k K`` turns on speculative decoding (greedy, continuous mode; the
``--spec-*`` flags pick the draft and the adaptive window), ``--slo-degrade
16,8,4`` the node-budget ladder with its triggers ``--slo-gap-ms`` and
``--slo-queue-depth``. Runs on CUDA unless ``--device`` names another
device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as configs_lib
from repro_torch.models import transformer as T
from repro_torch.serving import PrefixCache, Request, ServeEngine
from repro_torch.utils import cast_params_for_compute, resolve_device, tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stlt-base")
    ap.add_argument("--variant", default="native", choices=["native", "stlt"],
                    help="stlt: replace the arch's attention with the STLT")
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mode", default="continuous", choices=["continuous", "wave"])
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked admission size (0 = monolithic prefill)")
    ap.add_argument("--sequential-admission", action="store_true",
                    help="one-request-per-tick chunked admission "
                         "(natural-length tails)")
    ap.add_argument("--system-prompt-len", type=int, default=0,
                    help="shared system-prompt tokens served via the prefix cache")
    ap.add_argument("--prefix-cache-capacity", type=int, default=None,
                    help="entry-count cap (default: 32 when no byte cap is set)")
    ap.add_argument("--prefix-cache-max-mb", type=float, default=0,
                    help="bytes-aware prefix-cache cap in MiB (0 = entry-count LRU)")
    ap.add_argument("--prefix-cache-ttl", type=int, default=0,
                    help="expire unpinned cache snapshots idle for this many "
                         "ticks (0 = no TTL)")
    ap.add_argument("--serve-nodes", type=int, default=0,
                    help="decode every request with only the top-m Laplace "
                         "nodes per head (0 = full S)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: verify k draft tokens per "
                         "tick in one dispatch (0 = plain greedy decode; "
                         "requires temperature 0, continuous mode)")
    ap.add_argument("--spec-draft", default="ngram", choices=["ngram", "nodes"],
                    help="draft source: prompt-lookup n-gram (host-side, "
                         "zero dispatches) or node-subset self-draft")
    ap.add_argument("--spec-draft-nodes", type=int, default=4,
                    help="top-m Laplace nodes kept per head in the "
                         "node-subset draft (--spec-draft nodes)")
    ap.add_argument("--spec-adaptive", action="store_true",
                    help="per-request adaptive draft window: shrink a "
                         "slot's k when its rolling accept rate drops "
                         "below --spec-accept-floor, restore stepwise "
                         "(requires --spec-k >= 2)")
    ap.add_argument("--spec-accept-floor", type=float, default=0.4)
    ap.add_argument("--spec-adapt-window", type=int, default=8)
    ap.add_argument("--spec-adapt-recovery", type=int, default=4)
    ap.add_argument("--slo-gap-ms", type=float, default=0.0,
                    help="SLO: degrade node budget when the wall-clock gap "
                         "between decode ticks exceeds this (0 = off)")
    ap.add_argument("--slo-queue-depth", type=int, default=0,
                    help="SLO: degrade node budget when this many requests "
                         "are still queued after admission (0 = off)")
    ap.add_argument("--slo-degrade", default="",
                    help="comma-separated node-budget ladder for SLO "
                         "degradation, e.g. '16,8,4' (requires a trigger: "
                         "--slo-gap-ms or --slo-queue-depth)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.spec_k and args.mode == "wave":
        raise SystemExit("--spec-k applies to continuous mode only (the "
                         "wave baseline decodes one token per tick)")
    if args.spec_k and args.temperature > 0:
        raise SystemExit("--spec-k requires greedy decoding (temperature 0): "
                         "the verify rule is exact for argmax streams only")
    device = resolve_device(args.device)
    cfg = configs_lib.get_config(args.arch, args.variant)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "encdec":
        raise SystemExit("enc-dec serving: see examples/translate.py")
    params = T.init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    params = cast_params_for_compute(params, cfg.act_dtype)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[serve] {cfg.name}: {n_params / 1e6:.1f}M params on {device}")

    if args.mode == "wave" and (args.prefill_chunk or args.system_prompt_len):
        # the wave baseline prefills monolithically and never consults the
        # cache: warming it would waste a prefill and report nonsense
        print("[serve] note: --prefill-chunk/--system-prompt-len apply to "
              "continuous mode only; ignored for --mode wave")
    use_cache = args.system_prompt_len and args.mode == "continuous"
    cache = None
    if use_cache:
        cache = PrefixCache(capacity=args.prefix_cache_capacity,
                            max_bytes=int(args.prefix_cache_max_mb * 2**20) or None,
                            ttl_ticks=args.prefix_cache_ttl or None)
    eng = ServeEngine(params, cfg, max_len=args.max_len,
                      temperature=args.temperature,
                      prefill_chunk=args.prefill_chunk, prefix_cache=cache,
                      serve_nodes=args.serve_nodes or None,
                      spec_k=args.spec_k, spec_draft=args.spec_draft,
                      spec_draft_nodes=args.spec_draft_nodes,
                      spec_adaptive=args.spec_adaptive,
                      spec_accept_floor=args.spec_accept_floor,
                      spec_adapt_window=args.spec_adapt_window,
                      spec_adapt_recovery=args.spec_adapt_recovery,
                      slo_gap_ms=args.slo_gap_ms, slo_queue_depth=args.slo_queue_depth,
                      slo_degrade=tuple(int(m) for m in args.slo_degrade.split(",")
                                        if m.strip()),
                      device=device)
    rng = np.random.default_rng(0)
    sys_len = args.system_prompt_len if use_cache else 0
    sys_prompt = rng.integers(3, cfg.vocab, sys_len).astype(np.int32)
    reqs = [
        Request(np.concatenate([
                    sys_prompt,
                    rng.integers(3, cfg.vocab, rng.integers(4, args.prompt_len)).astype(np.int32)]),
                args.max_new, id=i)
        for i in range(args.requests)
    ]
    if cache is not None:
        warmed = eng.warm_prefix(sys_prompt, chunk=args.prefill_chunk or None)
        print(f"[serve] prefix cache warmed: {warmed} tokens")
    t0 = time.time()
    results, stats = eng.serve(
        reqs, slots=args.slots,
        prompt_len=None if use_cache else args.prompt_len,
        mode=args.mode, return_stats=True,
        coalesce=not args.sequential_admission)
    dt = time.time() - t0
    n_tok = sum(len(v) for v in results.values())
    for rid in sorted(results):
        print(f"  req {rid}: {results[rid][:12]}{'...' if len(results[rid]) > 12 else ''}")
    lat = sorted(s["finish"] - s["arrival"] for s in stats.values())
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
    print(f"[serve] mode={args.mode}: {len(reqs)} requests, {n_tok} tokens in "
          f"{dt:.2f}s ({n_tok / max(dt, 1e-9):.1f} tok/s), "
          f"latency p50={p50} p99={p99} ticks; {eng.serve_stats}")
    if args.spec_k:
        print(f"[serve] spec: {eng.spec_stats}")
    if eng.slo_degrade:
        print(f"[serve] slo: {eng.node_stats}")
    if cache is not None:
        prefilled = sum(s["prefilled_tokens"] for s in stats.values())
        total = sum(s["prompt_tokens"] for s in stats.values())
        print(f"[serve] prefix cache: {cache.stats()}; prefilled "
              f"{prefilled}/{total} prompt tokens "
              f"({100 * (1 - prefilled / max(total, 1)):.1f}% skipped)")
    return results, stats


if __name__ == "__main__":
    main()
