"""Serving command line of the port: requests through ``ServeEngine.serve`` on
one device, or through the disaggregated prefill/decode fleets (the JAX
package's ``launch/serve.py`` without its sharded ``--mesh-data``).

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

``--role disagg`` serves through ``serving.disagg.DisaggController``:
``--prefill-hosts``/``--decode-hosts`` size the two fleets (``--slots``
rows each) on the one device, each finished prompt's state ships to the
decode fleet as an O(S*d) wire blob (flat in prompt length; ``--wire-store
bf16`` narrows its float32 carries, ``--wire-compress zstd`` deflates it),
``--steal-threshold`` turns on cross-role work stealing and
``--chaos-seed`` injects a seeded message-fault schedule; the report block
prints the handoff bytes per request, steals, gossip, the fleet clocks,
the transport's messages and the fault counters. ``--role controller
--listen HOST:PORT --workers N`` waits for N socket prefill workers instead
of prefilling in process; start each with ``--role prefill --connect
HOST:PORT [--worker-name prefill/1]`` (the model config and init seed
cross the wire, weights never do):

  python -m repro_torch.launch.serve --arch smollm-360m --variant stlt --role disagg \
      --prefill-hosts 2 --decode-hosts 2 --slots 2 --prefill-chunk 512 \
      --prompt-len 1024 --wire-store bf16
  python -m repro_torch.launch.serve --arch smollm-360m --variant stlt \
      --role controller --listen 127.0.0.1:18631 --workers 1 --prefill-chunk 512 &
  python -m repro_torch.launch.serve --role prefill --connect 127.0.0.1:18631
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as configs_lib
from repro_torch.models import transformer as T
from repro_torch.serving import (DisaggController, FaultSchedule, PrefixCache, Request,
                                 ServeEngine)
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
    ap.add_argument("--role", default="colocated",
                    choices=["colocated", "disagg", "controller", "prefill"],
                    help="colocated: one engine (default). disagg: prefill and "
                         "decode fleets over an in-process transport. "
                         "controller: disagg with socket prefill workers "
                         "(--listen, --workers). prefill: one worker (--connect)")
    ap.add_argument("--prefill-hosts", type=int, default=1)
    ap.add_argument("--decode-hosts", type=int, default=1)
    ap.add_argument("--steal-threshold", type=int, default=0,
                    help="steal queued prefill work onto idle decode hosts "
                         "when the unadmitted backlog reaches this (0 = off)")
    ap.add_argument("--wire-store", default="f32", choices=["f32", "bf16"],
                    help="handoff state dtype on the wire (bf16 halves the "
                         "float32 carries; logits always cross as float32)")
    ap.add_argument("--wire-compress", default="", choices=["", "zstd"],
                    help="compress handoff blobs (zstd, or zlib where the "
                         "zstandard module is absent)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="inject a seeded message-fault schedule (drop, dup, "
                         "delay, corrupt) into the disagg transport; streams "
                         "stay token-exact")
    ap.add_argument("--listen", default="127.0.0.1:18631",
                    help="controller bind address (--role controller)")
    ap.add_argument("--connect", default="127.0.0.1:18631",
                    help="controller address (--role prefill)")
    ap.add_argument("--worker-name", default="prefill/0")
    ap.add_argument("--workers", type=int, default=1,
                    help="remote prefill workers to wait for (--role controller)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.role == "prefill":
        # a worker builds everything from the controller's config message
        from repro_torch.serving.disagg import worker
        worker.main(["--connect", args.connect, "--name", args.worker_name]
                    + (["--device", args.device] if args.device else []))
        return None
    disagg = args.role in ("disagg", "controller")
    if disagg and args.mode == "wave":
        raise SystemExit("--role disagg serves continuous mode only")

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
    cache_kw = dict(capacity=args.prefix_cache_capacity,
                    max_bytes=int(args.prefix_cache_max_mb * 2**20) or None,
                    ttl_ticks=args.prefix_cache_ttl or None,
                    # the content digest reads every leaf back: right for
                    # O(S*d) STLT states, not for KV-cache entries
                    dedup=not any(bt in ("attn", "local_attn") for bt in cfg.block_types()))
    engine_kw = dict(serve_nodes=args.serve_nodes or None,
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
    cache = ctl = remote = None
    if disagg:
        transport = None
        if args.role == "controller":
            if use_cache:
                raise SystemExit("--system-prompt-len with remote prefill workers is not "
                                 "supported yet (warm_prefix does not cross the wire)")
            transport, remote = _connect_workers(args, cfg)
        ctl = DisaggController(
            params, cfg, n_prefill=args.prefill_hosts, n_decode=args.decode_hosts,
            slots=args.slots, max_len=args.max_len, temperature=args.temperature,
            prefill_chunk=args.prefill_chunk or 64, transport=transport,
            steal_threshold=args.steal_threshold, wire_store=args.wire_store,
            wire_compress=args.wire_compress or None,
            faults=(None if args.chaos_seed is None else
                    FaultSchedule(args.chaos_seed, drop=0.05, dup=0.05, delay=0.05,
                                  corrupt=0.05)),
            prefix_cache_factory=(lambda: PrefixCache(**cache_kw)) if use_cache else None,
            remote_prefill=remote, **engine_kw)
        eng = ctl.decode
        if use_cache:
            cache = ctl.prefill.caches[0]
        print(f"[serve] disagg: {args.prefill_hosts} prefill x {args.decode_hosts} decode "
              f"hosts ({args.slots} slots each), wire={args.wire_store}"
              + (f"+{args.wire_compress}" if args.wire_compress else "")
              + (f", chaos seed={args.chaos_seed}" if args.chaos_seed is not None else ""))
    else:
        if use_cache:
            cache = PrefixCache(**cache_kw)
        eng = ServeEngine(params, cfg, max_len=args.max_len, temperature=args.temperature,
                          prefill_chunk=args.prefill_chunk, prefix_cache=cache, **engine_kw)
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
        warmed = (ctl or eng).warm_prefix(sys_prompt, chunk=args.prefill_chunk or None)
        print(f"[serve] prefix cache warmed: {warmed} tokens")
    t0 = time.time()
    if ctl is not None:
        results, stats = ctl.serve(reqs, return_stats=True)
    else:
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
    if ctl is not None:
        _report(ctl, args, remote)
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


def _connect_workers(args, cfg):
    """Listen for ``--workers`` socket prefill workers and send each the
    model config and init seed; returns (transport, worker names)."""
    from repro_torch.serving.disagg.transport import Message, SocketTransport
    from repro_torch.serving.disagg.worker import cfg_to_wire

    host, port = args.listen.rsplit(":", 1)
    transport = SocketTransport("controller", listen=(host, int(port)))
    names: list[str] = []
    deadline = time.monotonic() + 120
    while len(names) < args.workers and time.monotonic() < deadline:
        names += [m.src for m in transport.recv("controller", timeout=0.2) if m.kind == "hello"]
    if len(names) < args.workers:
        transport.close()
        raise SystemExit(f"only {len(names)}/{args.workers} prefill workers connected")
    payload = {"cfg": cfg_to_wire(cfg), "seed": 0, "max_len": args.max_len,
               "prefill_chunk": args.prefill_chunk or 64, "slots": args.slots,
               "prompt_len": None, "wire_store": args.wire_store,
               "wire_compress": args.wire_compress or None}
    for n in names:
        transport.send(Message("config", "controller", n, payload))
    print(f"[serve] controller: remote prefill workers {names}")
    return transport, names


def _report(ctl, args, remote):
    """The disaggregated serve's report block; says goodbye to remote workers."""
    rep = ctl.report()
    print(f"[serve] disagg role={args.role}: {rep['handoff_requests']} handoffs, "
          f"bytes/request [{rep['handoff_bytes_min']}, {rep['handoff_bytes_max']}] "
          + ("(compressed) " if args.wire_compress else "(flat in prompt length) ")
          + f"steals={rep['steal_count']}, gossip sent={rep['gossip_sent']} "
          f"hit-rate={rep['gossip_hit_rate']}")
    print(f"[serve] fleet clocks: prefill={rep['prefill_clock_s']} "
          f"decode={rep['decode_clock_s']} s; prefill dispatches "
          f"{None if ctl.prefill is None else ctl.prefill.serve_stats}; "
          f"transport msgs={rep['transport']['msgs']}")
    fs = rep["fault_stats"]
    if fs["detected_failures"] or fs["retries"] or any(fs["injected"].values()):
        print(f"[serve] faults: injected={fs['injected']} "
              f"detected={fs['detected_failures']} recovered={fs['recovered_requests']} "
              f"requeued-tokens={fs['requeued_tokens']} "
              f"corrupt-rejected={fs['corrupt_blobs_rejected']} "
              f"dups-ignored={fs['dup_msgs_ignored']} retries={fs['retries']} "
              f"degraded={fs['degraded_colocated']}")
    if remote:
        from repro_torch.serving.disagg.transport import Message
        for n in remote:
            ctl.transport.send(Message("bye", "controller", n, {}))
        ctl.transport.close()


if __name__ == "__main__":
    main()
