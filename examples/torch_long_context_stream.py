"""Ultra-long-context streaming in the PyTorch port (the paper's claim,
scaled to one machine): stream tens of thousands of tokens through an STLT
LM whose decode state is a fixed few kilobytes, so context length is
limited by wall clock, never by memory. The state's bytes are printed at
the start and at every report: they do not change.

  PYTHONPATH=src python examples/torch_long_context_stream.py --tokens 20000 [--device cpu]

Runs on CUDA unless ``--device cpu`` is given (no fallback).
"""
import argparse
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.utils import resolve_device, tree_bytes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=20_000)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--report-every", type=int, default=5000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ModelConfig(name="stream", family="lm", vocab=256, num_layers=2,
                      d_model=args.d_model, num_heads=4, num_kv_heads=4, d_ff=256,
                      mixer="stlt", stlt_nodes=32, dtype="float32", scan_layers=False,
                      remat=False)
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    state = T.init_decode_state(cfg, batch=1, max_len=args.tokens, device=dev)
    sizes = [tree_bytes(state)]
    print(f"[stream] decode state: {sizes[0] / 1024:.1f} KiB ({sizes[0]} B; constant for "
          f"any context length)")

    tok = torch.zeros((1,), dtype=torch.int64, device=dev)
    t0 = time.time()
    with torch.no_grad():
        for i in range(args.tokens):
            logits, state = T.decode_step(params, cfg, tok, state)
            tok = logits.argmax(-1)
            if (i + 1) % args.report_every == 0:
                sizes.append(tree_bytes(state))
                dt = time.time() - t0
                print(f"[stream] {i + 1} tokens, {(i + 1) / dt:.0f} tok/s, state still "
                      f"{sizes[-1] / 1024:.1f} KiB ({sizes[-1]} B)")
    print(f"[stream] done: {args.tokens} tokens in {time.time() - t0:.1f} s")
    return {"state_bytes": sizes, "state": state, "logits": logits, "token": tok}


if __name__ == "__main__":
    main()
