"""Serving in the PyTorch port: batched requests through the
continuous-batching engine with an STLT model (O(S*d) state per sequence),
then the same shape of trace through the disaggregated prefill/decode
fleets, whose handoff states cross the role boundary as O(S*d) wire blobs,
flat in prompt length.

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu --reduced]

Runs on CUDA unless ``--device cpu`` is given (no fallback).
"""
import argparse

from repro_torch.launch import serve as serve_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--reduced", action="store_true", help="smoke-size stlt-base")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    common = ["--requests", str(args.requests), "--max-new", str(args.max_new)]
    common += ["--reduced"] if args.reduced else []
    common += ["--device", args.device] if args.device else []
    colocated = serve_lib.main(common + ["--slots", "4"])
    disagg = serve_lib.main(common + ["--slots", "2", "--role", "disagg", "--prefill-hosts",
                                      "2", "--decode-hosts", "2", "--prefill-chunk", "16",
                                      "--system-prompt-len", "32", "--wire-store", "bf16"])
    return colocated, disagg


if __name__ == "__main__":
    main()
