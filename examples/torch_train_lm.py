"""Train an STLT language model on the byte corpus with checkpointing and
resume, in the PyTorch port, through the training CLI's ``paper-small``
preset resized here.

The full-size invocation (the paper's ~50M-class config; a few hundred steps):
  PYTHONPATH=src python examples/torch_train_lm.py --steps 300 --d-model 512 \\
      --layers 6 --batch 16 --seq 512
Default: a ~3M model for 200 steps. Runs on CUDA unless ``--device cpu`` is
given (no fallback). A rerun with the same ``--ckpt-dir`` resumes.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.launch import train as train_lib


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--nodes", type=int, default=32)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "stlt_lm_ckpt_torch"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(train_lib.paper_small(), d_model=args.d_model,
                              num_layers=args.layers, d_ff=4 * args.d_model,
                              stlt_nodes=args.nodes)
    # route through the production training driver with the preset resized
    preset = train_lib.paper_small
    train_lib.paper_small = lambda vocab=256: cfg
    try:
        return train_lib.main(
            ["--preset", "paper-small", "--steps", str(args.steps), "--batch",
             str(args.batch), "--seq", str(args.seq), "--ckpt-dir", args.ckpt_dir,
             "--save-every", "50"] + (["--device", args.device] if args.device else []))
    finally:
        train_lib.paper_small = preset


if __name__ == "__main__":
    main()
