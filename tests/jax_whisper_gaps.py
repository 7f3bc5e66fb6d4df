#!/usr/bin/env python3
"""Read the JAX package's own fp32 gap between its two forms of the
whisper-base-stlt decoder, on the CPU: each greedy ``encdec_decode_step``'s
logits against ``apply_encdec`` teacher-forced on the produced tokens.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/jax_whisper_gaps.py \
        [--seeds 8] [--first-seed 0] [--layers 2 2]

whisper-base-stlt at its published widths (d_model 512, 8 heads, 32 nodes,
51,865-token vocabulary) and 1500 frames, cut to 2 + 2 layers (``--layers``
sets the encoder's and the decoder's) and batch 1, fp32, 8 greedy steps
from token 1; random weights from ``jax.random.key`` of each seed and
random frame embeddings from numpy of the same seed. This is the
independent witness for ``chip_smoke.W_FP32_STEP_TOL`` (at 2 + 2 layers)
and for how the gap grows with the decoder's depth (``--layers 2 6``): the
two forms are one function, so their gap is rounding, and at random init
the cross-STLT's sharp softmax amplifies it. It imports the JAX package
only, so it sits with the tests rather than with the port's scripts in
``tools/``. The last line is a JSON object: the gap and logit scale for
each seed.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import whisper as JW  # noqa: E402

FRAMES, STEPS = 1500, 8


def gap(cfg, seed: int) -> dict:
    params = JW.init_encdec(jax.random.key(seed), cfg)
    frames = jnp.asarray(np.random.default_rng(seed).normal(
        size=(1, FRAMES, cfg.d_model)).astype(np.float32))
    state = jax.jit(JW.init_encdec_decode_state, static_argnums=(1, 3, 4))(
        params, cfg, frames, 1, STEPS)
    step = jax.jit(JW.encdec_decode_step, static_argnums=1)
    tok, rows, toks = jnp.ones((1,), jnp.int32), [], []
    for _ in range(STEPS):
        logits, state = step(params, cfg, tok, state)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        rows.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    dec_in = np.concatenate([np.ones((1, 1), np.int32), np.stack(toks, 1)[:, :-1]], 1)
    teacher = np.asarray(jax.jit(JW.apply_encdec, static_argnums=1)(
        params, cfg, frames, jnp.asarray(dec_in)))
    stepped = np.stack(rows, 1)
    return {"seed": seed, "gap": float(np.abs(stepped - teacher).max()),
            "scale": float(np.abs(teacher).max()),
            "off_argmax": int((stepped.argmax(-1) != teacher.argmax(-1)).sum())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--layers", type=int, nargs=2, default=(2, 2))
    args = ap.parse_args()
    cfg = dataclasses.replace(get_config("whisper-base", "stlt"), num_layers=args.layers[0],
                              num_decoder_layers=args.layers[1], dtype="float32",
                              scan_layers=False, remat=False)
    out = []
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        t0 = time.time()
        out.append(gap(cfg, seed))
        print(f"seed {seed}: fp32 decode step vs teacher-forced largest logit gap "
              f"{out[-1]['gap']:.6g} (logit scale {out[-1]['scale']:.4f}, "
              f"{out[-1]['off_argmax']} of {STEPS} argmaxes differ); "
              f"{time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"jax": jax.__version__, "frames": FRAMES, "layers": list(args.layers),
                      "steps": STEPS, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
