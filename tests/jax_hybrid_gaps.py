#!/usr/bin/env python3
"""Read the JAX package's own bf16 gap between the chunk form and the
recurrent form of the hybrid family (recurrentgemma-9b), on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/jax_hybrid_gaps.py \
        [--seeds 3] [--layers 6] [--d-model 1024]

recurrentgemma-9b's layer pattern (rglru, rglru, local_attn) cut to
``--layers`` layers, at ``--d-model`` with 4 heads (head dim 256 at 1024,
the full model's), d_ff 3 x d_model, a 8,192-token vocabulary and a window
of 64, in bf16 with the matrices cast as the serve CLI casts them; random
weights from ``jax.random.key`` of each seed, both variants (native, STLT).
From a 200-token prompt (``prefill``) it decodes 20 greedy steps
(``decode_step``), and every 5 steps feeds the same 5 tokens through
``prefill_chunk`` from the state the window started at, as phase H of
``chip_smoke.py`` does: the largest logit gap between the two forms. In
bf16 the rg-LRU's two forms differ by more than rounding: the prefill's
conv output enters the gates in fp32, the step's in bf16. This is the
independent witness for ``chip_smoke.H_GAP_CAP``. It imports the JAX
package only, so it sits with the tests rather than with the port's
scripts in ``tools/``. The last line is a JSON object: the gap and logit
scale for each variant and seed.
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
from repro.models import transformer as JT  # noqa: E402
from repro.utils import cast_params_for_compute  # noqa: E402

PROMPT, STEPS, WINDOW = 200, 20, 5


def gap(cfg, seed: int) -> dict:
    params = cast_params_for_compute(JT.init_lm(jax.random.key(seed), cfg), jnp.bfloat16)
    prompt = jnp.asarray(np.random.default_rng(seed).integers(0, cfg.vocab, (1, PROMPT)),
                         jnp.int32)
    prefill = jax.jit(JT.prefill, static_argnums=(1, 3))
    step = jax.jit(JT.decode_step, static_argnums=1)
    chunk = jax.jit(JT.prefill_chunk, static_argnums=1)
    logits, state = prefill(params, cfg, prompt, PROMPT + STEPS)
    worst, scale, start = 0.0, 0.0, None
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        if i % WINDOW == 0:
            start, toks = state, []
        toks.append(tok)
        logits, state = step(params, cfg, tok, state)
        scale = max(scale, float(jnp.abs(logits.astype(jnp.float32)).max()))
        if len(toks) == WINDOW:
            lg, _ = chunk(params, cfg, jnp.stack(toks, 1), start)
            worst = max(worst, float(jnp.abs(lg.astype(jnp.float32)
                                             - logits.astype(jnp.float32)).max()))
    return {"seed": seed, "gap": worst, "scale": scale}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--d-model", type=int, default=1024)
    args = ap.parse_args()
    out = {}
    for variant in ("native", "stlt"):
        full = get_config("recurrentgemma-9b", variant)
        cfg = dataclasses.replace(
            full, num_layers=args.layers, layer_types=full.layer_types[:args.layers],
            d_model=args.d_model, num_heads=4, d_ff=3 * args.d_model, vocab=8192,
            local_window=64, scan_layers=False, remat=False)
        out[variant] = []
        for seed in range(args.seeds):
            t0 = time.time()
            out[variant].append(gap(cfg, seed))
            print(f"{variant} seed {seed}: bf16 chunk form vs decode step largest logit gap "
                  f"{out[variant][-1]['gap']:.6g} (logit scale "
                  f"{out[variant][-1]['scale']:.4f}); {time.time() - t0:.1f} s", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
