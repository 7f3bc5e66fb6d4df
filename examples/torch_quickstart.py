"""Quickstart in the PyTorch port: the STLT layer as a drop-in
self-attention replacement, its interpretable nodes, streaming decode, and
the same layer inside a small LM.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on CUDA unless ``--device cpu`` is given (no fallback: without a card
the default raises).
"""
import argparse

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import half_lives, node_poles
from repro_torch.core.stlt import (STLTConfig, apply_stlt, apply_stlt_step, init_stlt,
                                   init_stlt_state)
from repro_torch.models import transformer as T
from repro_torch.utils import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=1024, help="tokens in the layer's forward")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a learnable STLT layer: 8 heads x 16 Laplace nodes s_k = sigma_k + i*omega_k
    cfg = STLTConfig(d_model=256, num_heads=8, num_nodes=16, mode="factorized")
    params = init_stlt(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)

    # 2. full-sequence forward (training): O(N * S * d), no N x N matrix anywhere
    x = torch.randn(2, args.seq, 256, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    with torch.no_grad():
        y, aux = apply_stlt(params, cfg, x)
    print(f"forward: {tuple(x.shape)} -> {tuple(y.shape)}; (Reg) loss = "
          f"{float(aux['reg']):.4f}")

    # 3. interpretability: the learned nodes have physical meaning
    lives = half_lives(params["nodes"])
    _, _, _, bandwidth = node_poles(params["nodes"])
    ranked = torch.sort(lives[0]).values
    print(f"token-relevance half-lives (head 0): {ranked[:4].tolist()} ... "
          f"{ranked[-2:].tolist()} tokens")
    print(f"window bandwidth T per head: {bandwidth.tolist()}")

    # 4. streaming decode: O(S*d) state, independent of how long the context is
    state = init_stlt_state(cfg, batch=2, device=dev)
    with torch.no_grad():
        for t in range(5):
            y_t, state = apply_stlt_step(params, cfg, x[:, t], state)
    print(f"decode step output: {tuple(y_t.shape)}; state entries: "
          f"{ {k: tuple(v.shape) for k, v in state.items()} }")

    # 5. the same layer inside a full LM (mixer='stlt')
    lm_cfg = ModelConfig(name="demo", family="lm", vocab=512, num_layers=2, d_model=128,
                         num_heads=4, num_kv_heads=4, d_ff=256, mixer="stlt",
                         stlt_nodes=16, dtype="float32", scan_layers=False, remat=False)
    lm = T.init_lm(lm_cfg, torch.Generator(device=dev).manual_seed(2), device=dev)
    tokens = torch.randint(0, 512, (1, 64), generator=torch.Generator(device=dev).manual_seed(3),
                           device=dev)
    with torch.no_grad():
        logits, _ = T.apply_lm(lm, lm_cfg, tokens)
    print(f"LM logits: {tuple(logits.shape)}")
    return {"y": y, "half_lives": lives, "T": bandwidth, "y_t": y_t, "state": state,
            "logits": logits}


if __name__ == "__main__":
    main()
