"""Speculative-decoding drafts for the serve tick, the port of the JAX
package's ``serving/speculative.py``.

The target model never changes: the engine verifies a k-token draft window
in ONE ``transformer.spec_verify`` dispatch per tick and emits every
accepted token plus the model's own bonus token, so the served stream is
the plain greedy stream whatever the draft proposes. The drafts:

* ``ngram`` (:class:`NGramDraft`): prompt lookup. Propose the tokens that
  followed the longest matching suffix n-gram earlier in the request's own
  context (prompt + emitted tokens). Host-side only, no dispatches.
* ``nodes`` (:class:`NodeDraft`): the same weights with each STLT layer's
  readout ``u`` masked to the top-m nodes per head by |u| x decay mass
  (``draft_params``). Poles and ``w_v`` are untouched, so draft states have
  the target's shapes. The draft keeps its own slot pool, decodes k greedy
  steps ahead from a checkpoint each tick, then rolls forward from that
  checkpoint by exactly the committed tokens with one masked
  ``prefill_chunk`` dispatch.

Drafts return exactly k tokens (the n-gram draft pads with its last
token); the engine caps the verified window per row by the remaining
budget.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import adaptive as adaptive_lib
from repro_torch.core import stlt as stlt_lib
from repro_torch.models import transformer as T


class NGramDraft:
    """Prompt-lookup drafting (host-side, no dispatches).

    Per slot, keeps the request's context (prompt + emitted tokens).
    ``propose`` finds the most recent earlier occurrence of the longest
    suffix n-gram (n = ``max_ngram`` down to 1) and proposes the k tokens
    that followed it; with no match, or past a short continuation, it
    repeats the last token (a mismatch only ends the accept run)."""

    def __init__(self, k: int, n_slots: int, max_ngram: int = 3):
        if k < 1:
            raise ValueError(f"k must be >= 1 (got {k})")
        self.k = k
        self.max_ngram = max_ngram
        self._ctx: list = [None] * n_slots

    def on_promote(self, g: int, prompt, t0: int):
        self._ctx[g] = list(np.asarray(prompt).tolist()) + [int(t0)]

    def on_emit(self, g: int, toks):
        self._ctx[g].extend(int(t) for t in toks)

    def propose(self, tok, live) -> np.ndarray:
        out = np.zeros((len(live), self.k), np.int32)
        for g in np.flatnonzero(live):
            out[g] = self._propose_one(self._ctx[g])
        return out

    def commit(self, inputs, commit):
        pass  # the context was extended by on_emit

    def _propose_one(self, ctx: list) -> np.ndarray:
        k = self.k
        draft = []
        n_ctx = len(ctx)
        for n in range(min(self.max_ngram, n_ctx - 1), 0, -1):
            pat = ctx[-n:]
            # most recent earlier occurrence, scanning right to left
            for i in range(n_ctx - n - 1, -1, -1):
                if ctx[i:i + n] == pat:
                    draft = ctx[i + n:i + n + k]
                    break
            if draft:
                break
        filler = draft[-1] if draft else ctx[-1]
        while len(draft) < k:
            draft.append(filler)
        return np.asarray(draft[:k], np.int32)


class AdaptiveK:
    """Per-slot adaptive draft window (engine ``spec_adaptive``).

    Tracks the drafted and accepted tokens per slot since the last change;
    once ``window`` drafted tokens are in, an accept rate below ``floor``
    halves the slot's k (k -> max(1, k // 2)) and clears the history;
    ``recovery`` consecutive healthy rounds double k back toward ``k_max``.
    The current k only caps the verified window (the per-row ``valid``
    lane): drafts still propose ``k_max`` tokens, dispatch shapes and the
    served stream do not change."""

    def __init__(self, k_max: int, n_slots: int, floor: float = 0.4,
                 window: int = 8, recovery: int = 4):
        if k_max < 2:
            raise ValueError(f"k_max must be >= 2 (got {k_max})")
        self.k_max = k_max
        self.floor = floor
        self.window = window
        self.recovery = recovery
        self._k = np.full(n_slots, k_max, np.int32)
        self._drafted = np.zeros(n_slots, np.int64)
        self._accepted = np.zeros(n_slots, np.int64)
        self._healthy = np.zeros(n_slots, np.int32)
        self._shrinks = 0
        self._restores = 0
        self._min_k = k_max

    def reset(self, g: int):
        """A new request in slot g: full k, no history."""
        self._k[g] = self.k_max
        self._drafted[g] = 0
        self._accepted[g] = 0
        self._healthy[g] = 0

    def k_for(self, g: int) -> int:
        return int(self._k[g])

    def observe(self, g: int, drafted: int, accepted: int):
        """One verify round's outcome for slot g. Rounds with no drafted
        tokens (budget-capped windows) carry no signal and are skipped."""
        if drafted <= 0:
            return
        self._drafted[g] += drafted
        self._accepted[g] += accepted
        rate = self._accepted[g] / self._drafted[g]
        if self._drafted[g] >= self.window and rate < self.floor:
            if self._k[g] > 1:
                self._k[g] = max(1, int(self._k[g]) // 2)
                self._shrinks += 1
                self._min_k = min(self._min_k, int(self._k[g]))
            self._drafted[g] = 0
            self._accepted[g] = 0
            self._healthy[g] = 0
        elif self._drafted[g] >= self.window:
            self._healthy[g] += 1
            if self._healthy[g] >= self.recovery and self._k[g] < self.k_max:
                self._k[g] = min(self.k_max, int(self._k[g]) * 2)
                self._restores += 1
                self._drafted[g] = 0
                self._accepted[g] = 0
                self._healthy[g] = 0

    def stats(self) -> dict:
        return {"adapt_shrinks": self._shrinks,
                "adapt_restores": self._restores,
                "adapt_min_k": int(self._min_k),
                "adapt_floor": self.floor,
                "adapt_window": self.window,
                "adapt_recovery": self.recovery}


def stlt_node_importance(stlt_params: dict, scfg) -> torch.Tensor:
    """Per-node importance |u| x decay mass 1 / (1 - |lambda|), [H, S]: the
    ranking the serve-time node caps use too, so a draft's top-m subset and
    a capped request's agree."""
    log_mag, _, _, _ = stlt_lib._poles(stlt_params, scfg)
    return adaptive_lib.node_importance(
        stlt_params["nodes"]["u_re"], stlt_params["nodes"]["u_im"], log_mag)


def draft_params(params: dict, cfg, draft_nodes: int) -> dict:
    """The node-subset draft model: ``params`` with each STLT layer's
    ``u_re``/``u_im`` masked to its top-``draft_nodes`` nodes per head
    (index-tie-broken, so exactly m survive even when every node ties).
    The masked mixers are new tensors; every other tensor is shared with
    ``params`` and only read."""
    scfg = cfg.stlt_config()
    m = min(draft_nodes, scfg.num_nodes)
    if m < 1:
        raise ValueError(f"draft_nodes must be >= 1 (got {draft_nodes})")
    layers = []
    for btype, lp in zip(cfg.block_types(), params["layers"]):
        if btype in ("stlt", "stlt_rel"):
            imp = stlt_node_importance(lp["stlt"], scfg)
            mask = adaptive_lib.top_m_mask(imp, m, dtype=lp["stlt"]["nodes"]["u_re"].dtype)
            nodes = dict(lp["stlt"]["nodes"])
            nodes["u_re"] = nodes["u_re"] * mask
            nodes["u_im"] = nodes["u_im"] * mask
            lp = {**lp, "stlt": {**lp["stlt"], "nodes": nodes}}
        layers.append(lp)
    return {**params, "layers": layers}


class NodeDraft:
    """Small-S node-subset self-draft, run through the engine's dispatches
    with the masked params; its dispatches count as
    ``draft_prefill_dispatches`` (one scan call per layer: the prompt's
    chunks at promote, the commit each tick) and ``draft_decode_dispatches``
    (the k look-ahead steps, no scan call).

    Invariant between ticks: the ``pool`` rows of live slots have consumed
    exactly the tokens the target pool has (prompt + committed inputs).
    ``propose`` keeps the pool as the checkpoint and decodes k steps from it
    into new tensors; ``commit`` rolls the checkpoint forward by the
    committed counts. The checkpoint is safe as a reference because
    ``decode_step`` and ``prefill_chunk`` never write their input state, and
    the one in-place write, ``insert_slot`` at promote, happens between
    ticks, never between ``propose`` and ``commit``."""

    def __init__(self, engine, k: int, n_slots: int, draft_nodes: int):
        if k < 1:
            raise ValueError(f"k must be >= 1 (got {k})")
        self.eng = engine
        self.k = k
        self.n_slots = n_slots
        self.params = draft_params(engine.params, engine.cfg, draft_nodes)
        self.pool = None   # the [n_slots] draft decode-state pool, made at first use
        self._ckpt = None  # the pool the current proposal decoded from

    def _ensure_pool(self):
        if self.pool is None:
            self.pool = T.init_decode_state(self.eng.cfg, self.n_slots,
                                            self.eng.max_len, device=self.eng.device)
        return self.pool

    def on_promote(self, g: int, prompt, t0: int):
        """Prefill the slot's prompt through the draft model (its state
        differs from the target's from layer 1 on, so a target-side prefix
        hit is still a full draft prefill), at the [1, chunk] shape of
        ``warm_prefix``, and copy it into row g."""
        eng = self.eng
        self._ensure_pool()
        prompt = np.asarray(prompt, np.int32)
        chunk = eng.prefill_chunk or len(prompt)
        st = eng._fresh_template()
        done = 0
        while done < len(prompt):
            n = min(chunk, len(prompt) - done)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :n] = prompt[done:done + n]
            _, st = eng._run_prefill_chunk(buf, st, [n], params=self.params,
                                           key="draft_prefill_dispatches")
            done += n
        T.insert_slot(self.pool, st, g, eng.cfg)

    def on_emit(self, g: int, toks):
        pass  # the state moves in commit()

    def propose(self, tok, live) -> np.ndarray:
        eng = self.eng
        pool = self._ensure_pool()
        self._ckpt = pool
        drafts = np.zeros((len(live), self.k), np.int32)
        dtok = np.asarray(tok, np.int32).copy()
        for j in range(self.k):
            logits, pool = eng._run_decode(dtok, pool, params=self.params,
                                           key="draft_decode_dispatches")
            dtok = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
            drafts[:, j] = dtok
        # the look-ahead states are dropped: commit() re-advances from the
        # checkpoint by the accepted tokens only
        return drafts

    def commit(self, inputs, commit):
        _, self.pool = self.eng._run_prefill_chunk(
            inputs, self._ckpt, commit, params=self.params,
            key="draft_prefill_dispatches")
        self._ckpt = None
