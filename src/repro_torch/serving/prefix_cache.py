"""Prefix-state cache: O(S*d) post-prefix decode states keyed by
prompt-prefix hash.

Requests that share a prompt prefix (system prompts, few-shot preambles)
re-run the same prefill. The STLT layers fold their history into a carried
O(S*d) state, so the engine can snapshot the state right after the shared
prefix and splice it into a new slot, skipping the prefix's prefill: the
cached object is S*d floats per layer whatever the prefix length.

Stored states are batch-1 decode states that the engine never writes: it
stores copies (``transformer.extract_slot`` or a prefill's fresh output) and
only reads an entry (a copy into a slot, or the input of a resumed
``prefill_chunk``), so a hit hands out the stored tensors. Eviction is LRU
and bytes-aware: each entry is sized by the nbytes of its state tensors
(+ logits); ``max_bytes`` caps the resident total and ``capacity`` the
entry count. Pinned entries (warmed system prompts) are skipped by eviction
while any unpinned victim exists. Keys are SHA-1 digests of the raw token
bytes. Two further policies on top of LRU:

* **Content-hash dedup.** States are stored in a content-addressed side
  table (one resident state per SHA-1 digest of its leaves' bytes, with
  refcounts), so identical snapshots under different prefix keys cost
  their bytes once. ``stats()`` reports ``dedup_hits`` / ``bytes_saved`` /
  ``unique_states``.
* **TTL eviction.** With ``ttl_ticks`` set, ``tick()`` (once per scheduler
  tick) expires unpinned entries not hit for more than ``ttl_ticks`` ticks.

``store_dtype="bf16"`` keeps float32 state leaves narrowed to bfloat16 at
rest (half their bytes, ``quant_bytes_saved``) and widens a hit's copy back
to float32; logits are never narrowed. ``dedup=False`` skips the content
digest (a host read of every leaf) for large attention-KV entries.

The port of the JAX package's ``serving/prefix_cache.py``, without
``ReplicatedPrefixCache`` (the sharded engine's). ``state_digest`` is the JAX
package's digest: a converted state hashes to the same bytes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import pickle
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils import jax_order, tree_leaves, tree_map


def prefix_digest(tokens) -> bytes:
    """Stable digest of a token prefix (dtype-normalized raw bytes)."""
    return hashlib.sha1(np.ascontiguousarray(tokens, np.int32).tobytes()).digest()


def pytree_nbytes(tree) -> int:
    """Total bytes of a tree's tensor and array leaves (other leaves count 0)."""
    return sum(int(getattr(leaf, "nbytes", 0)) for leaf in tree_leaves(tree))


def host_bytes(t: torch.Tensor) -> tuple:
    """(shape, numpy dtype name, raw little-endian bytes) of a tensor read to
    the host. numpy has no bfloat16: a bf16 tensor is named ``"bfloat16"``
    (the JAX package's ``ml_dtypes`` name) and gives its 16-bit patterns."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
    arr = t.numpy()
    return tuple(arr.shape), str(arr.dtype), arr.tobytes()


def quantize_tree(tree):
    """float32 leaves -> bfloat16 (idempotent; other dtypes untouched)."""
    return tree_map(lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t, tree)


def dequantize_tree(tree):
    """bfloat16 leaves -> float32 (idempotent; other dtypes untouched)."""
    return tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t, tree)


def state_digest(tree) -> bytes:
    """Content digest of a tree: SHA-1 over every leaf's shape, dtype name and
    raw bytes, in the JAX package's flatten order, so a state converted from
    the JAX package digests to the JAX package's bytes. Reads every tensor
    back to the host (cheap for O(S*d) STLT states, a real cost for an
    attention KV cache: see ``dedup``)."""
    h = hashlib.sha1()
    for leaf in tree_leaves(jax_order(tree)):
        if isinstance(leaf, torch.Tensor):
            shape, name, raw = host_bytes(leaf)
        else:
            try:
                arr = np.ascontiguousarray(np.asarray(leaf))
                shape, name, raw = arr.shape, str(arr.dtype), arr.tobytes()
            except (TypeError, ValueError):   # a non-array leaf: its value
                h.update(b"pkl:" + pickle.dumps(leaf, protocol=4))
                continue
        h.update(repr((shape, name)).encode())
        h.update(raw)
    return h.digest()


@dataclasses.dataclass
class PrefixEntry:
    n_tokens: int            # prefix length the state summarizes
    state: Any               # batch-1 decode state (post-prefix)
    logits: Any = None       # last-token logits (full-prompt entries)
    pinned: bool = False     # exempt from LRU/TTL eviction (warmed prompts)
    nbytes: int = 0          # bytes charged at insert (0 state bytes if dup)
    digest: Optional[bytes] = None  # content digest of ``state`` (None: no dedup)
    logits_nbytes: int = 0   # the logits' share of ``nbytes``
    last_used: int = 0       # cache clock at insert / last hit (TTL)


class PrefixCache:
    """Bytes-aware LRU map: prompt-prefix digest -> post-prefix state.

    ``max_bytes`` caps the total resident bytes; ``capacity`` the entry
    count (32 when neither is given); ``ttl_ticks`` expires unpinned
    entries not hit for that many ``tick()``s. Byte-identical states share
    ONE resident copy (refcounted) unless ``dedup`` is off.
    ``store_dtype="bf16"`` keeps float32 state leaves narrowed at rest.

    ``lookup`` returns the LONGEST cached prefix of a prompt, trying the
    registered entry lengths longest-first: one hash per distinct cached
    length, independent of the number of entries.
    """

    def __init__(self, capacity: Optional[int] = None,
                 max_bytes: Optional[int] = None,
                 ttl_ticks: Optional[int] = None, dedup: bool = True,
                 store_dtype: str = "f32"):
        if capacity is None and max_bytes is None:
            capacity = 32
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1 (got {max_bytes})")
        if ttl_ticks is not None and ttl_ticks < 1:
            raise ValueError(f"ttl_ticks must be >= 1 (got {ttl_ticks})")
        if store_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"store_dtype must be 'f32' or 'bf16' (got {store_dtype!r})")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self.ttl_ticks = ttl_ticks
        # "bf16": float32 state leaves are stored as bfloat16 (quantize_tree,
        # the rounding of the wire's bf16 store) and a hit hands out a
        # float32 copy; logits are never narrowed (a full-prompt hit samples
        # its first token from them).
        # Digests are of the caller's logical (unnarrowed) state.
        self.store_dtype = store_dtype
        # dedup digests every inserted state (a host read of its leaves):
        # right for O(S*d) STLT states, not for large attention-KV entries
        self.dedup = dedup
        self._entries: OrderedDict[bytes, PrefixEntry] = OrderedDict()
        # n_tokens -> entry count: lookup probes the distinct lengths only
        self._lengths: dict[int, int] = {}
        # content-addressed store: digest -> [state, nbytes, refcount]
        self._states: dict[bytes, list] = {}
        self._bytes = 0
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.dedup_hits = 0
        self.bytes_saved = 0
        self.quant_bytes_saved = 0
        self.ttl_evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        """Total resident bytes: each unique state once, plus every logits."""
        return self._bytes

    @property
    def clock(self) -> int:
        return self._clock

    # ------------------------------------------------------- state store
    def _state_ref(self, state, digest: Optional[bytes]):
        """(digest, canonical state, charged bytes): register ``state``, or
        take a reference to the resident identical one. Without dedup the
        entry owns its state (digest None, full bytes charged)."""
        if not self.dedup:
            return None, state, pytree_nbytes(state)
        if digest is None:
            digest = state_digest(state)
        rec = self._states.get(digest)
        if rec is None:
            nbytes = pytree_nbytes(state)
            self._states[digest] = [state, nbytes, 1]
            return digest, state, nbytes
        rec[2] += 1
        self.dedup_hits += 1
        self.bytes_saved += rec[1]
        return digest, rec[0], 0

    def _state_unref(self, digest: Optional[bytes]) -> int:
        """Drop one reference; returns the bytes freed (0 while refs remain)."""
        if digest is None:
            return 0
        rec = self._states[digest]
        rec[2] -= 1
        if rec[2] == 0:
            del self._states[digest]
            return rec[1]
        return 0

    # ---------------------------------------------------------- core ops
    def _over_cap(self) -> bool:
        if self.capacity is not None and len(self._entries) > self.capacity:
            return True
        return self.max_bytes is not None and self._bytes > self.max_bytes

    def _drop(self, key: bytes) -> None:
        entry = self._entries.pop(key)
        n = entry.n_tokens
        if self._lengths[n] == 1:
            del self._lengths[n]
        else:
            self._lengths[n] -= 1
        if entry.digest is None:   # no dedup: the entry owns its state bytes
            self._bytes -= entry.nbytes
            return
        self._bytes -= entry.logits_nbytes
        self._bytes -= self._state_unref(entry.digest)

    def insert(self, tokens, state, logits=None, pinned: bool = False,
               digest: Optional[bytes] = None) -> None:
        """Register the post-prefix state for ``tokens`` (a full prefix).

        ``pinned`` entries are exempt from eviction while an unpinned victim
        exists. A single entry larger than ``max_bytes`` is still admitted
        and becomes the sole resident. ``digest``: the state's
        ``state_digest`` when the caller has it (a state unpacked from a
        wire blob carries it), so the leaves are not read again."""
        tokens = np.asarray(tokens, np.int32)
        key = prefix_digest(tokens)
        if key in self._entries:
            old = self._entries[key]
            if logits is None:  # keep a richer (logits-bearing) entry
                logits = old.logits
            pinned = pinned or old.pinned
            self._drop(key)
        logical_nbytes = 0
        if self.store_dtype == "bf16":
            if digest is None and self.dedup:
                # the logical content's digest, so a state inserted as f32
                # and the same state unpacked from a blob share one key
                digest = state_digest(state)
            logical_nbytes = pytree_nbytes(state)
            state = quantize_tree(state)
        digest, state, state_bytes = self._state_ref(state, digest)
        if logical_nbytes and state_bytes:   # newly resident, not a dup ref
            self.quant_bytes_saved += logical_nbytes - state_bytes
        logits_bytes = pytree_nbytes(logits)
        self._entries[key] = PrefixEntry(
            int(tokens.size), state, logits, pinned,
            nbytes=state_bytes + logits_bytes, digest=digest,
            logits_nbytes=logits_bytes, last_used=self._clock)
        self._lengths[int(tokens.size)] = self._lengths.get(int(tokens.size), 0) + 1
        self._bytes += state_bytes + logits_bytes
        while self._over_cap() and len(self._entries) > 1:
            victim = next((k for k, e in self._entries.items()
                           if not e.pinned and k != key), None)
            if victim is None:  # all pinned: evict true-LRU rather than grow
                victim = next(k for k in self._entries if k != key)
            self._drop(victim)

    def lookup(self, prompt) -> Optional[PrefixEntry]:
        """Longest cached prefix of ``prompt`` (None on a miss). LRU-refreshes,
        restamps the TTL clock and counts a hit or a miss. With the bf16
        store the entry handed out holds a float32 copy of the state."""
        prompt = np.asarray(prompt, np.int32)
        lengths = sorted((n for n in self._lengths if n <= prompt.size),
                         reverse=True)
        for n in lengths:
            key = prefix_digest(prompt[:n])
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                entry.last_used = self._clock
                self.hits += 1
                if self.store_dtype == "bf16":
                    return dataclasses.replace(entry, state=dequantize_tree(entry.state))
                return entry
        self.misses += 1
        return None

    def tick(self, n: int = 1) -> int:
        """Advance the TTL clock by ``n`` ticks and expire unpinned entries
        idle for more than ``ttl_ticks``; returns how many expired."""
        self._clock += n
        if self.ttl_ticks is None:
            return 0
        expired = [k for k, e in self._entries.items()
                   if not e.pinned and self._clock - e.last_used > self.ttl_ticks]
        for k in expired:
            self._drop(k)
        self.ttl_evictions += len(expired)
        return len(expired)

    def clear(self) -> int:
        """Drop every entry, pinned ones too, and every resident state (a
        disaggregated prefill host that died lost its memory); the counters
        stay. Returns the entries dropped."""
        n = len(self._entries)
        self._entries.clear()
        self._lengths.clear()
        self._states.clear()
        self._bytes = 0
        return n

    def stats(self) -> dict:
        return {"entries": len(self._entries), "bytes": self._bytes,
                "hits": self.hits, "misses": self.misses,
                "pinned": sum(e.pinned for e in self._entries.values()),
                "unique_states": len(self._states),
                "dedup_hits": self.dedup_hits,
                "bytes_saved": self.bytes_saved,
                "store_dtype": self.store_dtype,
                "quant_bytes_saved": self.quant_bytes_saved,
                "ttl_evictions": self.ttl_evictions,
                "clock": self._clock}
