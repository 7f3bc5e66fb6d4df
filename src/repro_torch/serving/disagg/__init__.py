"""Disaggregated prefill/decode fleet serving, the port of the JAX
package's ``serving/disagg``.

An STLT model's post-prompt decode state is O(S*d) whatever the prompt
length, so a prefill fleet (admission and chunked prefill, through K1) can
ship each finished prompt's state to a decode fleet for a constant number of
bytes, where a transformer ships an O(N*d) KV cache. Four modules:

* :mod:`wire`: the versioned, dtype-tagged blob of a batch-1 decode state,
  with an optional bf16 store for float32 carries and a digest the prefix
  cache shares (byte for byte the JAX package's format).
* :mod:`transport`: the message kinds (admit, handoff, gossip, steal, ...)
  over the in-process :class:`LoopbackTransport` or the multi-process
  :class:`SocketTransport`.
* :mod:`controller`: :class:`DisaggController` driving a
  :class:`PrefillEngine` and a :class:`DecodeEngine` through the engine's
  tick phases, token-exact against the colocated engine.
* :mod:`failover`: :class:`FaultSchedule` (seeded drop, duplicate, delay,
  corrupt, kill and partition) and :class:`Outbox` (at-least-once retries).

:mod:`worker` is the socket prefill worker
(``python -m repro_torch.serving.disagg.worker``).
"""
from repro_torch.serving.disagg.controller import (DecodeEngine, DisaggController,
                                                   PrefillEngine)
from repro_torch.serving.disagg.failover import FaultSchedule, Outbox, corrupt_blob
from repro_torch.serving.disagg.transport import (LoopbackTransport, Message,
                                                  SocketTransport)
from repro_torch.serving.disagg.wire import (dequantize_tree, pack_state, quantize_tree,
                                             unpack_state, wire_codec)

__all__ = [
    "pack_state", "unpack_state", "quantize_tree", "dequantize_tree",
    "wire_codec", "Message", "LoopbackTransport", "SocketTransport",
    "FaultSchedule", "Outbox", "corrupt_blob",
    "DisaggController", "PrefillEngine", "DecodeEngine",
]
