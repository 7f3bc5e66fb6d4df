"""Serving: ``ServeEngine.generate`` and continuous ``serve`` with the
prefix cache, the sharded engine over a serve mesh
(``serving/multihost.py``), and the disaggregated prefill/decode fleets
(``serving/disagg``)."""
from repro_torch.serving.disagg import (DisaggController, FaultSchedule,
                                        LoopbackTransport, Outbox, SocketTransport)
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.multihost import ShardedServeEngine, make_serve_mesh
from repro_torch.serving.prefix_cache import PrefixCache, ReplicatedPrefixCache

__all__ = ["DisaggController", "FaultSchedule", "LoopbackTransport", "Outbox",
           "PrefixCache", "ReplicatedPrefixCache", "Request", "ServeEngine",
           "ShardedServeEngine", "SocketTransport", "make_serve_mesh"]
