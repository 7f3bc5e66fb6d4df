"""Serving: ``ServeEngine.generate`` and continuous ``serve`` with the
prefix cache, and the disaggregated prefill/decode fleets
(``serving/disagg``)."""
from repro_torch.serving.disagg import (DisaggController, FaultSchedule,
                                        LoopbackTransport, Outbox, SocketTransport)
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.prefix_cache import PrefixCache

__all__ = ["DisaggController", "FaultSchedule", "LoopbackTransport", "Outbox",
           "PrefixCache", "Request", "ServeEngine", "SocketTransport"]
