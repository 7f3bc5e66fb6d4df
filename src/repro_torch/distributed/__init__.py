"""The port's multi-device layer over ``torch.distributed``: the mesh and the
collectives (``comm``), the sharding rules (``sharding``), tensor
parallelism for the STLT LM and the data-parallel loss of every arch
(``tensor_parallel``), the context-parallel STLT (``context_parallel``),
the GPipe pipeline (``pipeline``) and checkpoint-restart supervision
(``fault_tolerance``). Every rank runs one process and calls the same
functions with its own shards."""
