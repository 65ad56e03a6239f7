"""PyTorch/CUDA port of the multiraft-tpu batched consensus engine.

Runs beside the JAX package (``multiraft_tpu``), which stays the
reference; this package imports ``torch`` and numpy only.  Module paths
mirror the reference's: ``engine.core`` (the tick), ``engine.kernels``
(hand-written CUDA kernels and their plain versions), ``engine.host``
(the driver), ``engine.kv`` (the batched KV service), ``engine.shardkv``,
``engine.split`` and ``engine.split_shard`` (the sharded service and
split replica groups, with ``services.shardctrler`` and
``services.shardkv``) and ``convert`` (state carried across as numpy).
``distributed.engine_server`` serves the batched KV over TCP from the
card, durably, to the clerks of ``distributed.engine_clerks`` or of the
reference package (one wire); ``distributed.engine_shard_server`` serves
the sharded engine (standalone or as a fleet process, with the state
plane of ``distributed.stateplane``), ``distributed.split_server`` and
``split_shard_server`` the split replica groups, and
``distributed.engine_cluster`` runs them as processes;
``python -m multiraft_tpu_torch`` is the command line (``serve-kv``,
``serve-shardkv``, ``kv``).  ``porcupine`` is the linearizability
checker (``porcupine.native``: its C++ DFS).  The per-replica stack is
the reference's, on the host: the event-driven Raft simulator
(``raft``), the labrpc network (``transport.network``), the simulated
services (``services.kvraft``, ``shardctrler``, ``shardkv``), their
harnesses (``harness``) and the config system (``utils.config``);
``conformance`` holds the engine against it, and ``engine.bench_verify``
verifies a traced headline run.
"""
