"""PyTorch/CUDA port of the multiraft-tpu batched consensus engine.

Runs beside the JAX package (``multiraft_tpu``), which stays the
reference; this package imports ``torch`` and numpy only.  Module paths
mirror the reference's: ``engine.core`` (the tick), ``engine.kernels``
(hand-written CUDA kernels and their plain versions), ``engine.host``
(the driver), ``engine.kv`` (the batched KV service), ``engine.shardkv``,
``engine.split`` and ``engine.split_shard`` (the sharded service and
split replica groups, with ``services.shardctrler`` and
``services.shardkv``) and ``convert`` (state carried across as numpy).
"""
