"""PyTorch/CUDA port of the multiraft-tpu batched consensus engine.

Runs beside the JAX package (``multiraft_tpu``), which stays the
reference; this package imports ``torch`` and numpy only.  Module paths
mirror the reference's: ``engine.core`` (the tick), ``engine.kernels``
(hand-written CUDA kernels and their plain versions), ``engine.host``
(the driver), ``engine.kv`` (the batched KV service) and ``convert``
(state carried across as numpy).
"""
