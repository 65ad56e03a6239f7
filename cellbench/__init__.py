"""The benchmark of ``multiraft_tpu_torch``, the PyTorch and CUDA port.

``python -m cellbench.run`` runs one cell of ``BENCHMARK.json``; see
:mod:`cellbench.run`.  Configurations, traffic mixes and per-layer
metric readers are files under ``configs/``, ``traffic/`` and
``metrics/``, found by name (:mod:`cellbench.manifest`).  Nothing here
imports JAX or the JAX package ``multiraft_tpu``.
"""
