"""The serving runtime: the native TCP transport and RPC node, the
real-time scheduler loop, the durable engine KV server
(``engine_server``) with its write-ahead log and checkpoint recovery,
its clerks (``engine_clerks``) and its observability, admission,
overload and wedge watchers."""
