"""The port's benchmark rigs (the counterparts of the repository's top-level
``benchmarks/``): ``roofline`` (the tick's byte count and its bound on the
card), ``scenarios`` (churn, snapshot storms, skew and the (G, P) sweep),
``serving_throughput`` and ``serving_breakdown`` (served ops/s, the
columnar firehose, where a frame's time goes), ``openloop`` (the open-loop
rate ladder), ``split_bench`` (the split-group path) and
``transport_echo`` (serial echo RPC against the C loopback floor)."""
