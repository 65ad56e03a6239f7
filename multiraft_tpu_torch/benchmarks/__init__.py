"""The port's benchmark rigs (the counterparts of the repository's
top-level ``benchmarks/``): ``roofline`` (the tick's byte count and its
bound on the card) and ``scenarios`` (churn, snapshot storms, skew and
the (G, P) sweep)."""
