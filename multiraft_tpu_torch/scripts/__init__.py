"""The port's scripts (the counterparts of the repository's top-level
``scripts/``): ``bench_compare`` (a fresh result against its recorded
rounds), ``loadcurve`` (the open-loop sweep recorded as a round) and
``placement_scenario`` (the placement controller's skew, durable
failover and replica-replacement runs).  Each runs as ``python -m
multiraft_tpu_torch.scripts.<name>``."""
