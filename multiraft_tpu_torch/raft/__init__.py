"""The event-driven single-group Raft simulator (``raft.node.RaftNode``),
its log, messages and persister: the oracle the batched engine is held
against (``conformance``)."""
