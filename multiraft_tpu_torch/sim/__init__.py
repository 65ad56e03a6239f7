"""The scheduler's future, timer and timeout primitives, shared by the
real-time serving loop (``distributed.realtime``) and the clerks."""
