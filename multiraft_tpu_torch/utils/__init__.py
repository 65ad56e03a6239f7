"""Knobs, PRNG and counters used by the engine."""
