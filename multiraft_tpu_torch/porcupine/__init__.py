"""Record types of the porcupine KV model (no checker in this package)."""
