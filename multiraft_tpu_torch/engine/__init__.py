"""The batched engine: tick, kernels, driver, pipeline and services."""
