"""Host-side core: schemas, fingerprinting, config (copies of the JAX package's)."""
