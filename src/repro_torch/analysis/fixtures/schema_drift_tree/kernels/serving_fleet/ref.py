"""Fixture JAX engine: the ev_counts stack has 4 columns for a 5-type
schema (arity-mismatch seed)."""


def _simulate(jnp, a, b, c, d):
    ev_counts = jnp.stack([a, b, c, d])  # BAD
    return ev_counts
