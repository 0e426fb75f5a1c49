"""Checkpoint interop with the JAX package and the reference dialect."""
