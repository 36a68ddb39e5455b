"""Artifact restore (npz shards + meta.json) without JAX."""
