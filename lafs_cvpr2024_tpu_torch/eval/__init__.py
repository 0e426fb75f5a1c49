"""Checkpoint loading for the eval and serving entry points."""
