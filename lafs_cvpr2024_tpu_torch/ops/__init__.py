"""Ops: input scaling, the landmark patch gather and the LN-fused MLP."""
