"""Fused layers of the port."""
