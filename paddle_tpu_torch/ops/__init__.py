"""Operators of the port; each kernel sits beside its plain version."""
