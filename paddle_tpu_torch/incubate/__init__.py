"""Incubating layers of the port."""
