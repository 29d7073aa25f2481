"""Exact and IVF-Flat nearest-neighbour search."""
