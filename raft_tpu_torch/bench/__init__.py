"""Synthetic benchmark data."""
