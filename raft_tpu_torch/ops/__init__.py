"""Distances, selection and the hand-written kernels."""
