"""Shape and tile helpers."""
