"""Multiplier numerics: quantization, product tables, error models."""
