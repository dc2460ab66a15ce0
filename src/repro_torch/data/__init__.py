"""Synthetic data pipeline (counterpart of ``repro/data``)."""
