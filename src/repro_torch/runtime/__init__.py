"""Fault-tolerant training loop (counterpart of ``repro/runtime``)."""
