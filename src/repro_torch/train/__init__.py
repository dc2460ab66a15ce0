"""Serving step factories (counterpart of ``repro/train``)."""
