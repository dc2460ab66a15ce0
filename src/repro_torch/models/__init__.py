"""Decoder models on plain PyTorch modules (counterpart of ``repro/models``)."""
