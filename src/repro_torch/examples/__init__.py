"""Runnable examples of the port, twins of the reference's ``examples/``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.accuracy_sweep --steps 80 [--device cpu]
"""
