"""Model and serving configurations (plain dataclasses; copies of ``repro/configs``)."""
