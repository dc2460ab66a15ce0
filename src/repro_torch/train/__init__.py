"""Train and serve step factories, losses (counterpart of ``repro/train``)."""
