"""Optimizers (``adamw``)."""
