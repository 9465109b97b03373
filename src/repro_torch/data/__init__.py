"""Synthetic-token data pipeline (``pipeline``)."""
