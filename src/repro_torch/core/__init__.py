"""Formats, pruning and the sparse linear layer of the DeMM technique."""
