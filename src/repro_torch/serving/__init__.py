"""Serving of the port: batched LM generation (``serving.engine``)."""
