"""Serving runtime of the port: weights, metrics, the streaming engine."""
