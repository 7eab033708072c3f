"""Colormaps, composites and the live display server."""
