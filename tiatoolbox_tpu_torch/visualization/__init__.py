"""Visualization and serving: the tile server and its viewer page (host plane)."""
