"""Models, datasets and engines of the port."""
