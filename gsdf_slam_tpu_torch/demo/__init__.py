"""Entry points that drive the port's mapper over a dataset."""
