"""Depth-map rendering and PNG output for the PyTorch port."""
