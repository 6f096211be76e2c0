"""Checkpoint loading for the PyTorch port."""
