"""Neural-net primitives and the Hopper kernels of the PyTorch port."""
