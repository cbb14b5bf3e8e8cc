"""analysis of the PyTorch port."""
