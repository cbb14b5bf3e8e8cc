"""Multi-device runs of the PyTorch port on torch.distributed."""
