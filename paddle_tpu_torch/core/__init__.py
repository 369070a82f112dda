"""Core state and dtype tables of the PyTorch port."""
