"""Tools of the PyTorch port."""
