"""Analytical model, graphs, design space and search of the PyTorch port."""
