"""Subpackage of the PyTorch port: prompt-based audio editing (AudioLDM2 and edit-friendly DDPM inversion)."""
