"""Data-parallel training and evaluation across processes (one per device)."""
