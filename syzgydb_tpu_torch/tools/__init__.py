"""Measurement tools of the PyTorch/CUDA port (run on a CUDA card)."""
