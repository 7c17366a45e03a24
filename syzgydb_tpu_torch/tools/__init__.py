"""The port's command line (cli.py) and its measurement tools (run on a
CUDA card)."""
