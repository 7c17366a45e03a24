"""The port's REST server (rest.py), search micro-batcher (batcher.py),
config stack (config.py) and embedding client (embedding.py)."""
