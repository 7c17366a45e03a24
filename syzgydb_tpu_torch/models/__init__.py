"""The port's on-device text embedder (embedder.py), its tokenizers
(tokenizer.py), its checkpoint formats (ckpt_msgpack.py for flax msgpack,
hf_loader.py for HF checkpoint directories) and the synthetic corpus and
retrieval gate of the shipped checkpoint (train_synthetic.py)."""
