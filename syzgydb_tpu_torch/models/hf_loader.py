"""HF-format MiniLM/BERT checkpoint loader for the on-device embedder.

Parses the HF directory layout (config.json + model.safetensors or
pytorch_model.bin + vocab.txt) with no network access and no HF library,
maps the BERT tensor names onto the bert-arch Encoder's state_dict
(models/embedder.py), and returns a WordPiece tokenizer built from the
shipped vocab.  Numerical parity with transformers.BertModel (mean-pooled,
L2-normalized: the sentence-transformers recipe) is pinned in
tests/test_torch_embedder.py.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional

import numpy as np

# -- safetensors (dependency-free reader) -----------------------------------
# Format: u64 little-endian header length, JSON header
# {name: {"dtype", "shape", "data_offsets": [lo, hi]}, "__metadata__": ...},
# then one flat byte buffer the offsets index into.

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    with open(path, "rb") as f:
        (hdr_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hdr_len).decode())
        buf = f.read()
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        raw = buf[lo:hi]
        dt = info["dtype"]
        if dt == "BF16":
            # bf16 = the high 16 bits of an f32
            u16 = np.frombuffer(raw, dtype=np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            if dt not in _ST_DTYPES:
                raise ValueError(f"unsupported safetensors dtype {dt!r}")
            arr = np.frombuffer(raw, dtype=_ST_DTYPES[dt])
        out[name] = arr.reshape(info["shape"]).copy()
    return out


def _load_torch_bin(path: str) -> dict[str, np.ndarray]:
    import torch
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(torch.float32).numpy() for k, v in state.items()}


def load_state_dict(model_dir: str) -> dict[str, np.ndarray]:
    """Weights from an HF checkpoint directory, trying safetensors first."""
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    pt = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(pt):
        return _load_torch_bin(pt)
    raise FileNotFoundError(
        f"no model.safetensors or pytorch_model.bin in {model_dir}")


# -- name/shape mapping ------------------------------------------------------


def _strip_prefix(state: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Drop a uniform 'bert.' wrapper prefix when present."""
    for prefix in ("bert.",):
        if any(k.startswith(prefix) for k in state):
            state = {k[len(prefix):] if k.startswith(prefix) else k: v
                     for k, v in state.items()}
    return state


def map_bert_params(state: dict[str, np.ndarray], cfg) -> dict:
    """HF BERT state dict -> the state_dict of Encoder(cfg, arch='bert').

    HF nn.Linear weights are (out, in), as the Encoder's Dense weights are;
    query, key and value stack into the one q/k/v Dense.  The position
    table is truncated to cfg.max_len (equivalent for sequences <=
    max_len)."""
    state = _strip_prefix(state)

    def get(name):
        if name not in state:
            raise KeyError(f"checkpoint missing tensor {name!r}")
        return np.asarray(state[name], dtype=np.float32)

    sd = {"tok.weight": get("embeddings.word_embeddings.weight"),
          "pos.weight": get("embeddings.position_embeddings.weight")
          [: cfg.max_len],
          "typ.weight": get("embeddings.token_type_embeddings.weight"),
          "emb_ln.weight": get("embeddings.LayerNorm.weight"),
          "emb_ln.bias": get("embeddings.LayerNorm.bias")}
    for i in range(cfg.layers):
        pre, out = f"encoder.layer.{i}", f"blocks.{i}"
        qkv = [f"{pre}.attention.self.{p}" for p in ("query", "key",
                                                      "value")]
        sd[f"{out}.attn.qkv.weight"] = np.concatenate(
            [get(f"{n}.weight") for n in qkv])
        sd[f"{out}.attn.qkv.bias"] = np.concatenate(
            [get(f"{n}.bias") for n in qkv])
        for ours, theirs in (("attn.out", "attention.output.dense"),
                             ("ln0", "attention.output.LayerNorm"),
                             ("fc1", "intermediate.dense"),
                             ("fc2", "output.dense"),
                             ("ln1", "output.LayerNorm")):
            sd[f"{out}.{ours}.weight"] = get(f"{pre}.{theirs}.weight")
            sd[f"{out}.{ours}.bias"] = get(f"{pre}.{theirs}.bias")
    return sd


def load_hf_minilm(model_dir: str, max_len: int = 128,
                   dtype: Optional[str] = None, device=None):
    """HF checkpoint directory -> ready TextEmbedder (bert arch, WordPiece
    tokenizer from vocab.txt) on `device`.  Raises a clean error naming
    whatever is missing or malformed."""
    from .embedder import EmbedderConfig, TextEmbedder
    from .tokenizer import WordPieceTokenizer

    cfg_path = os.path.join(model_dir, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"no config.json in {model_dir}")
    with open(cfg_path) as f:
        hf = json.load(f)
    for key in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                "intermediate_size", "vocab_size"):
        if key not in hf:
            raise ValueError(f"config.json missing {key!r} "
                             f"(not a BERT-family checkpoint?)")
    cfg = EmbedderConfig(
        vocab_size=int(hf["vocab_size"]),
        hidden=int(hf["hidden_size"]),
        layers=int(hf["num_hidden_layers"]),
        heads=int(hf["num_attention_heads"]),
        mlp_dim=int(hf["intermediate_size"]),
        max_len=min(max_len, int(hf.get("max_position_embeddings", max_len))),
        arch="bert",
        ln_eps=float(hf.get("layer_norm_eps", 1e-12)),
        dtype=dtype if dtype is not None else "bfloat16",
    )
    vocab_path = os.path.join(model_dir, "vocab.txt")
    tokenizer: Optional[WordPieceTokenizer] = None
    if os.path.exists(vocab_path):
        tokenizer = WordPieceTokenizer.from_vocab_file(vocab_path,
                                                       cfg.max_len)
    emb = TextEmbedder(cfg, seed=0, tokenizer=tokenizer, device=device)
    # load_state_dict names any tensor whose shape the config does not
    # give: a clean error, not a shape blowup inside the forward
    emb.load_state_dict(map_bert_params(load_state_dict(model_dir), cfg))
    return emb
