"""On-device text embedding model.

A MiniLM-class transformer encoder (the shape of the reference's default
`all-minilm` Ollama model: 6 layers, 384 hidden, 12 heads) that embeds text
on the GPU next to the vector index instead of over HTTP: mean-pooled,
L2-normalized sentence vectors, with matmuls in the compute dtype (bf16 by
default).

The JAX package's flax `Encoder` is the reference, and this module follows
its arithmetic step by step, dtypes included:

- embeddings are gathered from f32 tables and cast to the compute dtype;
- a Dense layer casts its input, kernel and bias to the compute dtype and
  adds the bias to the rounded product;
- LayerNorm runs in f32 with flax's fast variance E[x^2] - E[x]^2 and
  returns f32;
- attention divides the query by sqrt(head_dim) rounded to the compute
  dtype, fills masked keys with that dtype's finfo.min (not -inf, so a row
  with no key left gives finite numbers) and takes the softmax in the
  compute dtype;
- residual sums stay in the dtype flax sums in (bf16 + bf16 in "preln";
  the f32 LayerNorm output + bf16 in "bert" after its first block).

Weights are held twice: f32 masters on the host (what checkpoints read and
write) and a copy on the embedder's device whose Dense and embedding
parameters are already cast to the compute dtype.  Checkpoints are the JAX
package's: a "SYZE" header with the config as JSON, then the flax msgpack
tree (models/ckpt_msgpack.py), so either package reads what the other
wrote.  `state_dict_from_flax` / `flax_from_state_dict` map between the
flax tree and this module's state_dict.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.collection import resolve_device
from . import ckpt_msgpack
from .tokenizer import HashingTokenizer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = ("preln", "bert")


@dataclasses.dataclass(frozen=True)
class EmbedderConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    mlp_dim: int = 1536
    max_len: int = 128
    # the compute dtype, by name ("float32" or "bfloat16"): the name a
    # checkpoint header carries
    dtype: str = "bfloat16"
    # "preln" = the repo's trained-from-scratch arch (pre-LayerNorm, tanh
    # gelu); "bert" = HF MiniLM/BERT compatibility (post-LayerNorm blocks,
    # embeddings LayerNorm + token-type table, exact gelu) so pretrained
    # checkpoints load with numerical parity (models/hf_loader)
    arch: str = "preln"
    ln_eps: float = 1e-6  # BERT checkpoints use 1e-12

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype {self.dtype!r} is not one of "
                             f"{sorted(DTYPES)}")
        if self.arch not in ARCHS:
            raise ValueError(f"arch {self.arch!r} is not one of {ARCHS}")
        if self.hidden % self.heads:
            raise ValueError(f"hidden {self.hidden} is not a multiple of "
                             f"heads {self.heads}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


class Dense(nn.Module):
    """flax Dense(dtype=dt): input, kernel and bias cast to dt, the bias
    added to the product after it is rounded to dt.  Weight in nn.Linear's
    (out, in) layout."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x, dt):
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class Embed(nn.Module):
    """flax Embed(dtype=dt): rows of the table, cast to dt."""

    def __init__(self, n: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, features))

    def forward(self, ids, dt):
        return F.embedding(ids, self.weight).to(dt)


class LayerNorm(nn.Module):
    """flax LayerNorm(dtype=float32): f32 statistics with the fast variance
    max(E[x^2] - E[x]^2, 0), f32 output."""

    def __init__(self, n: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.weight) + \
            self.bias


class Attention(nn.Module):
    """flax MultiHeadDotProductAttention over one input, q/k/v in one
    Dense of 3 * hidden outputs."""

    def __init__(self, cfg: EmbedderConfig):
        super().__init__()
        self.heads = cfg.heads
        # flax divides by sqrt(head_dim) rounded to the compute dtype
        self.scale = float(torch.tensor(math.sqrt(cfg.hidden // cfg.heads))
                           .to(cfg.torch_dtype))
        self.qkv = Dense(cfg.hidden, 3 * cfg.hidden)
        self.out = Dense(cfg.hidden, cfg.hidden)

    def forward(self, x, keep, dt):
        b, n, h = x.shape
        hd = h // self.heads
        q, k, v = self.qkv(x, dt).view(b, n, 3, self.heads, hd) \
            .permute(2, 0, 3, 1, 4).unbind(0)           # (b, heads, n, hd)
        q = q / self.scale
        s = torch.matmul(q, k.transpose(-1, -2))        # (b, heads, n, n)
        s = s.masked_fill(~keep, torch.finfo(dt).min)
        s = torch.exp(s - s.amax(-1, keepdim=True))
        w = s / s.sum(-1, keepdim=True)
        o = torch.matmul(w, v).transpose(1, 2).reshape(b, n, h)
        return self.out(o, dt)


class Block(nn.Module):
    def __init__(self, cfg: EmbedderConfig):
        super().__init__()
        self.arch = cfg.arch
        self.attn = Attention(cfg)
        self.ln0 = LayerNorm(cfg.hidden, cfg.ln_eps)
        self.fc1 = Dense(cfg.hidden, cfg.mlp_dim)
        self.fc2 = Dense(cfg.mlp_dim, cfg.hidden)
        self.ln1 = LayerNorm(cfg.hidden, cfg.ln_eps)

    def forward(self, x, keep, dt):
        if self.arch == "bert":
            # post-LN (BERT ordering): sublayer, residual, then LayerNorm
            x = self.ln0(x + self.attn(x, keep, dt))
            h = self.fc2(F.gelu(self.fc1(x, dt)), dt)
            return self.ln1(x + h)
        x = x + self.attn(self.ln0(x), keep, dt)
        h = self.fc2(F.gelu(self.fc1(self.ln1(x), dt), approximate="tanh"),
                     dt)
        return x + h


class Encoder(nn.Module):
    """ids (B, L) and mask (B, L) -> (B, hidden) f32 unit vectors."""

    def __init__(self, cfg: EmbedderConfig):
        super().__init__()
        self.cfg = cfg
        self.tok = Embed(cfg.vocab_size, cfg.hidden)
        self.pos = Embed(cfg.max_len, cfg.hidden)
        if cfg.arch == "bert":
            self.typ = Embed(2, cfg.hidden)
            self.emb_ln = LayerNorm(cfg.hidden, cfg.ln_eps)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.layers))
        if cfg.arch != "bert":
            self.final_ln = LayerNorm(cfg.hidden, cfg.ln_eps)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random weights from `gen`: embeddings and Dense kernels normal
        with std 1/sqrt(fan_in) (flax's embed and lecun scales), biases 0,
        LayerNorm scale 1 and bias 0."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Dense, Embed)):
                    fan_in = m.weight.shape[1]
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                                   / math.sqrt(fan_in))
                if isinstance(m, Dense):
                    m.bias.zero_()

    def forward(self, ids, mask):
        dt = self.cfg.torch_dtype
        x = self.tok(ids, dt) + self.pos.weight[:ids.shape[1]].to(dt)
        if self.cfg.arch == "bert":
            # single-sentence inputs: token type 0 everywhere
            x = self.emb_ln(x + self.typ.weight[0].to(dt)).to(dt)
        keep = (mask > 0)[:, None, None, :]
        for blk in self.blocks:
            x = blk(x, keep, dt)
        if self.cfg.arch != "bert":
            x = self.final_ln(x)
        # masked mean pooling -> L2 normalize (sentence-transformers recipe)
        m = mask[:, :, None]
        pooled = (x * m).sum(1) / m.sum(1).clamp_min(1.0)
        pooled = pooled.float()
        return pooled / torch.linalg.vector_norm(
            pooled, dim=-1, keepdim=True).clamp_min(1e-9)


# -- the flax parameter tree --------------------------------------------------


def _flax_shapes(cfg: EmbedderConfig) -> dict:
    """Leaf path -> shape of the JAX Encoder(cfg)'s "params" tree."""
    h, m, nh = cfg.hidden, cfg.mlp_dim, cfg.heads
    hd = h // nh
    ln = {"scale": (h,), "bias": (h,)}
    p = {"Embed_0": {"embedding": (cfg.vocab_size, h)},
         "Embed_1": {"embedding": (cfg.max_len, h)},
         "LayerNorm_0": ln}
    if cfg.arch == "bert":
        p["Embed_2"] = {"embedding": (2, h)}
    proj = {"kernel": (h, nh, hd), "bias": (nh, hd)}
    for i in range(cfg.layers):
        p[f"Block_{i}"] = {
            "MultiHeadDotProductAttention_0": {
                "query": proj, "key": proj, "value": proj,
                "out": {"kernel": (nh, hd, h), "bias": (h,)}},
            "LayerNorm_0": ln, "LayerNorm_1": ln,
            "Dense_0": {"kernel": (h, m), "bias": (m,)},
            "Dense_1": {"kernel": (m, h), "bias": (h,)}}
    return p


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True).numpy()
    return np.asarray(x, dtype=np.float32)


def state_dict_from_flax(tree: dict, cfg: EmbedderConfig) -> dict:
    """The JAX package's param tree ({"params": {...}}, numpy leaves) ->
    this module's state_dict (numpy f32).  A tree whose leaves differ from
    Encoder(cfg)'s in name or shape raises ValueError naming the leaf."""
    if not (isinstance(tree, dict) and set(tree) == {"params"}):
        raise ValueError("a flax embedder tree is a dict with the one key "
                         "'params'")
    want = dict(_flat(_flax_shapes(cfg)))
    got = dict(_flat(tree["params"]))
    for path in sorted(set(want) | set(got)):
        name = "/".join(path)
        if path not in got:
            raise ValueError(f"flax tree missing leaf params/{name} for the "
                             f"{cfg.arch} Encoder")
        if path not in want:
            raise ValueError(f"flax tree has unexpected leaf params/{name} "
                             f"for the {cfg.arch} Encoder")
        shape = tuple(np.shape(got[path]))
        if shape != want[path]:
            raise ValueError(f"flax leaf params/{name} has shape {shape}; "
                             f"the config wants {want[path]}")
    p = tree["params"]
    h = cfg.hidden
    sd = {"tok.weight": p["Embed_0"]["embedding"],
          "pos.weight": p["Embed_1"]["embedding"]}
    top_ln = "emb_ln" if cfg.arch == "bert" else "final_ln"
    sd[f"{top_ln}.weight"] = p["LayerNorm_0"]["scale"]
    sd[f"{top_ln}.bias"] = p["LayerNorm_0"]["bias"]
    if cfg.arch == "bert":
        sd["typ.weight"] = p["Embed_2"]["embedding"]
    for i in range(cfg.layers):
        b, pre = p[f"Block_{i}"], f"blocks.{i}"
        a = b["MultiHeadDotProductAttention_0"]
        qkv = ("query", "key", "value")
        sd[f"{pre}.attn.qkv.weight"] = np.concatenate(
            [_f32(a[n]["kernel"]).reshape(h, h).T for n in qkv])
        sd[f"{pre}.attn.qkv.bias"] = np.concatenate(
            [_f32(a[n]["bias"]).reshape(h) for n in qkv])
        sd[f"{pre}.attn.out.weight"] = _f32(a["out"]["kernel"]) \
            .reshape(h, h).T
        sd[f"{pre}.attn.out.bias"] = a["out"]["bias"]
        for j in (0, 1):
            sd[f"{pre}.ln{j}.weight"] = b[f"LayerNorm_{j}"]["scale"]
            sd[f"{pre}.ln{j}.bias"] = b[f"LayerNorm_{j}"]["bias"]
            sd[f"{pre}.fc{j + 1}.weight"] = _f32(b[f"Dense_{j}"]["kernel"]).T
            sd[f"{pre}.fc{j + 1}.bias"] = b[f"Dense_{j}"]["bias"]
    return {k: np.ascontiguousarray(_f32(v)) for k, v in sd.items()}


def flax_from_state_dict(sd: dict, cfg: EmbedderConfig) -> dict:
    """The inverse of state_dict_from_flax: this module's state_dict ->
    {"params": {...}} with contiguous numpy f32 leaves in flax's layouts
    and its keys in the order flax creates them, so a checkpoint written
    from it has the bytes the JAX package writes for the same weights."""
    sd = {k: _f32(v) for k, v in sd.items()}
    h, nh = cfg.hidden, cfg.heads
    hd = h // nh

    def dense(pre, kernel_shape):
        return {"kernel": np.ascontiguousarray(
                    sd[f"{pre}.weight"].T.reshape(kernel_shape)),
                "bias": sd[f"{pre}.bias"]}

    def ln(pre):
        return {"scale": sd[f"{pre}.weight"], "bias": sd[f"{pre}.bias"]}

    p = {"Embed_0": {"embedding": sd["tok.weight"]},
         "Embed_1": {"embedding": sd["pos.weight"]}}
    if cfg.arch == "bert":
        p["Embed_2"] = {"embedding": sd["typ.weight"]}
        p["LayerNorm_0"] = ln("emb_ln")
    for i in range(cfg.layers):
        pre = f"blocks.{i}"
        w = sd[f"{pre}.attn.qkv.weight"].reshape(3, h, h)
        bias = sd[f"{pre}.attn.qkv.bias"].reshape(3, nh, hd)
        attn = {n: {"kernel": np.ascontiguousarray(
                        w[j].T.reshape(h, nh, hd)), "bias": bias[j].copy()}
                for j, n in enumerate(("query", "key", "value"))}
        attn["out"] = dense(f"{pre}.attn.out", (nh, hd, h))
        mlp = {"Dense_0": dense(f"{pre}.fc1", (h, cfg.mlp_dim)),
               "Dense_1": dense(f"{pre}.fc2", (cfg.mlp_dim, h))}
        if cfg.arch == "bert":
            p[f"Block_{i}"] = {"MultiHeadDotProductAttention_0": attn,
                               "LayerNorm_0": ln(f"{pre}.ln0"), **mlp,
                               "LayerNorm_1": ln(f"{pre}.ln1")}
        else:
            p[f"Block_{i}"] = {"LayerNorm_0": ln(f"{pre}.ln0"),
                               "MultiHeadDotProductAttention_0": attn,
                               "LayerNorm_1": ln(f"{pre}.ln1"), **mlp}
    if cfg.arch != "bert":
        p["LayerNorm_0"] = ln("final_ln")
    return {"params": p}


# -- the host wrapper ----------------------------------------------------------


class TextEmbedder:
    """Tokenizer + Encoder on one device.  The device is CUDA unless the
    caller passes device="cpu" (core.collection.resolve_device): asking for
    CUDA on a host without a card raises."""

    _CKPT_MAGIC = b"SYZE"

    def __init__(self, cfg: EmbedderConfig = EmbedderConfig(), seed: int = 0,
                 tokenizer=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # WordPieceTokenizer for HF checkpoints (real vocab), hashing
        # fallback otherwise: the same batch_encode protocol
        self.tokenizer = tokenizer if tokenizer is not None else \
            HashingTokenizer(cfg.vocab_size, cfg.max_len)
        self.model = Encoder(cfg)  # f32 masters, on the host
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self._net = self._device_copy()
        # one forward at a time: request threads that each launch a
        # forward's ~330 small ops at once contend for the interpreter
        # lock and serve about half the text searches (PERF.md)
        self._forward_lock = threading.Lock()

    def _device_copy(self) -> Encoder:
        """The masters on the device, Dense and embedding parameters cast
        to the compute dtype once (the forward's casts become no-ops)."""
        net = copy.deepcopy(self.model)
        for m in net.modules():
            if isinstance(m, (Dense, Embed)):
                m.to(self.cfg.torch_dtype)
        return net.to(self.device).eval().requires_grad_(False)

    def load_state_dict(self, sd: dict) -> None:
        """Replace the weights (numpy or torch values, this module's names
        and shapes) and rebuild the device copy."""
        own = self.model.state_dict()
        if set(sd) != set(own):
            raise ValueError(
                f"state_dict keys differ: missing {sorted(set(own) - set(sd))}"
                f", unexpected {sorted(set(sd) - set(own))}")
        for k, v in own.items():
            if tuple(np.shape(sd[k])) != tuple(v.shape):
                raise ValueError(f"state_dict entry {k} has shape "
                                 f"{tuple(np.shape(sd[k]))}; the Encoder "
                                 f"wants {tuple(v.shape)}")
        self.model.load_state_dict(
            {k: torch.tensor(_f32(v)) for k, v in sd.items()})
        self._net = self._device_copy()

    def embed(self, texts: list[str]) -> np.ndarray:
        """-> (len(texts), hidden) f32 unit vectors.  Request threads may
        call it concurrently: it tokenizes in parallel and runs one
        forward at a time."""
        ids, mask = self.tokenizer.batch_encode(texts)
        # batches pad to a power of two, as the JAX package's do; padded
        # rows have an all-zero mask and are sliced off
        b = 1 << max(0, (len(texts) - 1).bit_length())
        if b != len(texts):
            ids = np.concatenate([ids, np.zeros((b - len(texts),
                                                 ids.shape[1]), ids.dtype)])
            mask = np.concatenate([mask, np.zeros((b - len(texts),
                                                   mask.shape[1]),
                                                  mask.dtype)])
        with self._forward_lock, torch.inference_mode():
            out = self._net(
                torch.from_numpy(ids.astype(np.int64)).to(self.device),
                torch.from_numpy(mask).to(self.device))
            return out[:len(texts)].cpu().numpy()

    def as_embed_text_fn(self):
        """Adapter matching the server's EmbedTextFunc seam
        (server/embedding.py) so searches and inserts embed on-device."""
        def fn(texts: list[str], use_cache: bool) -> list[list[float]]:
            return [v.tolist() for v in self.embed(texts)]
        return fn

    # -- checkpointing -------------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Self-describing checkpoint: "SYZE", the JSON config header's
        length (u32 little-endian) and the header, then the flax msgpack
        params; the JAX package's TextEmbedder.from_checkpoint reads it."""
        hdr = json.dumps(dataclasses.asdict(self.cfg)).encode()
        tree = flax_from_state_dict(self.model.state_dict(), self.cfg)
        with open(path, "wb") as f:
            f.write(self._CKPT_MAGIC)
            f.write(len(hdr).to_bytes(4, "little"))
            f.write(hdr)
            f.write(ckpt_msgpack.dumps(tree))

    @classmethod
    def from_checkpoint(cls, path: str, device=None) -> "TextEmbedder":
        """Load a save_checkpoint() file (either package's), building its
        config from the header; a DIRECTORY loads as an HF-format
        MiniLM/BERT checkpoint (models/hf_loader.py); a file without the
        header loads as raw flax msgpack params into the default config."""
        if os.path.isdir(path):
            from .hf_loader import load_hf_minilm
            return load_hf_minilm(path, device=device)
        with open(path, "rb") as f:
            blob = f.read()
        if blob[:4] != cls._CKPT_MAGIC:
            emb = cls(device=device)
            emb.load_pretrained(path)
            return emb
        n = int.from_bytes(blob[4:8], "little")
        emb = cls(EmbedderConfig(**json.loads(blob[8:8 + n].decode())),
                  device=device)
        emb.load_state_dict(state_dict_from_flax(
            ckpt_msgpack.loads(blob[8 + n:]), emb.cfg))
        return emb

    def load_pretrained(self, path: str) -> None:
        """Load checkpoint params into THIS instance's architecture: a
        save_checkpoint() file (its tree must match this config) or a raw
        flax msgpack params blob.  Without one, the embedder runs RANDOM
        weights: fine as a load or scale target, meaningless for retrieval
        (the server logs it as experimental, server/rest.py)."""
        with open(path, "rb") as f:
            blob = f.read()
        if blob[:4] == self._CKPT_MAGIC:
            n = int.from_bytes(blob[4:8], "little")
            blob = blob[8 + n:]
        self.load_state_dict(state_dict_from_flax(ckpt_msgpack.loads(blob),
                                                  self.cfg))
