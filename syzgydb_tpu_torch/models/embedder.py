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

Weights are held twice: f32 masters (what checkpoints read and write and
what training steps) and a serving copy on the embedder's device whose
Dense and embedding parameters are already cast to the compute dtype.
Checkpoints are the JAX package's: a "SYZE" header with the config as
JSON, then the flax msgpack tree (models/ckpt_msgpack.py), so either
package reads what the other wrote.  `state_dict_from_flax` /
`flax_from_state_dict` map between the flax tree and this module's
state_dict.

Training (`contrastive_loss`, `train_step`, `make_optimizer`) runs autograd
through the same Encoder on the f32 masters: a Dense layer casts its f32
weight to the compute dtype inside the forward, so the gradients land in
f32, as the JAX package's do.  `TextEmbedder.train_model()` hands out the
masters on the embedder's device and `refresh()` rebuilds the serving copy
from them after the steps.  On a device mesh (parallel/mesh.py),
`embedder_shardings` splits the MLP and attention projections over the
feature axis, `ShardedEncoder` holds the split masters, and
`train_step_sharded` is `train_step` with the batch split over the data
axis (the JAX package's `embedder_shardings` under GSPMD).
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
from ..ops.distance import full_f32
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


def _dense(x, weight, bias, dt):
    """flax Dense(dtype=dt)'s arithmetic; bias None leaves it out (a
    feature shard's partial product, whose bias is added after the sum)."""
    y = F.linear(x.to(dt), weight.to(dt))
    return y if bias is None else y + bias.to(dt)


def _layer_norm(x, weight, bias, eps: float):
    """flax LayerNorm(dtype=float32)'s arithmetic."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * (torch.rsqrt(var + eps) * weight) + bias


def _attention_scale(cfg) -> float:
    """flax divides by sqrt(head_dim) rounded to the compute dtype."""
    return float(torch.tensor(math.sqrt(cfg.hidden // cfg.heads))
                 .to(cfg.torch_dtype))


def _attend(qkv, keep, heads: int, scale: float, dt):
    """Attention over the (b, n, 3 * heads * hd) output of the q/k/v Dense
    -> (b, n, heads * hd), masked keys filled with dt's finfo.min."""
    b, n, width = qkv.shape
    hd = width // (3 * heads)
    q, k, v = qkv.view(b, n, 3, heads, hd) \
        .permute(2, 0, 3, 1, 4).unbind(0)               # (b, heads, n, hd)
    q = q / scale
    s = torch.matmul(q, k.transpose(-1, -2))            # (b, heads, n, n)
    s = s.masked_fill(~keep, torch.finfo(dt).min)
    s = torch.exp(s - s.amax(-1, keepdim=True))
    w = s / s.sum(-1, keepdim=True)
    return torch.matmul(w, v).transpose(1, 2).reshape(b, n, heads * hd)


def _pool(x, mask):
    """Masked mean pooling -> L2 normalize (sentence-transformers recipe)."""
    m = mask[:, :, None]
    pooled = (x * m).sum(1) / m.sum(1).clamp_min(1.0)
    pooled = pooled.float()
    return pooled / torch.linalg.vector_norm(
        pooled, dim=-1, keepdim=True).clamp_min(1e-9)


class Dense(nn.Module):
    """flax Dense(dtype=dt): input, kernel and bias cast to dt, the bias
    added to the product after it is rounded to dt.  Weight in nn.Linear's
    (out, in) layout."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x, dt):
        return _dense(x, self.weight, self.bias, dt)


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
        return _layer_norm(x, self.weight, self.bias, self.eps)


class Attention(nn.Module):
    """flax MultiHeadDotProductAttention over one input, q/k/v in one
    Dense of 3 * hidden outputs."""

    def __init__(self, cfg: EmbedderConfig):
        super().__init__()
        self.heads = cfg.heads
        self.scale = _attention_scale(cfg)
        self.qkv = Dense(cfg.hidden, 3 * cfg.hidden)
        self.out = Dense(cfg.hidden, cfg.hidden)

    def forward(self, x, keep, dt):
        return self.out(_attend(self.qkv(x, dt), keep, self.heads,
                                self.scale, dt), dt)


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
        return _pool(x, mask)


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
        # f32 masters: on the host until train_model() moves them
        self.model = Encoder(cfg)
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
        self.refresh()

    def train_model(self) -> Encoder:
        """The f32 masters, moved to the embedder's device: the module that
        contrastive_loss, train_step and make_optimizer take.  Call
        refresh() after stepping them, or embed() keeps serving the
        weights of before."""
        return self.model.to(self.device).requires_grad_(True)

    def refresh(self) -> None:
        """Rebuild the serving copy from the masters."""
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


# -- training -----------------------------------------------------------------

# optax.adamw's defaults; torch.optim.AdamW's weight_decay default is 1e-2
ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def _batch(model: Encoder, ids, mask) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids (int64) and mask (f32) on the model's device, from numpy
    arrays (batch_encode's) or tensors."""
    dev = next(model.parameters()).device
    return (torch.as_tensor(ids).to(dev, torch.int64),
            torch.as_tensor(mask).to(dev, torch.float32))


def contrastive_loss(model: Encoder, ids_a, mask_a, ids_b, mask_b,
                     temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives (pair i of the a and b
    texts is the positive): the mean of the row and the column
    log-softmax diagonals of za @ zb.T / temperature, halved.  The f32
    products run with TF32 off (ops.distance.full_f32)."""
    with full_f32():
        za = model(*_batch(model, ids_a, mask_a))
        zb = model(*_batch(model, ids_b, mask_b))
    return _info_nce(za, zb, temperature)


def _info_nce(za, zb, temperature: float) -> torch.Tensor:
    """contrastive_loss from the two sides' embeddings."""
    with full_f32():
        logits = za @ zb.T / temperature
    li = -torch.log_softmax(logits, dim=1).diagonal().mean()
    lj = -torch.log_softmax(logits, dim=0).diagonal().mean()
    return 0.5 * (li + lj)


def loss_and_grads(model: Encoder, ids_a, mask_a, ids_b, mask_b
                   ) -> tuple[torch.Tensor, list]:
    """contrastive_loss and its gradients with respect to
    model.parameters(), in their order; forward and backward with TF32
    off."""
    params = list(model.parameters())
    with full_f32():
        loss = contrastive_loss(model, ids_a, mask_a, ids_b, mask_b)
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), list(grads)


def train_step(model: Encoder, ids_a, mask_a, ids_b, mask_b,
               lr: float = 1e-4) -> torch.Tensor:
    """One plain SGD contrastive step, p - lr * g on every parameter of
    `model` (the f32 masters, TextEmbedder.train_model()), in place; ->
    the loss before the step."""
    loss, grads = loss_and_grads(model, ids_a, mask_a, ids_b, mask_b)
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.sub_(lr * g)
    return loss


def make_optimizer(params, lr: float = 1e-4) -> torch.optim.AdamW:
    """torch.optim.AdamW with optax.adamw(lr)'s defaults: betas (0.9,
    0.999), eps 1e-8 outside the square root, weight decay 1e-4 on every
    parameter (optax's mask is None: LayerNorm scales, biases and
    embeddings decay too)."""
    return torch.optim.AdamW(params, lr=lr, betas=ADAMW_BETAS, eps=ADAMW_EPS,
                             weight_decay=ADAMW_WEIGHT_DECAY)


def adamw_step(model: Encoder, opt: torch.optim.Optimizer, ids_a, mask_a,
               ids_b, mask_b) -> torch.Tensor:
    """One contrastive step of `opt` over `model`'s parameters, forward
    and backward with TF32 off; -> the loss before the step."""
    with full_f32():
        loss = contrastive_loss(model, ids_a, mask_a, ids_b, mask_b)
        opt.zero_grad(set_to_none=True)
        loss.backward()
    opt.step()
    return loss.detach()


# -- data x tensor parallel training on a mesh -------------------------------


@dataclasses.dataclass(frozen=True)
class Split:
    """A parameter split over a mesh's feature axis: dimension `dim` is cut
    into one block per feature shard, and each of its `groups` equal parts
    is cut alike (attn.qkv's q, k and v thirds: a shard holds the same heads
    of each)."""
    dim: int
    groups: int = 1

    def take(self, t: torch.Tensor, j: int, f: int) -> torch.Tensor:
        part = t.shape[self.dim] // self.groups
        blk = part // f
        return torch.cat([t.narrow(self.dim, g * part + j * blk, blk)
                          for g in range(self.groups)], dim=self.dim)

    def join(self, blocks: list) -> torch.Tensor:
        """The inverse of take over every shard's block."""
        per = [b.chunk(self.groups, dim=self.dim) for b in blocks]
        return torch.cat([p[g] for g in range(self.groups) for p in per],
                         dim=self.dim)


def embedder_shardings(mesh, model: Encoder) -> dict:
    """Tensor parallelism over the mesh's 'feature' axis: parameter name ->
    its Split, or None (replicated).  fc1 splits by output columns (its
    bias with it) and fc2 by input rows; attn.qkv by heads within each of
    its three thirds (its bias with it) and attn.out by input rows; every
    other parameter is replicated.  The batch splits over 'data'."""
    f = mesh.shape["feature"]
    cfg = model.cfg
    if cfg.heads % f or cfg.mlp_dim % f:
        raise ValueError(f"heads {cfg.heads} and mlp_dim {cfg.mlp_dim} must "
                         f"split over {f} feature shards")
    rules = {"fc1.weight": Split(0), "fc1.bias": Split(0),
             "fc2.weight": Split(1), "attn.qkv.weight": Split(0, 3),
             "attn.qkv.bias": Split(0, 3), "attn.out.weight": Split(1)}
    out = {}
    for name, _ in model.named_parameters():
        tail = name.split(".", 2)[-1] if name.startswith("blocks.") else ""
        out[name] = rules.get(tail)
    return out


class ShardedEncoder:
    """An Encoder's f32 parameters on a (data, feature) mesh, one replica
    per data row: device [i, j] holds the feature-j blocks of the split
    parameters (embedder_shardings), and each data row's first device the
    replicated ones.  forward(i, ...) runs data row i's shard of a batch;
    the partial outputs of the split layers are summed on that row's first
    device, the bias added after the sum."""

    def __init__(self, mesh, model: Encoder):
        self.mesh, self.cfg = mesh, model.cfg
        self.splits = embedder_shardings(mesh, model)
        data, f = mesh.shape["data"], mesh.shape["feature"]
        # params[i][j]: name -> leaf tensor on devices[i, j]
        self.params = [[{} for _ in range(f)] for _ in range(data)]
        for name, p in model.named_parameters():
            t = p.detach().float()
            sp = self.splits[name]
            for i in range(data):
                for j in range(1 if sp is None else f):
                    blk = t if sp is None else sp.take(t, j, f)
                    self.params[i][j][name] = blk.to(
                        mesh.devices[i, j], copy=True).requires_grad_()

    def replicas(self, name: str) -> list:
        """[block j][data row i] leaves of one parameter."""
        f = 1 if self.splits[name] is None else self.mesh.shape["feature"]
        return [[row[j][name] for row in self.params] for j in range(f)]

    def state_dict(self) -> dict:
        """The full f32 parameters (data row 0's replica) on the CPU."""
        out = {}
        for name, sp in self.splits.items():
            blocks = [r[0].detach().cpu() for r in self.replicas(name)]
            out[name] = blocks[0] if sp is None else sp.join(blocks)
        return out

    def forward(self, i: int, ids, mask):
        """Embeddings (B_i, hidden) of data row i's shard of the batch,
        ids and mask on the row's first device."""
        from ..parallel.mesh import sum_on

        cfg, dt = self.cfg, self.cfg.torch_dtype
        devs = list(self.mesh.devices[i])
        shards = self.params[i]
        rep = shards[0]
        heads = cfg.heads // len(devs)
        scale = _attention_scale(cfg)

        def ln(x, name):
            return _layer_norm(x, rep[name + ".weight"], rep[name + ".bias"],
                               cfg.ln_eps)

        def attn(x, keep, pre):
            parts = [_dense(_attend(
                _dense(x.to(d), p[pre + "qkv.weight"], p[pre + "qkv.bias"],
                       dt), keep.to(d), heads, scale, dt),
                p[pre + "out.weight"], None, dt)
                for d, p in zip(devs, shards)]
            return sum_on(parts, devs[0]) + rep[pre + "out.bias"].to(dt)

        def mlp(x, pre, approximate):
            parts = [_dense(F.gelu(_dense(
                x.to(d), p[pre + "fc1.weight"], p[pre + "fc1.bias"], dt),
                approximate=approximate), p[pre + "fc2.weight"], None, dt)
                for d, p in zip(devs, shards)]
            return sum_on(parts, devs[0]) + rep[pre + "fc2.bias"].to(dt)

        x = F.embedding(ids, rep["tok.weight"]).to(dt) + \
            rep["pos.weight"][:ids.shape[1]].to(dt)
        if cfg.arch == "bert":
            x = ln(x + rep["typ.weight"][0].to(dt), "emb_ln").to(dt)
        keep = (mask > 0)[:, None, None, :]
        for b in range(cfg.layers):
            pre = f"blocks.{b}."
            if cfg.arch == "bert":
                x = ln(x + attn(x, keep, pre + "attn."), pre + "ln0")
                x = ln(x + mlp(x, pre, "none"), pre + "ln1")
            else:
                x = x + attn(ln(x, pre + "ln0"), keep, pre + "attn.")
                x = x + mlp(ln(x, pre + "ln1"), pre, "tanh")
        if cfg.arch != "bert":
            x = ln(x, "final_ln")
        return _pool(x, mask)


def train_step_sharded(mesh, model: ShardedEncoder, ids_a, mask_a, ids_b,
                       mask_b, lr: float = 1e-4,
                       temperature: float = 0.05) -> torch.Tensor:
    """train_step on a mesh (DP x TP): the batch splits over 'data', each
    data row runs its shard through its replica (ShardedEncoder.forward),
    and every row's embeddings are gathered onto the lead device before
    contrastive_loss, so the in-batch negatives are the global batch's.
    Autograd carries the backward across devices; each parameter's
    gradient is summed over its data-row replicas, and the plain SGD step
    p - lr * g is applied to every replica in place, so the parameters keep
    their splits and the replicas stay equal.  Forward and backward run
    with TF32 off; -> the loss before the step (on the lead device)."""
    if model.mesh is not mesh:
        raise ValueError("the ShardedEncoder was built on another mesh")
    data = mesh.shape["data"]
    ids_a, mask_a, ids_b, mask_b = (
        torch.as_tensor(x).to(dtype) for x, dtype in (
            (ids_a, torch.int64), (mask_a, torch.float32),
            (ids_b, torch.int64), (mask_b, torch.float32)))
    if ids_a.shape[0] % data:
        raise ValueError(f"batch {ids_a.shape[0]} does not split over "
                         f"{data} data shards")
    b = ids_a.shape[0] // data
    lead = mesh.lead
    with full_f32():
        z = {"a": [], "b": []}
        for i, dev in enumerate(mesh.row_devices()):
            rows = slice(i * b, (i + 1) * b)
            for side, ids, mask in (("a", ids_a, mask_a),
                                    ("b", ids_b, mask_b)):
                z[side].append(model.forward(
                    i, ids[rows].to(dev), mask[rows].to(dev)).to(lead))
        loss = _info_nce(torch.cat(z["a"]), torch.cat(z["b"]), temperature)
        names = list(model.splits)
        leaves = [p for n in names for blk in model.replicas(n) for p in blk]
        grads = iter(torch.autograd.grad(loss, leaves))
    from ..parallel.mesh import sum_on
    with torch.no_grad():
        for n in names:
            for blk in model.replicas(n):
                g = sum_on([next(grads) for _ in blk], blk[0].device)
                step = lr * g
                for p in blk:
                    p.sub_(step.to(p.device))
    return loss.detach()
