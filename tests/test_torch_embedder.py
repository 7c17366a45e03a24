"""The port's on-device text embedder (syzgydb_tpu_torch/models/) against
the JAX package's (syzgydb_tpu/models/), on the CPU.

The same texts, tokenized by both packages' tokenizers (held equal id for
id), go through the JAX TextEmbedder and the port's with the same weights
(the JAX param tree carried over by state_dict_from_flax), at a small
config (2 layers, hidden 64, 4 heads, MLP 128, vocab 512, max_len 32) in
both archs and both compute dtypes, and at full width (vocab 30522,
hidden 384, 6 layers, 12 heads, MLP 1536, max_len 128) in f32 at batch 4.

Tolerances, on components of unit vectors:
- f32: |port - JAX| <= 1e-5 (XLA and torch sum in different orders;
  measured ~2e-7);
- bf16: |port - JAX| <= 1.6e-2 (four bf16 ulps at 1.0) and cosine >=
  0.999 (single roundings of torch's bf16 ops against XLA's);
- HF parity with transformers.BertModel in f32: 2e-4, as the JAX
  package's test holds it.
Checkpoints cross between the packages both ways, byte for byte where
both write the same weights; the flax msgpack codec (ckpt_msgpack) writes
flax's bytes and reads what flax reads."""

import copy
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syzgydb_tpu.models import embedder as je
from syzgydb_tpu.models import hf_loader as jhf
from syzgydb_tpu.models import tokenizer as jtok
from syzgydb_tpu.models import train_synthetic as jts
from syzgydb_tpu_torch.models import ckpt_msgpack
from syzgydb_tpu_torch.models import embedder as te
from syzgydb_tpu_torch.models import hf_loader as thf
from syzgydb_tpu_torch.models import tokenizer as ttok
from syzgydb_tpu_torch.models import train_synthetic as tts

F32_ATOL = 1e-5
BF16_ATOL, BF16_COS = 1.6e-2, 0.999
HF_ATOL = 2e-4

SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128,
             max_len=32)
FULL = {}  # the EmbedderConfig defaults: the MiniLM-L6 shape

TEXTS = ["the quick brown fox", "jumps over", "", "a " * 200,
         "Hello, World! 123 café", "x y z"]


def _cfgs(arch, dtype, **kw):
    eps = 1e-12 if arch == "bert" else 1e-6
    return (je.EmbedderConfig(dtype=getattr(jnp, dtype), arch=arch,
                              ln_eps=eps, **kw),
            te.EmbedderConfig(dtype=dtype, arch=arch, ln_eps=eps, **kw))


def _np_tree(params):
    """The JAX param tree with numpy leaves, keys in their order (a
    jax.tree_util map would sort them)."""
    if isinstance(params, dict):
        return {k: _np_tree(v) for k, v in params.items()}
    return np.asarray(params)


def _pair(arch, dtype, seed=1, **kw):
    """A JAX TextEmbedder and a CPU port one with the same weights."""
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    j = je.TextEmbedder(jcfg, seed=seed)
    t = te.TextEmbedder(tcfg, seed=seed + 100, device="cpu")
    t.load_state_dict(te.state_dict_from_flax(_np_tree(j.params), tcfg))
    return j, t


def _close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        assert (got * want).sum(1).min() >= BF16_COS


# -- tokenizers ---------------------------------------------------------------

CORPUS = ["", "Hello, World!", "hello world", "a " * 300, "Café RÉSUMÉ",
          "naïve déjà vu", "the cafes resume", "你好 world", "İstanbul",
          "abc a'b", "   ", "x" * 150, "one,two;three... four?!"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "cafe", "resume", "the",
         "##s", "##sume", "re", "a", "b", "c", "##a", "##b", "##c", "!",
         ",", "'", "world", "hello", "na", "##ive", "deja", "vu", "x",
         "##x"]


def test_hashing_tokenizer_batch_encode_matches_jax():
    for vocab, max_len in ((512, 32), (30522, 128), (8192, 64)):
        a = jtok.HashingTokenizer(vocab, max_len).batch_encode(CORPUS)
        b = ttok.HashingTokenizer(vocab, max_len).batch_encode(CORPUS)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert ttok.CLS_ID == jtok.CLS_ID == 1 and ttok.PAD_ID == jtok.PAD_ID


def test_wordpiece_tokenizer_batch_encode_matches_jax(tmp_path):
    vf = tmp_path / "vocab.txt"
    vf.write_text("\n".join(VOCAB) + "\n")
    for max_len in (8, 64):
        a = jtok.WordPieceTokenizer.from_vocab_file(str(vf), max_len)
        b = ttok.WordPieceTokenizer.from_vocab_file(str(vf), max_len)
        for x, y in zip(a.batch_encode(CORPUS), b.batch_encode(CORPUS)):
            assert x.dtype == y.dtype and np.array_equal(x, y)


# -- the flax msgpack codec ---------------------------------------------------


def _codec_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "a": rng.standard_normal((3, 4)).astype(np.float32),
            "big": rng.standard_normal(70000).astype(np.float32),
            "b": {"i8": np.arange(-5, 5, dtype=np.int8),
                  "u16": np.arange(300, dtype=np.uint16).reshape(3, 100),
                  "f64": np.zeros((0, 3)), "flags": np.array([True, False]),
                  "s32": np.float32(3.5), "s64": np.int64(-7)}},
        "step": 5, "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                            -1, -32, -33, -128, -129, -32769, -2 ** 31 - 1],
        "lr": 0.1, "short": "n" * 31, "mid": "m" * 40, "long": "y" * 300,
        "t": True, "f": False, "none": None, "blob": b"abc" * 100,
        "k" * 20: {}, "wide": {str(i): i for i in range(20)}}


def test_ckpt_msgpack_writes_flax_bytes():
    import flax.serialization as fs

    tree = _codec_tree()
    assert ckpt_msgpack.dumps(tree) == fs.msgpack_serialize(
        copy.deepcopy(tree), in_place=True)
    params = {"params": tree["params"]}
    assert ckpt_msgpack.dumps(params) == fs.to_bytes(copy.deepcopy(params))


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_ckpt_msgpack_reads_what_flax_reads():
    import flax.serialization as fs

    blob = fs.msgpack_serialize(_codec_tree())
    _same(fs.msgpack_restore(blob), ckpt_msgpack.loads(blob))


def test_ckpt_msgpack_bf16_leaves_both_ways():
    import flax.serialization as fs

    t = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    j = np.asarray(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
    assert ckpt_msgpack.dumps({"w": t}) == fs.to_bytes({"w": j})
    back = ckpt_msgpack.loads(fs.to_bytes({"w": j}))["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_ckpt_msgpack_reencodes_the_shipped_checkpoint_byte_for_byte():
    blob = open(tts.DEFAULT_CHECKPOINT, "rb").read()
    n = int.from_bytes(blob[4:8], "little")
    assert ckpt_msgpack.dumps(ckpt_msgpack.loads(blob[8 + n:])) == \
        blob[8 + n:]


def test_ckpt_msgpack_refuses_chunked_and_malformed_trees(monkeypatch):
    import flax.serialization as fs

    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    chunked = fs.to_bytes({"w": np.zeros(100, np.float32)})
    with pytest.raises(ckpt_msgpack.ChunkedArrayError, match="chunks"):
        ckpt_msgpack.loads(chunked)
    good = ckpt_msgpack.dumps({"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        ckpt_msgpack.loads(good[:-1])
    with pytest.raises(ValueError, match="trailing"):
        ckpt_msgpack.loads(good + b"\x00")
    with pytest.raises(TypeError, match="tuple"):
        ckpt_msgpack.dumps({"w": (1, 2)})


# -- the encoder against the JAX package's -------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["preln", "bert"])
def test_embed_matches_jax_small(arch, dtype):
    j, t = _pair(arch, dtype, **SMALL)
    _close(t.embed(TEXTS), j.embed(TEXTS), dtype)
    # one text alone (batch 1, no padding) and in a padded batch of 3
    _close(t.embed(TEXTS[:1]), j.embed(TEXTS[:1]), dtype)
    _close(t.embed(TEXTS[1:4]), j.embed(TEXTS[1:4]), dtype)


@pytest.mark.parametrize("arch", ["preln", "bert"])
def test_embed_matches_jax_full_width_f32(arch):
    j, t = _pair(arch, "float32", **FULL)
    assert sum(p.numel() for p in t.model.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(j.params))
    _close(t.embed(TEXTS[:4]), j.embed(TEXTS[:4]), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["preln", "bert"])
def test_rows_with_no_key_left_are_finite(arch, dtype):
    """A padded row has an all-zero mask: every key is masked, and the
    finfo.min fill (not -inf) keeps its softmax finite."""
    _, tcfg = _cfgs(arch, dtype, **SMALL)
    t = te.TextEmbedder(tcfg, device="cpu")
    ids = torch.zeros((2, tcfg.max_len), dtype=torch.int64)
    mask = torch.zeros((2, tcfg.max_len))
    mask[0, :3] = 1.0
    with torch.inference_mode():
        out = t._net(ids, mask)
    assert torch.isfinite(out).all()


def test_embed_is_deterministic_across_threads():
    """Request threads call embed concurrently: each answer equals the
    serial one."""
    _, t = _pair("preln", "float32", **SMALL)
    want = [t.embed([x]) for x in TEXTS]
    got, errors = {}, []

    def worker(w):
        try:
            for r in range(20):
                i = (w + r) % len(TEXTS)
                got[(w, r)] = (i, t.embed([TEXTS[i]]))
        except BaseException as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(got) == 160
    for i, v in got.values():
        assert np.array_equal(v, want[i])


def test_embed_text_fn_adapter():
    _, t = _pair("preln", "float32", **SMALL)
    out = t.as_embed_text_fn()(["hello", "world"], True)
    assert len(out) == 2 and len(out[0]) == 64
    assert isinstance(out[0][0], float)
    assert t.embed([]).shape == (0, 64)


def test_config_refuses_unknown_names():
    with pytest.raises(ValueError, match="dtype"):
        te.EmbedderConfig(dtype="float16")
    with pytest.raises(ValueError, match="arch"):
        te.EmbedderConfig(arch="gpt")
    with pytest.raises(ValueError, match="multiple"):
        te.EmbedderConfig(hidden=100, heads=12)
    assert te.EmbedderConfig().torch_dtype == torch.bfloat16
    # the same fields, in the same order: a checkpoint header is the JSON
    # of either package's config
    import dataclasses
    assert [f.name for f in dataclasses.fields(te.EmbedderConfig)] == \
        [f.name for f in dataclasses.fields(je.EmbedderConfig)]


def test_resolve_device_refuses_cuda_here(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _cfgs("preln", "float32", **SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        te.TextEmbedder(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        te.TextEmbedder(tcfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        te.TextEmbedder.from_checkpoint(tts.DEFAULT_CHECKPOINT)
    d, _ = _make_hf_dir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        thf.load_hf_minilm(str(d))


# -- the param tree and checkpoints ---------------------------------------------


@pytest.mark.parametrize("arch", ["preln", "bert"])
def test_flax_tree_round_trips_in_flax_order(arch):
    jcfg, tcfg = _cfgs(arch, "float32", **SMALL)
    tree = _np_tree(je.TextEmbedder(jcfg, seed=4).params)
    back = te.flax_from_state_dict(te.state_dict_from_flax(tree, tcfg), tcfg)
    _same(tree, back)


def test_a_tree_of_the_wrong_shape_names_the_leaf():
    jcfg, tcfg = _cfgs("preln", "float32", **SMALL)
    tree = _np_tree(je.TextEmbedder(jcfg, seed=4).params)
    bad = copy.deepcopy(tree)
    k = bad["params"]["Block_1"]["Dense_0"]["kernel"]
    bad["params"]["Block_1"]["Dense_0"]["kernel"] = k[:, :-1]
    with pytest.raises(ValueError, match="Block_1/Dense_0/kernel"):
        te.state_dict_from_flax(bad, tcfg)
    bad = copy.deepcopy(tree)
    del bad["params"]["Embed_1"]
    with pytest.raises(ValueError, match="missing leaf params/Embed_1"):
        te.state_dict_from_flax(bad, tcfg)
    bad = copy.deepcopy(tree)
    bad["params"]["Embed_2"] = {"embedding": np.zeros((2, 64), np.float32)}
    with pytest.raises(ValueError, match="unexpected leaf params/Embed_2"):
        te.state_dict_from_flax(bad, tcfg)
    with pytest.raises(ValueError, match="'params'"):
        te.state_dict_from_flax(tree["params"], tcfg)
    # a checkpoint of another config loaded into this one
    _, other = _cfgs("preln", "float32", **{**SMALL, "hidden": 32})
    with pytest.raises(ValueError, match=r"flax leaf params/\S+ has shape"):
        te.state_dict_from_flax(tree, other)


def test_shipped_checkpoint_reads_alike_in_both_packages():
    assert open(tts.DEFAULT_CHECKPOINT, "rb").read() == \
        open(jts.DEFAULT_CHECKPOINT, "rb").read()
    assert os.path.dirname(tts.DEFAULT_CHECKPOINT) != \
        os.path.dirname(jts.DEFAULT_CHECKPOINT)
    j = je.TextEmbedder.from_checkpoint(jts.DEFAULT_CHECKPOINT)
    t = te.TextEmbedder.from_checkpoint(tts.DEFAULT_CHECKPOINT, device="cpu")
    assert t.cfg == tts.training_config()
    topics, filler = tts.make_vocab()
    rng = np.random.default_rng(5)
    docs = [tts.sample_doc(rng, topics[i], filler) for i in range(16)]
    _close(t.embed(docs), j.embed(docs), "float32")


@pytest.mark.parametrize("arch", ["preln", "bert"])
def test_port_checkpoint_reads_in_jax_byte_for_byte(arch, tmp_path):
    """The port writes, JAX reads: same embeddings, and JAX writing the
    weights it read gives the port's bytes."""
    _, tcfg = _cfgs(arch, "float32", **SMALL)
    t = te.TextEmbedder(tcfg, seed=9, device="cpu")
    path = str(tmp_path / "port.ckpt")
    t.save_checkpoint(path)
    j = je.TextEmbedder.from_checkpoint(path)
    assert j.cfg.arch == arch and j.cfg.dtype == jnp.float32
    _close(t.embed(TEXTS), j.embed(TEXTS), "float32")
    j.save_checkpoint(str(tmp_path / "jax.ckpt"))
    assert open(path, "rb").read() == open(tmp_path / "jax.ckpt",
                                           "rb").read()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["preln", "bert"])
def test_jax_checkpoint_reads_in_the_port(arch, dtype, tmp_path):
    jcfg, _ = _cfgs(arch, dtype, **SMALL)
    j = je.TextEmbedder(jcfg, seed=2)
    path = str(tmp_path / "jax.ckpt")
    j.save_checkpoint(path)
    t = te.TextEmbedder.from_checkpoint(path, device="cpu")
    assert t.cfg.dtype == dtype and t.cfg.arch == arch
    _close(t.embed(TEXTS), j.embed(TEXTS), dtype)
    # load_pretrained into an instance of the same config
    fresh = te.TextEmbedder(t.cfg, seed=77, device="cpu")
    fresh.load_pretrained(path)
    assert np.array_equal(fresh.embed(TEXTS), t.embed(TEXTS))


def test_raw_params_blob_loads_into_the_default_config(tmp_path):
    """A file without the SYZE header is raw flax msgpack params for the
    default (full-width) config."""
    import flax.serialization as fs

    src = te.TextEmbedder(seed=5, device="cpu")
    tree = te.flax_from_state_dict(src.model.state_dict(), src.cfg)
    path = tmp_path / "raw.msgpack"
    path.write_bytes(fs.to_bytes(tree))
    emb = te.TextEmbedder.from_checkpoint(str(path), device="cpu")
    assert emb.cfg == te.EmbedderConfig()
    for k, v in src.model.state_dict().items():
        assert torch.equal(emb.model.state_dict()[k], v), k
    small = te.TextEmbedder(_cfgs("preln", "float32", **SMALL)[1],
                            device="cpu")
    with pytest.raises(ValueError, match=r"flax leaf params/\S+ has shape"):
        small.load_pretrained(str(path))


# -- the retrieval gate and the corpus -------------------------------------------


def test_corpus_matches_jax():
    assert tts.make_vocab() == jts.make_vocab()
    assert tts.make_vocab(7) == jts.make_vocab(7)
    topics, filler = tts.make_vocab()
    for seed in (0, 31, 777):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for t in range(64):
            assert tts.sample_doc(a, topics[t], filler) == \
                jts.sample_doc(b, topics[t], filler)
    jc, tc = jts.training_config(), tts.training_config()
    assert json.dumps(tc.__dict__) == json.dumps(
        {**jc.__dict__, "dtype": jnp.dtype(jc.dtype).name})


def test_shipped_checkpoint_passes_retrieval_gate():
    emb = te.TextEmbedder.from_checkpoint(tts.DEFAULT_CHECKPOINT,
                                          device="cpu")
    acc = tts.retrieval_accuracy(emb, n_queries=48)
    assert acc >= 0.9, acc
    rnd = te.TextEmbedder(tts.training_config(), seed=123, device="cpu")
    acc_rnd = tts.retrieval_accuracy(rnd, seed=777, n_queries=48)
    assert acc_rnd < 0.5, acc_rnd


# -- HF checkpoint directories --------------------------------------------------


def _hf_vocab():
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
             "the", "cat", "sat", "on", "a", "mat", "dog", "ran", "in",
             "park", "hello", "world", "##s", "##ing", "##ed", "blue",
             "sky", "red", "car", ".", ",", "!", "quick", "brown", "fox"]
    while len(words) < 64:
        words.append(f"tok{len(words)}")
    return words


def _make_hf_dir(tmp_path):
    """A randomly initialized transformers BertModel saved in the HF
    directory layout."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64)
    torch.manual_seed(0)
    model = transformers.BertModel(cfg).eval()
    d = tmp_path / "minilm"
    model.save_pretrained(str(d))
    (d / "vocab.txt").write_text("\n".join(_hf_vocab()) + "\n")
    return d, model


HF_TEXTS = ["the cat sat on a mat", "hello world !", "a quick brown fox",
            "dogs running in the park"]


@pytest.mark.parametrize("weights", ["safetensors", "pytorch_bin"])
def test_hf_checkpoint_numerical_parity(tmp_path, weights):
    d, torch_model = _make_hf_dir(tmp_path)
    if weights == "pytorch_bin":
        os.remove(str(d / "model.safetensors"))
        torch.save(torch_model.state_dict(), str(d / "pytorch_model.bin"))
    emb = thf.load_hf_minilm(str(d), dtype="float32", device="cpu")
    ours = emb.embed(HF_TEXTS)
    ids, mask = emb.tokenizer.batch_encode(HF_TEXTS)
    with torch.no_grad():
        out = torch_model(input_ids=torch.tensor(ids, dtype=torch.long),
                          attention_mask=torch.tensor(mask))
    h = out.last_hidden_state.numpy()
    m = mask[:, :, None]
    pooled = (h * m).sum(1) / np.maximum(m.sum(1), 1.0)
    want = pooled / np.linalg.norm(pooled, axis=-1, keepdims=True)
    np.testing.assert_allclose(ours, want, rtol=0, atol=HF_ATOL)
    # and the JAX package's loader on the same directory
    j = jhf.load_hf_minilm(str(d), dtype=jnp.float32)
    _close(ours, j.embed(HF_TEXTS), "float32")


def test_hf_checkpoint_via_from_checkpoint_dir(tmp_path):
    d, _ = _make_hf_dir(tmp_path)
    emb = te.TextEmbedder.from_checkpoint(str(d), device="cpu")
    assert emb.cfg.arch == "bert" and emb.cfg.dtype == "bfloat16"
    assert emb.cfg.ln_eps == 1e-12 and emb.cfg.max_len == 64
    assert isinstance(emb.tokenizer, ttok.WordPieceTokenizer)
    out = emb.embed(["hello world"])
    assert out.shape == (1, 32)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    emb2 = te.TextEmbedder.from_checkpoint(str(d), device="cpu")
    assert np.array_equal(out, emb2.embed(["hello world"]))
    j = je.TextEmbedder.from_checkpoint(str(d))
    _close(emb.embed(HF_TEXTS), j.embed(HF_TEXTS), "bfloat16")


def test_hf_checkpoint_malformed_errors(tmp_path):
    """Malformed checkpoints fail with the JAX loader's named errors."""
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="config.json"):
        thf.load_hf_minilm(str(empty), device="cpu")
    (empty / "config.json").write_text(json.dumps(
        {"hidden_size": 32, "num_hidden_layers": 2,
         "num_attention_heads": 2, "intermediate_size": 64,
         "vocab_size": 64}))
    with pytest.raises(FileNotFoundError, match="safetensors"):
        thf.load_hf_minilm(str(empty), device="cpu")
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    with pytest.raises(ValueError, match="hidden_size"):
        thf.load_hf_minilm(str(bad), device="cpu")
    d, torch_model = _make_hf_dir(tmp_path)
    state = torch_model.state_dict()
    os.remove(str(d / "model.safetensors"))
    missing = dict(state)
    missing.pop("embeddings.word_embeddings.weight")
    torch.save(missing, str(d / "pytorch_model.bin"))
    with pytest.raises(KeyError, match="word_embeddings"):
        thf.load_hf_minilm(str(d), device="cpu")
    # a tensor of the wrong shape: the mapped tree no longer matches
    wrong = dict(state)
    wrong["encoder.layer.1.output.dense.weight"] = torch.zeros(32, 63)
    torch.save(wrong, str(d / "pytorch_model.bin"))
    with pytest.raises(ValueError, match=r"blocks\.1\.fc2\.weight has shape"):
        thf.load_hf_minilm(str(d), device="cpu")


def test_read_safetensors_matches_jax(tmp_path):
    d, _ = _make_hf_dir(tmp_path)
    path = str(d / "model.safetensors")
    a, b = jhf.read_safetensors(path), thf.read_safetensors(path)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
