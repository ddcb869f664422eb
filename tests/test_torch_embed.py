"""The port's MiniLM embedder (vectorlite_tpu_torch/embed/minilm.py) against
the JAX package's, on the CPU.

The same ``_random_params`` pytree goes through the JAX ``bert_forward`` /
``_embed_step`` and the port's ``BertEncoder`` (``params_from_reference``)
at the parity config of tests/test_embed_parity.py and at MiniLM's full
published width: embeddings within atol 1e-5, as tests/test_embed.py
holds its own. ``tokenize_batch`` stages the same ids and masks; the
port's ``tokenizer.json`` reader tokenizes the pinned goldens and agrees
with the ``tokenizers`` package where it is installed; its safetensors
reader agrees with ``safetensors.numpy``. The card test holds the encoder
on the card against its CPU forward.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorlite_tpu.embed import minilm as jm
from vectorlite_tpu_torch.embed import minilm as tm
from vectorlite_tpu_torch.embed import wordpiece as twp
from vectorlite_tpu_torch.errors import EmbeddingError

import _minilm_fixtures as fx

GOLDEN = Path(__file__).parent / "golden"
PARITY_CONFIG = {
    "hidden_size": 64,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "intermediate_size": 128,
    "vocab_size": 1000,
    "max_position_embeddings": 64,
}
TEXTS = ["hello world", "the quick brown fox jumps", "", "x " * 40,
         "a much longer text with many more tokens here and there"]


def staged(config, seed=3):
    """Ragged id/mask rows (tests/test_embed_parity.py's _mk_inputs)."""
    rng = np.random.default_rng(seed)
    b, l = 4, 12
    ids = rng.integers(0, config["vocab_size"], (b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    for row, real in enumerate((l, 9, 5, 1)):
        ids[row, real:] = 0
        mask[row, real:] = 0
    return ids, mask


@pytest.mark.parametrize("config", [PARITY_CONFIG, jm._MINILM_CONFIG],
                         ids=["parity", "minilm"])
def test_random_params_are_bit_identical(config):
    a, b = jm._random_params(config, 7), tm._random_params(config, 7)
    for key in tm._TOP_KEYS:
        assert a[key].tobytes() == b[key].tobytes(), key
    for la, lb in zip(a["layers"], b["layers"], strict=True):
        for key in tm._LAYER_KEYS:
            assert la[key].tobytes() == lb[key].tobytes(), key


@pytest.mark.parametrize("config", [PARITY_CONFIG, jm._MINILM_CONFIG],
                         ids=["parity", "minilm"])
def test_encoder_matches_bert_forward(config):
    params = jm._random_params(config, 11)
    enc = tm.params_from_reference(params, device="cpu", config=config)
    ids, mask = staged(config)
    want_h = np.asarray(jm.bert_forward(params, jnp.asarray(ids), jnp.asarray(mask), config))
    got_h = enc.hidden_states(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    real = mask.astype(bool)  # padded positions carry no contract
    np.testing.assert_allclose(got_h[real], want_h[real], atol=2e-5, rtol=0)
    key = tuple(sorted((k, v) for k, v in config.items()
                       if k in ("hidden_size", "num_attention_heads")))
    want = np.asarray(jm._embed_step(params, jnp.asarray(ids), jnp.asarray(mask),
                                     config_key=key))
    with torch.inference_mode():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("config", [PARITY_CONFIG, jm._MINILM_CONFIG],
                         ids=["parity", "minilm"])
def test_embedder_matches_jax_embedder(config):
    j = jm.MiniLMEmbedder.random_init(seed=2, config=dict(config))
    t = tm.MiniLMEmbedder.random_init(seed=2, config=dict(config), device="cpu")
    assert t.dimension == j.dimension == config["hidden_size"]
    np.testing.assert_allclose(t.embed_batch_arrays(TEXTS), j.embed_batch_arrays(TEXTS),
                               atol=1e-5, rtol=0)
    got = t.generate_embedding("hello world")
    assert isinstance(got, list) and len(got) == config["hidden_size"]
    np.testing.assert_allclose(got, j.generate_embedding("hello world"), atol=1e-5)
    assert t.embed_batch([]) == [] and t.embed_batch_arrays([]).shape == (0, t.dimension)


def test_padding_does_not_leak_into_a_text():
    """tests/test_embed.py:99's bound: a text alone and padded beside a
    longer one."""
    t = tm.MiniLMEmbedder.random_init(seed=0, config=dict(PARITY_CONFIG), device="cpu")
    alone = t.embed_batch_arrays(["short"])[0]
    padded = t.embed_batch_arrays(["short", "a much longer text " * 5])[0]
    np.testing.assert_allclose(alone, padded, atol=1e-4)


@pytest.mark.parametrize("n_texts", [1, 3, 5, 9])
def test_tokenize_batch_stages_the_same_arrays(n_texts):
    tok_j, tok_t = jm._HashTokenizer(30522), tm._HashTokenizer(30522)
    texts = (TEXTS * 2)[:n_texts] + ["y " * 600]  # the last one truncates
    for max_len in (512, 64):
        ids_j, mask_j = jm.tokenize_batch(tok_j, texts, max_len)
        ids_t, mask_t = tm.tokenize_batch(tok_t, texts, max_len)
        assert ids_t.dtype == ids_j.dtype and (ids_t == ids_j).all()
        assert (mask_t == mask_j).all()


# ------------------------------------------------------------ the tokenizer


def golden_tokenizer_json(tmp_path) -> Path:
    vocab = json.loads((GOLDEN / "vocab_slice_minilm.json").read_text())["vocab"]
    d = fx.save_model_dir(tmp_path / "m", tm._random_params(PARITY_CONFIG, 0),
                          PARITY_CONFIG, vocab)
    return d / "tokenizer.json"


def test_tokenizer_reproduces_the_pinned_goldens(tmp_path):
    tok = tm.WordPieceTokenizer.from_file(golden_tokenizer_json(tmp_path))
    goldens = json.loads((GOLDEN / "tokenizer_minilm.json").read_text())
    for case in goldens["cases"]:
        assert tok.encode(case["text"]) == case["ids"], case["text"]
    vocab = json.loads((GOLDEN / "vocab_slice_minilm.json").read_text())["vocab"]
    for case in goldens["cases"]:
        assert twp.encode(vocab, case["text"]) == case["ids"], case["text"]


TRICKY = ["hello world", "Hello, World.", "", "  the\tworld\n", "héllo wörld",
          "HELLO!!world??", "中文 hello", "hello\u0000world", "hello" * 30,
          "the the the", "well-known", "naïve café", "x" * 150, " hello　world"]


@pytest.mark.parametrize("types", [("BertNormalizer", "BertPreTokenizer"),
                                   ("Lowercase", "Whitespace")])
def test_tokenizer_matches_the_tokenizers_package(tmp_path, types):
    tokenizers = pytest.importorskip("tokenizers")
    path = golden_tokenizer_json(tmp_path)
    spec = json.loads(path.read_text())
    spec["normalizer"] = ({"type": "Lowercase"} if types[0] == "Lowercase"
                          else spec["normalizer"])
    spec["pre_tokenizer"] = {"type": types[1]}
    path.write_text(json.dumps(spec))
    hf = tokenizers.Tokenizer.from_file(str(path))
    ours = tm.WordPieceTokenizer.from_file(path)
    for text in TRICKY:
        assert ours.encode(text) == hf.encode(text).ids, text


@pytest.mark.parametrize("part,spec", [
    ("normalizer", {"type": "NFKC"}),
    ("pre_tokenizer", {"type": "ByteLevel"}),
    ("post_processor", {"type": "RobertaProcessing"}),
    ("model", {"type": "BPE", "vocab": {}}),
])
def test_tokenizer_refuses_other_types(tmp_path, part, spec):
    path = golden_tokenizer_json(tmp_path)
    doc = json.loads(path.read_text())
    doc[part] = spec
    with pytest.raises(EmbeddingError, match=spec["type"]):
        tm.WordPieceTokenizer(doc)


# ------------------------------------------------------------------ weights


def test_safetensors_reader_matches_the_package(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    rng = np.random.default_rng(0)
    tensors = {
        "a": rng.standard_normal((3, 5)).astype(np.float32),
        "b": rng.standard_normal(7).astype(np.float64),
        "c": rng.integers(-5, 5, (2, 2, 2)).astype(np.int64),
        "d": rng.standard_normal((4,)).astype(np.float16),
        "e": np.arange(6, dtype=np.int8).reshape(2, 3),
    }
    st.save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = tm.load_safetensors(tmp_path / "x.safetensors")
    want = st.load_file(str(tmp_path / "x.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    # the port's writer, read back by the package
    fx.save_safetensors(tmp_path / "y.safetensors", {"w": tensors["a"]})
    assert st.load_file(str(tmp_path / "y.safetensors"))["w"].tobytes() == tensors["a"].tobytes()


@pytest.mark.parametrize("weights", ["pytorch_model.bin", "model.safetensors"])
def test_from_pretrained_matches_jax_and_random_init(tmp_path, weights):
    """A synthetic model directory of random_init's parameters, with a
    vocabulary giving its words the hash tokenizer's ids: the port loads
    it to random_init's embeddings, and both packages load it alike."""
    config = dict(PARITY_CONFIG)
    params = tm._random_params(config, 5)
    words = ["alpha", "beta", "gamma", "delta", "vector", "search"]
    vocab = fx.hash_vocab(tm._HashTokenizer(config["vocab_size"]), words)
    d = fx.save_model_dir(tmp_path / "m", params, config, vocab, weights=weights)
    loaded = tm.MiniLMEmbedder.from_pretrained(str(d), device="cpu")
    texts = ["alpha beta", "vector search gamma", "delta"]
    want = tm.MiniLMEmbedder.random_init(5, config, device="cpu").embed_batch_arrays(texts)
    np.testing.assert_allclose(loaded.embed_batch_arrays(texts), want, atol=1e-5, rtol=0)
    if weights == "model.safetensors":
        pytest.importorskip("safetensors")
    jax_loaded = jm.MiniLMEmbedder.from_pretrained(str(d))
    mixed = texts + ["Alpha, BETA! unknownword"]
    np.testing.assert_allclose(loaded.embed_batch_arrays(mixed),
                               jax_loaded.embed_batch_arrays(mixed), atol=1e-5, rtol=0)
    assert tm._map_hf_params(fx.hf_state_dict(params), 2)["layers"][1]["i_w"].tobytes() == (
        params["layers"][1]["i_w"].tobytes())


def test_missing_files_raise_model_files_missing(tmp_path):
    with pytest.raises(tm.ModelFilesMissing, match="Tokenizer file not found"):
        tm.MiniLMEmbedder.from_pretrained(str(tmp_path / "nope"), device="cpu")
    d = fx.save_model_dir(tmp_path / "m", tm._random_params(PARITY_CONFIG, 0),
                          PARITY_CONFIG, {"[UNK]": 100, "[CLS]": 101, "[SEP]": 102})
    (d / "pytorch_model.bin").unlink()
    with pytest.raises(tm.ModelFilesMissing, match="weights file not found"):
        tm.MiniLMEmbedder.from_pretrained(str(d), device="cpu")


@pytest.mark.cuda
def test_encoder_on_the_card_matches_its_cpu_forward():
    """MiniLM at full width on the card against the same parameters on
    the CPU: unit vectors within 1e-4 (padded-versus-alone's bound)."""
    if not torch.cuda.is_available():
        pytest.skip("the encoder on the card needs an NVIDIA card")
    card = tm.MiniLMEmbedder.random_init(seed=0)
    cpu = tm.MiniLMEmbedder.random_init(seed=0, device="cpu")
    assert card.device.type == "cuda"
    texts = [" ".join(f"w{(i * 7 + j) % 97}" for j in range(n))
             for i, n in enumerate([1, 8, 40, 100] * 8)]
    np.testing.assert_allclose(card.embed_batch_arrays(texts), cpu.embed_batch_arrays(texts),
                               atol=1e-4, rtol=0)
