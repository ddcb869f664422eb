"""MiniLM (BERT) text embedder on the card.

Port of ``vectorlite_tpu/embed/minilm.py`` (itself a port of the
reference's Candle BERT embedder, reference: src/embeddings.rs:89-277):

* **The encoder** — ``BertEncoder``, an ``nn.Module`` computing what the
  JAX package's ``bert_forward`` and ``_embed_step`` compute: post-LN
  layers (LayerNorm eps 1e-12), exact erf GELU, the additive mask
  ``(1 - mask) * -1e9``, CLS pooling (reference: src/embeddings.rs:163-181)
  and ``where(norm > 0, cls / max(norm, 1e-30), cls)``. It runs in f32
  with TF32 off, in plain torch ops, on an explicit device; the JAX
  package computes all of this outside any Pallas kernel, so there is no
  kernel to port here.
* **Batching** — ``tokenize_batch`` keeps the JAX package's length buckets
  and power-of-two batch padding, so both packages run the same padded
  shapes.
* **Model loading** — the reference's on-disk layout (``tokenizer.json`` +
  ``config.json`` + ``model.safetensors`` / ``pytorch_model.bin``,
  reference: src/embeddings.rs:219-259), read without the ``tokenizers``
  and ``safetensors`` packages: ``tokenizer.json``'s WordPiece vocabulary
  runs through this package's ``wordpiece`` module (the normalizer and
  pre-tokenizer types the real MiniLM file names, ``BertNormalizer`` and
  ``BertPreTokenizer``, and ``Lowercase`` / ``Whitespace``; any other type
  raises ``EmbeddingError``), ``model.safetensors`` through a small reader
  of its own, ``pytorch_model.bin`` through ``torch.load(weights_only=True)``.

Without model files, ``MiniLMEmbedder.random_init()`` builds a
deterministic randomly-initialized encoder: the full compute path without
pretrained weights, bit-identical parameters to the JAX package's for a
seed.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import resolve_device
from ..core.metrics import disable_tf32
from ..errors import EmbeddingError
from . import wordpiece

DEFAULT_MODEL_NAME = "all-MiniLM-L6-v2"
DEFAULT_MODEL_PATH = f"./models/{DEFAULT_MODEL_NAME}"

_LEN_BUCKETS = (16, 32, 64, 128, 256, 512)


class ModelFilesMissing(EmbeddingError):
    """A model directory lacks its tokenizer, config or weights file."""


# --------------------------------------------------------------- the encoder

_LAYER_KEYS = (
    "q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "ao_w", "ao_b", "ao_ln_w",
    "ao_ln_b", "i_w", "i_b", "o_w", "o_b", "o_ln_w", "o_ln_b",
)
_TOP_KEYS = ("word_emb", "pos_emb", "type_emb", "emb_ln_w", "emb_ln_b")


class BertEncoder(nn.Module):
    """The JAX package's parameter pytree as f32 buffers (dense weights
    [in, out], as ``x @ w + b`` reads them) and its forward pass."""

    def __init__(self, params: dict, config: dict, *, device):
        super().__init__()
        self.n_heads = int(config["num_attention_heads"])
        self.hidden = int(config["hidden_size"])
        self.head_dim = self.hidden // self.n_heads

        def put(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(device)

        for key in _TOP_KEYS:
            self.register_buffer(key, put(params[key]))
        self.layers = nn.ModuleList()
        for layer in params["layers"]:
            mod = nn.Module()
            for key in _LAYER_KEYS:
                mod.register_buffer(key, put(layer[key]))
            self.layers.append(mod)

    def _ln(self, x, w, b):
        return F.layer_norm(x, (x.shape[-1],), w, b, eps=1e-12)

    def hidden_states(self, input_ids, attention_mask):
        """[B, L] ids -> [B, L, H] final hidden states (``bert_forward``)."""
        ids = input_ids.long()
        h = (
            self.word_emb[ids]
            + self.pos_emb[None, : ids.shape[1]]
            + self.type_emb[0][None, None, :]
        )
        h = self._ln(h, self.emb_ln_w, self.emb_ln_b)
        scale = 1.0 / math.sqrt(self.head_dim)
        # additive mask: 0 for real tokens, -1e9 for padding
        mask = (1.0 - attention_mask.to(h.dtype)) * -1e9
        mask = mask[:, None, None, :]  # [B, 1, 1, L]
        b, l, _ = h.shape
        for layer in self.layers:
            q = torch.matmul(h, layer.q_w) + layer.q_b
            k = torch.matmul(h, layer.k_w) + layer.k_b
            v = torch.matmul(h, layer.v_w) + layer.v_b
            q = q.reshape(b, l, self.n_heads, self.head_dim).transpose(1, 2)
            k = k.reshape(b, l, self.n_heads, self.head_dim).transpose(1, 2)
            v = v.reshape(b, l, self.n_heads, self.head_dim).transpose(1, 2)
            scores = torch.matmul(q, k.transpose(-1, -2)) * scale + mask
            probs = torch.softmax(scores, dim=-1)
            ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, -1)
            attn_out = torch.matmul(ctx, layer.ao_w) + layer.ao_b
            h = self._ln(h + attn_out, layer.ao_ln_w, layer.ao_ln_b)
            ffn = F.gelu(torch.matmul(h, layer.i_w) + layer.i_b, approximate="none")
            ffn = torch.matmul(ffn, layer.o_w) + layer.o_b
            h = self._ln(h + ffn, layer.o_ln_w, layer.o_ln_b)
        return h

    def forward(self, input_ids, attention_mask):
        """[B, L] ids -> [B, H] unit CLS embeddings (``_embed_step``)."""
        disable_tf32()
        cls = self.hidden_states(input_ids, attention_mask)[:, 0, :]
        norm = torch.sqrt(torch.sum(cls * cls, dim=-1, keepdim=True))
        return torch.where(norm > 0.0, cls / torch.clamp(norm, min=1e-30), cls)


def params_from_reference(params: dict, *, device, config: Optional[dict] = None):
    """The port's encoder of the JAX package's parameter pytree (numpy
    arrays in its ``_random_params`` / ``_map_hf_params`` layout), on
    ``device``; ``config`` names the heads (MiniLM's by default)."""
    return BertEncoder(params, config or _MINILM_CONFIG, device=resolve_device(device))


# ------------------------------------------------------------ weight loading

#: safetensors dtype names -> numpy
_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
    "BOOL": np.bool_,
}


def load_safetensors(path) -> dict[str, np.ndarray]:
    """A ``.safetensors`` file as numpy arrays: an 8-byte little-endian
    header length, a JSON header of name -> {dtype, shape, data_offsets},
    then the raw little-endian tensors."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise EmbeddingError(f"{path}: not a safetensors file")
    n = int.from_bytes(raw[:8], "little")
    try:
        header = json.loads(raw[8 : 8 + n])
    except ValueError as e:
        raise EmbeddingError(f"{path}: malformed safetensors header: {e}") from None
    body = memoryview(raw)[8 + n :]
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        lo, hi = spec["data_offsets"]
        shape = tuple(spec["shape"])
        dtype = _ST_DTYPES.get(spec["dtype"])
        if dtype is None:
            raise EmbeddingError(f"{path}: unsupported dtype {spec['dtype']} for {name}")
        arr = np.frombuffer(body[lo:hi], dtype=np.dtype(dtype).newbyteorder("<"))
        out[name] = arr.reshape(shape).astype(dtype, copy=True)
    return out


def _load_torch_weights(model_file: Path) -> dict[str, np.ndarray]:
    if model_file.suffix == ".safetensors":
        return load_safetensors(model_file)
    state = torch.load(str(model_file), map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in state.items()}


def _map_hf_params(state: dict[str, np.ndarray], n_layers: int) -> dict:
    """HF bert-* names -> the JAX package's flat pytree. torch Linear
    stores [out, in]."""

    def get(name):
        for prefix in ("", "bert."):
            key = prefix + name
            if key in state:
                return np.asarray(state[key])
        raise KeyError(name)

    def lin(name):
        return get(name + ".weight").T, get(name + ".bias")

    params = {
        "word_emb": get("embeddings.word_embeddings.weight"),
        "pos_emb": get("embeddings.position_embeddings.weight"),
        "type_emb": get("embeddings.token_type_embeddings.weight"),
        "emb_ln_w": get("embeddings.LayerNorm.weight"),
        "emb_ln_b": get("embeddings.LayerNorm.bias"),
        "layers": [],
    }
    for i in range(n_layers):
        p = f"encoder.layer.{i}."
        q_w, q_b = lin(p + "attention.self.query")
        k_w, k_b = lin(p + "attention.self.key")
        v_w, v_b = lin(p + "attention.self.value")
        ao_w, ao_b = lin(p + "attention.output.dense")
        i_w, i_b = lin(p + "intermediate.dense")
        o_w, o_b = lin(p + "output.dense")
        params["layers"].append(
            {
                "q_w": q_w, "q_b": q_b,
                "k_w": k_w, "k_b": k_b,
                "v_w": v_w, "v_b": v_b,
                "ao_w": ao_w, "ao_b": ao_b,
                "ao_ln_w": get(p + "attention.output.LayerNorm.weight"),
                "ao_ln_b": get(p + "attention.output.LayerNorm.bias"),
                "i_w": i_w, "i_b": i_b,
                "o_w": o_w, "o_b": o_b,
                "o_ln_w": get(p + "output.LayerNorm.weight"),
                "o_ln_b": get(p + "output.LayerNorm.bias"),
            }
        )
    return params


def _random_params(config: dict, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    h = config["hidden_size"]
    inter = config["intermediate_size"]

    def dense(n_in, n_out):
        return (
            rng.normal(0, 0.02, (n_in, n_out)).astype(np.float32),
            np.zeros(n_out, np.float32),
        )

    params = {
        "word_emb": rng.normal(
            0, 0.02, (config["vocab_size"], h)
        ).astype(np.float32),
        "pos_emb": rng.normal(
            0, 0.02, (config["max_position_embeddings"], h)
        ).astype(np.float32),
        "type_emb": rng.normal(0, 0.02, (2, h)).astype(np.float32),
        "emb_ln_w": np.ones(h, np.float32),
        "emb_ln_b": np.zeros(h, np.float32),
        "layers": [],
    }
    for _ in range(config["num_hidden_layers"]):
        q_w, q_b = dense(h, h)
        k_w, k_b = dense(h, h)
        v_w, v_b = dense(h, h)
        ao_w, ao_b = dense(h, h)
        i_w, i_b = dense(h, inter)
        o_w, o_b = dense(inter, h)
        params["layers"].append(
            {
                "q_w": q_w, "q_b": q_b,
                "k_w": k_w, "k_b": k_b,
                "v_w": v_w, "v_b": v_b,
                "ao_w": ao_w, "ao_b": ao_b,
                "ao_ln_w": np.ones(h, np.float32),
                "ao_ln_b": np.zeros(h, np.float32),
                "i_w": i_w, "i_b": i_b,
                "o_w": o_w, "o_b": o_b,
                "o_ln_w": np.ones(h, np.float32),
                "o_ln_b": np.zeros(h, np.float32),
            }
        )
    return params


_MINILM_CONFIG = {
    "hidden_size": 384,
    "num_hidden_layers": 6,
    "num_attention_heads": 12,
    "intermediate_size": 1536,
    "vocab_size": 30522,
    "max_position_embeddings": 512,
}


# ------------------------------------------------------------ the tokenizer


class WordPieceTokenizer:
    """The WordPiece pipeline a ``tokenizer.json`` describes, for the
    types listed in the module docstring: the words of its normalizer and
    pre-tokenizer (``_splitter``), greedy longest-match WordPiece
    (``wordpiece.wordpiece_word``), the post-processor's [CLS] ... [SEP]
    framing and, where the file asks for it, right truncation."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        if model.get("type") != "WordPiece":
            raise EmbeddingError(f"unsupported tokenizer model type: {model.get('type')!r}")
        if model.get("continuing_subword_prefix", "##") != "##" or model.get(
            "max_input_chars_per_word", wordpiece.MAX_CHARS_PER_WORD
        ) != wordpiece.MAX_CHARS_PER_WORD:
            raise EmbeddingError(
                "unsupported WordPiece settings: prefix "
                f"{model.get('continuing_subword_prefix')!r}, max chars "
                f"{model.get('max_input_chars_per_word')!r}"
            )
        self.vocab = dict(model["vocab"])
        self.unk = self.vocab[model.get("unk_token", "[UNK]")]
        self._split = _splitter(spec.get("normalizer"), spec.get("pre_tokenizer"))
        self._head, self._tail = _framing(spec.get("post_processor"), self.vocab)
        trunc = spec.get("truncation")
        if trunc is not None and trunc.get("direction", "Right") != "Right":
            raise EmbeddingError(f"unsupported truncation: {trunc!r}")
        self._max_len = None if trunc is None else int(trunc["max_length"])

    @classmethod
    def from_file(cls, path) -> "WordPieceTokenizer":
        return cls(json.loads(Path(path).read_text(encoding="utf-8")))

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def encode(self, text: str) -> list[int]:
        ids = []
        for word in self._split(text):
            pieces = wordpiece.wordpiece_word(self.vocab, word)
            ids.extend([self.vocab[p] for p in pieces] if pieces is not None else [self.unk])
        if self._max_len is not None:
            ids = ids[: max(0, self._max_len - len(self._head) - len(self._tail))]
        return [*self._head, *ids, *self._tail]


#: the BertNormalizer settings ``wordpiece.basic_tokenize`` implements (the
#: real MiniLM file's); strip_accents None follows lowercase
_BERT_NORMALIZER = {"clean_text": True, "handle_chinese_chars": True,
                    "strip_accents": None, "lowercase": True}
_WHITESPACE_SPLIT = re.compile(r"\w+|[^\w\s]+")


def _splitter(normalizer: Optional[dict], pre_tokenizer: Optional[dict]):
    """Text -> words for the (normalizer, pre-tokenizer) pair: BERT's
    basic tokenizer (``wordpiece.basic_tokenize``) or lowercase + the
    ``Whitespace`` split (``_WHITESPACE_SPLIT``); any other pair raises."""
    kinds = ((normalizer or {}).get("type"), (pre_tokenizer or {}).get("type"))
    if kinds == ("BertNormalizer", "BertPreTokenizer"):
        flags = {k: normalizer.get(k, v) for k, v in _BERT_NORMALIZER.items()}
        if flags["strip_accents"] is True:
            flags["strip_accents"] = None
        if flags != _BERT_NORMALIZER:
            raise EmbeddingError(f"unsupported BertNormalizer settings: {flags}")
        return wordpiece.basic_tokenize
    if kinds == ("Lowercase", "Whitespace"):
        return lambda text: _WHITESPACE_SPLIT.findall(text.lower())
    raise EmbeddingError(f"unsupported tokenizer normalizer / pre-tokenizer types: {kinds}")


def _framing(spec: Optional[dict], vocab: dict) -> tuple[list, list]:
    """The special-token ids before and after a single sequence."""
    kind = None if spec is None else spec.get("type")
    if kind != "TemplateProcessing":
        raise EmbeddingError(f"unsupported tokenizer post-processor type: {kind!r}")
    specials = spec.get("special_tokens", {})
    head, tail, seen = [], [], False
    for piece in spec["single"]:
        if "Sequence" in piece:
            seen = True
            continue
        name = piece["SpecialToken"]["id"]
        ids = specials[name]["ids"] if name in specials else [vocab[name]]
        (tail if seen else head).extend(int(i) for i in ids)
    return head, tail


# --------------------------------------------------------------- the embedder


class MiniLMEmbedder:
    """EmbeddingFunction backed by the BERT encoder on the index's device
    (``None`` is the CUDA card, and raises without one)."""

    def __init__(self, params: dict, tokenizer, config: dict, *, device=None):
        self._config = config
        self._device = resolve_device(device)
        self._encoder = BertEncoder(params, config, device=self._device)
        self._tokenizer = tokenizer
        self._max_len = min(config["max_position_embeddings"], 512)

    # -- constructors

    @classmethod
    def from_pretrained(cls, model_path: Optional[str] = None, *, device=None):
        """Load from the reference's on-disk layout
        (reference: src/embeddings.rs:219-259)."""
        model_dir = Path(model_path or DEFAULT_MODEL_PATH)
        tokenizer_path = model_dir / "tokenizer.json"
        if not tokenizer_path.exists():
            raise ModelFilesMissing(
                f"Tokenizer file not found: {tokenizer_path}. "
                "Please ensure the model is properly downloaded."
            )
        tokenizer = WordPieceTokenizer.from_file(tokenizer_path)
        config_path = model_dir / "config.json"
        if not config_path.exists():
            raise ModelFilesMissing(
                f"Config file not found: {config_path}. "
                "Please ensure the model is properly downloaded."
            )
        config = json.loads(config_path.read_text())
        weights_file = None
        for name in ("model.safetensors", "pytorch_model.bin"):
            if (model_dir / name).exists():
                weights_file = model_dir / name
                break
        if weights_file is None:
            raise ModelFilesMissing(
                f"Model weights file not found in {model_dir}. "
                "Please ensure the model is properly downloaded."
            )
        state = _load_torch_weights(weights_file)
        params = _map_hf_params(state, config["num_hidden_layers"])
        return cls(params, tokenizer, config, device=device)

    @classmethod
    def random_init(cls, seed: int = 0, config: Optional[dict] = None, *, device=None):
        """Deterministic random weights + a trivial whitespace tokenizer;
        exercises the full compute path without model files."""
        config = config or dict(_MINILM_CONFIG)
        params = _random_params(config, seed)
        return cls(params, _HashTokenizer(config["vocab_size"]), config, device=device)

    # -- EmbeddingFunction protocol

    @property
    def dimension(self) -> int:
        return self._config["hidden_size"]

    @property
    def device(self) -> torch.device:
        return self._device

    def generate_embedding(self, text: str) -> list[float]:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str]) -> list[list[float]]:
        """List-of-lists compat shim over the array path."""
        if not texts:
            return []
        out = self.embed_batch_arrays(texts).astype(np.float64)
        return [list(map(float, row)) for row in out]

    def embed_batch_arrays(self, texts: Sequence[str]) -> np.ndarray:
        """One batched forward -> one device->host fetch -> ``[B, D]`` f32
        ndarray (the serving path: indexes take the block directly via
        add_batch_arrays)."""
        if not texts:
            return np.zeros((0, self.dimension), np.float32)
        b = len(texts)
        ids, mask = tokenize_batch(self._tokenizer, texts, self._max_len)
        with torch.inference_mode():
            out = self._encoder(
                torch.from_numpy(ids).to(self._device),
                torch.from_numpy(mask).to(self._device),
            )
        return out.cpu().numpy()[:b]


def _sep_id_of(tokenizer) -> Optional[int]:
    """The tokenizer's [SEP] id, if it has one (a ``tokenizer.json``
    tokenizer looks it up; the random-init hash tokenizer has it as a
    class attribute)."""
    if isinstance(tokenizer, WordPieceTokenizer):
        return tokenizer.token_to_id("[SEP]")
    return getattr(tokenizer, "SEP", None)


def tokenize_batch(
    tokenizer, texts: Sequence[str], max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize and stage one batch into the padded ``[B_pad, L_pad]``
    int32 id/mask arrays the forward consumes (the JAX package's staging,
    unchanged, so both packages run the same padded shapes).

    * Length bucketing: L_pad is the smallest ``_LEN_BUCKETS`` entry
      covering the batch's longest sequence; B_pad is the next power of
      two.
    * Padding uses id 0 — BERT-family ``[PAD]`` — with mask 0, so pad
      rows/cols contribute nothing to attention.
    * Truncation preserves the trailing ``[SEP]``: over-long sequences
      keep their first ``max_len - 1`` tokens plus the separator
      (sentence-transformers' truncate-then-close semantics).
    """
    encodings = [tokenizer.encode(t) for t in texts]
    sep = _sep_id_of(tokenizer)
    staged = []
    for row in encodings:
        if len(row) > max_len:
            if sep is not None and row and row[-1] == sep:
                row = row[: max_len - 1] + [sep]
            else:
                row = row[:max_len]
        staged.append(row)
    max_seq = max((len(e) for e in staged), default=1)
    l_pad = next((b for b in _LEN_BUCKETS if b >= max_seq), max_len)
    b = len(staged)
    b_pad = 1 << (b - 1).bit_length() if b > 1 else 1
    ids = np.zeros((b_pad, l_pad), np.int32)
    mask = np.zeros((b_pad, l_pad), np.int32)
    for r, e in enumerate(staged):
        ids[r, : len(e)] = e
        mask[r, : len(e)] = 1
    return ids, mask


class _HashTokenizer:
    """Deterministic stand-in tokenizer for random-init mode: hashes
    whitespace tokens into the vocab, brackets with CLS/SEP ids."""

    CLS, SEP = 101, 102

    def __init__(self, vocab_size: int):
        self._vocab_size = vocab_size

    def token_id(self, tok: str) -> int:
        import hashlib

        h = int.from_bytes(
            hashlib.blake2b(tok.encode(), digest_size=4).digest(),
            "little",
        )
        return 1000 + h % (self._vocab_size - 1100)

    def encode(self, text: str) -> list[int]:
        return [self.CLS, *(self.token_id(tok) for tok in text.split()), self.SEP]
