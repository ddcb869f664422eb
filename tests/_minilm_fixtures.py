"""Writers of synthetic MiniLM model directories, the files the port's
``MiniLMEmbedder.from_pretrained`` reads: the tests and ``chip_smoke.py``
use them while real weights are not in the repository."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def hash_vocab(tokenizer, words) -> dict[str, int]:
    """A WordPiece vocabulary giving each of ``words`` (lowercase, no
    punctuation) the id ``tokenizer`` (a ``minilm._HashTokenizer``) gives
    it, so a ``tokenizer.json`` of it tokenizes texts of those words as
    that tokenizer does."""
    vocab = {"[PAD]": 0, "[UNK]": 100, "[CLS]": tokenizer.CLS, "[SEP]": tokenizer.SEP}
    vocab.update((w, tokenizer.token_id(w)) for w in words)
    return vocab


def hf_state_dict(params: dict) -> dict[str, np.ndarray]:
    """The inverse of ``_map_hf_params``: the pytree under HF bert-*
    names, dense weights back to torch's [out, in]."""
    state = {
        "embeddings.word_embeddings.weight": params["word_emb"],
        "embeddings.position_embeddings.weight": params["pos_emb"],
        "embeddings.token_type_embeddings.weight": params["type_emb"],
        "embeddings.LayerNorm.weight": params["emb_ln_w"],
        "embeddings.LayerNorm.bias": params["emb_ln_b"],
    }
    dense = (
        ("attention.self.query", "q"), ("attention.self.key", "k"),
        ("attention.self.value", "v"), ("attention.output.dense", "ao"),
        ("intermediate.dense", "i"), ("output.dense", "o"),
    )
    for i, layer in enumerate(params["layers"]):
        p = f"encoder.layer.{i}."
        for hf, ours in dense:
            state[p + hf + ".weight"] = np.asarray(layer[ours + "_w"]).T
            state[p + hf + ".bias"] = layer[ours + "_b"]
        for hf, ours in (("attention.output.LayerNorm", "ao_ln"), ("output.LayerNorm", "o_ln")):
            state[p + hf + ".weight"] = layer[ours + "_w"]
            state[p + hf + ".bias"] = layer[ours + "_b"]
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in state.items()}


def save_safetensors(path, tensors: dict[str, np.ndarray]) -> None:
    """Write f32 arrays in the layout ``load_safetensors`` reads."""
    header, offset = {}, 0
    for name, a in tensors.items():
        n = a.size * 4
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a, dtype="<f4").tobytes())


def save_model_dir(path, params: dict, config: dict, vocab: dict[str, int], *,
                   weights: str = "pytorch_model.bin") -> Path:
    """Write a model directory ``from_pretrained`` reads: ``config.json``,
    the weights (``pytorch_model.bin`` through ``torch.save`` or
    ``model.safetensors``) and a WordPiece ``tokenizer.json`` of ``vocab``
    (which needs [UNK], [CLS] and [SEP]) with the real MiniLM file's
    normalizer, pre-tokenizer and post-processor types."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    state = hf_state_dict(params)
    if weights == "model.safetensors":
        save_safetensors(path / weights, state)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path / weights)
    cls_id, sep_id = vocab["[CLS]"], vocab["[SEP]"]
    tokenizer = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [],
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
            "special_tokens": {
                "[CLS]": {"id": "[CLS]", "ids": [cls_id], "tokens": ["[CLS]"]},
                "[SEP]": {"id": "[SEP]", "ids": [sep_id], "tokens": ["[SEP]"]},
            },
        },
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": vocab},
    }
    (path / "tokenizer.json").write_text(json.dumps(tokenizer))
    return path
