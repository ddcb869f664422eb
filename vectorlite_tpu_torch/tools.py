"""JSONL dataset import/export tools, snapshot transfer, fsck.

Port of ``vectorlite_tpu/tools.py``. A local ``.vlc`` target builds its
collection on the CUDA card unless ``device=`` / ``--device`` says
otherwise (``cpu`` for the plain-torch paths); without a card it fails
with ``config.resolve_device``'s error rather than fall back to the CPU.

The reference's integration test hand-rolls a loader for a JSONL file of
precomputed embeddings (``{"id", "text", "embedding": [...]}`` per line,
reference: tests/integration_test.rs:20-36) directly against the library.
This module productizes that workflow in both directions:

* ``import_jsonl`` streams a JSONL file into a collection — either a
  local ``.vlc`` snapshot (no server, no embedder needed) or a running
  server over the raw-vector HTTP route (``RemoteClient.add_vectors``) —
  in batches, so multi-GB datasets never materialize in memory.
* ``export_jsonl`` writes a collection back out as JSONL (same record
  shape), paging through the listing route / index.

CLI::

    python -m vectorlite_tpu_torch.tools import data.jsonl -c docs --vlc out.vlc
    python -m vectorlite_tpu_torch.tools import data.jsonl -c docs \
        --url http://127.0.0.1:3001
    python -m vectorlite_tpu_torch.tools export out.jsonl -c docs --vlc in.vlc
    python -m vectorlite_tpu_torch.tools export out.jsonl -c docs --url ...

Field names are configurable (``--id-field/--text-field/
--embedding-field/--metadata-field``); the embedding field defaults to
``embedding`` with a fallback to ``values`` (both shapes exist in the
wild). If the first record carries an id every record must (explicit-id
ingestion keeps the file's ids); otherwise ids are auto-allocated.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Iterator, Optional

__all__ = ["import_jsonl", "export_jsonl", "fsck_dirs", "main"]

_DEFAULT_BATCH = 1024


def _iter_records(
    path: Path,
    *,
    id_field: str,
    text_field: str,
    embedding_field: Optional[str],
    metadata_field: str,
) -> Iterator[tuple]:
    """Yield ``(id_or_None, values, text, metadata)`` per JSONL line.
    Blank lines are skipped; malformed lines raise ValueError with the
    1-based line number."""
    with path.open("r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: invalid JSON: {e}") from None
            if not isinstance(row, dict):
                raise ValueError(f"{path}:{lineno}: expected a JSON object")
            if embedding_field is not None:
                values = row.get(embedding_field)
            else:
                values = row.get("embedding", row.get("values"))
            if not isinstance(values, list) or not values:
                raise ValueError(
                    f"{path}:{lineno}: missing/empty embedding field"
                )
            # strict numeric elements, matching the HTTP route's parsing
            # (bools/strings/nulls are 400s there — the two import
            # targets must agree on what a valid dataset is)
            if any(
                isinstance(x, bool) or not isinstance(x, (int, float))
                for x in values
            ):
                raise ValueError(
                    f"{path}:{lineno}: embedding elements must be numbers"
                )
            vid = row.get(id_field)
            text = row.get(text_field, "")
            if text is None:
                text = ""
            yield vid, values, str(text), row.get(metadata_field)


def _batches(records, batch_size: int):
    ids: list = []
    values: list = []
    texts: list = []
    metas: list = []
    for vid, vals, text, meta in records:
        ids.append(vid)
        values.append(vals)
        texts.append(text)
        metas.append(meta)
        if len(ids) >= batch_size:
            yield ids, values, texts, metas
            ids, values, texts, metas = [], [], [], []
    if ids:
        yield ids, values, texts, metas


def _check_vlc_name(col, collection: str, vlc_path: Path) -> None:
    """A .vlc snapshot holds exactly one collection; silently operating
    on a different one than the user named would hide typos (and append
    would re-save under the file's original name, not the requested
    one)."""
    if col.name != collection:
        raise ValueError(
            f"{vlc_path} contains collection '{col.name}', "
            f"not '{collection}'"
        )


class _LocalTarget:
    """A collection inside a .vlc snapshot: created fresh (Flat) or
    appended to, saved atomically on close. Its index lives on
    ``device`` (None: the CUDA card)."""

    def __init__(self, vlc_path: Path, collection: str, append: bool, device=None):
        from .config import resolve_device
        from .store.collection import Collection

        self._path = vlc_path
        self._device = resolve_device(device)
        if append and vlc_path.exists():
            self._col = Collection.load_from_file(vlc_path, device=self._device)
            _check_vlc_name(self._col, collection, vlc_path)
        else:
            self._col = None  # created lazily once the dimension is known
        self._name = collection

    def add(self, ids, values, texts, metas) -> list[int]:
        if self._col is None:
            from .index.flat import FlatIndex
            from .store.collection import Collection

            self._col = Collection(
                self._name, FlatIndex(len(values[0]), device=self._device)
            )
        return self._col.add_vectors(values, texts, metas, ids)

    def finish(self) -> None:
        if self._col is not None:
            self._col.save_to_file(self._path)

    def page(self, offset: int, limit: int):
        vectors, total = self._col.list_vectors(
            offset, limit, include_values=True
        )
        return vectors, total

    @classmethod
    def for_export(
        cls, vlc_path: Path, collection: str, device=None
    ) -> "_LocalTarget":
        from .config import resolve_device
        from .store.collection import Collection

        t = cls.__new__(cls)
        t._path = vlc_path
        t._device = resolve_device(device)
        t._col = Collection.load_from_file(vlc_path, device=t._device)
        _check_vlc_name(t._col, collection, vlc_path)
        t._name = collection
        return t


class _RemoteTarget:
    """A collection on a running server, over the raw-vector routes."""

    def __init__(
        self, url: str, collection: str, create: bool, api_key=None
    ):
        from .remote import RemoteClient

        self._rc = RemoteClient(url, api_key=api_key)
        self._name = collection
        self._create = create
        self._checked = False

    def _ensure(self, dim: int) -> None:
        """Fail fast on a dimension mismatch: a server collection's width
        comes from ITS embedder (reference: src/client.rs:88), so a
        dataset of a different width could never insert — surface that
        as one clear error instead of a per-batch rejection, and don't
        leave behind an auto-created collection that can't take the data."""
        if self._rc.has_collection(self._name):
            got = int(self._rc.get_collection_info(self._name)["dimension"])
            if got != dim:
                raise ValueError(
                    f"collection '{self._name}' has dimension {got} but "
                    f"the dataset rows have {dim}"
                )
            return
        if not self._create:
            return  # let the server 404 with its canonical message
        self._rc.create_collection(self._name, "flat")
        got = int(self._rc.get_collection_info(self._name)["dimension"])
        if got != dim:
            self._rc.delete_collection(self._name)
            raise ValueError(
                f"the server's embedder dimension is {got} but the dataset "
                f"rows have {dim}; create collection '{self._name}' against "
                "a matching embedder first"
            )

    def add(self, ids, values, texts, metas) -> list[int]:
        if not self._checked:
            self._ensure(len(values[0]))
            self._checked = True
        return self._rc.add_vectors(self._name, values, texts, metas, ids)

    def finish(self) -> None:
        pass

    def page(self, offset: int, limit: int):
        # the server's listing route rejects (not clamps) limit > 1000
        return self._rc.list_vectors(
            self._name, offset, min(limit, 1000), include_values=True
        )


def import_jsonl(
    file: str,
    collection: str,
    *,
    url: Optional[str] = None,
    vlc: Optional[str] = None,
    append: bool = False,
    batch_size: int = _DEFAULT_BATCH,
    id_field: str = "id",
    text_field: str = "text",
    embedding_field: Optional[str] = None,
    metadata_field: str = "metadata",
    api_key: Optional[str] = None,
    progress=None,
    device=None,
) -> int:
    """Stream a JSONL file of precomputed embeddings into ``collection``.
    Exactly one of ``url`` (running server) or ``vlc`` (snapshot file)
    must be given; a ``vlc`` target is built on ``device`` (None: the
    CUDA card). Returns the number of records imported."""
    if (url is None) == (vlc is None):
        raise ValueError("exactly one of url= or vlc= is required")
    target = (
        _RemoteTarget(url, collection, create=True, api_key=api_key)
        if url is not None
        else _LocalTarget(Path(vlc), collection, append, device)
    )
    records = _iter_records(
        Path(file),
        id_field=id_field,
        text_field=text_field,
        embedding_field=embedding_field,
        metadata_field=metadata_field,
    )
    total = 0
    explicit: Optional[bool] = None
    for ids, values, texts, metas in _batches(records, batch_size):
        if explicit is None:
            # all-or-none: the file's first record decides whether the
            # dataset keeps its own ids (then every record needs one)
            explicit = ids[0] is not None
        if explicit and any(i is None for i in ids):
            raise ValueError(
                "record missing an id after earlier records carried ids "
                "(explicit ids are all-or-none)"
            )
        if not explicit and any(i is not None for i in ids):
            raise ValueError(
                "record carries an id after earlier records had none "
                "(explicit ids are all-or-none; auto-allocation would "
                "silently discard the file's ids)"
            )
        target.add(ids if explicit else None, values, texts, metas)
        total += len(values)
        if progress:
            progress(total)
    target.finish()
    return total


def export_jsonl(
    file: str,
    collection: str,
    *,
    url: Optional[str] = None,
    vlc: Optional[str] = None,
    batch_size: int = _DEFAULT_BATCH,
    api_key: Optional[str] = None,
    progress=None,
    device=None,
) -> int:
    """Write ``collection`` out as JSONL (``{"id", "text", "embedding",
    "metadata"?}`` per line, insertion order); a ``vlc`` source is loaded
    on ``device`` (None: the CUDA card). Returns the record count."""
    if (url is None) == (vlc is None):
        raise ValueError("exactly one of url= or vlc= is required")
    target = (
        _RemoteTarget(url, collection, create=False, api_key=api_key)
        if url is not None
        else _LocalTarget.for_export(Path(vlc), collection, device)
    )
    # write via tmp + atomic rename (same posture as .vlc save): a
    # re-run that fails early (missing collection, server down) must
    # not have already truncated the previous export
    out_path = Path(file)
    tmp_path = out_path.with_name(out_path.name + ".tmp")
    total = 0
    try:
        with tmp_path.open("w", encoding="utf-8") as out:
            offset = 0
            while True:
                vectors, _ = target.page(offset, batch_size)
                if not vectors:
                    break
                for v in vectors:
                    row = {
                        "id": v.id,
                        "text": v.text,
                        "embedding": [float(x) for x in v.values],
                    }
                    if v.metadata is not None:
                        row["metadata"] = v.metadata
                    out.write(json.dumps(row) + "\n")
                total += len(vectors)
                offset += len(vectors)
                if progress:
                    progress(total)
    except BaseException:
        tmp_path.unlink(missing_ok=True)
        raise
    tmp_path.replace(out_path)
    return total


def fsck_dirs(
    autosave_dir=None, wal_dir=None, deep: bool = False, device=None
) -> dict:
    """Offline health report for the durability directories (autosave
    snapshots + write-ahead logs) — what an operator runs before/after
    a crash-recovery or migration.

    Light by default: snapshot headers are sniffed from the document
    prefix (a 10M-row .vlc is ~30 GB; ``deep=True`` fully parses each
    snapshot instead, on ``device``: None is the CUDA card). WAL files are scanned with the same
    torn-tail-tolerant reader recovery uses, so the report's
    ``replayable_ops`` is exactly what a restart would apply.

    Returns ``{"collections": {name: {...}}, "warnings": [...],
    "ok": bool}``; ``ok`` is False when any snapshot is unreadable or a
    WAL has neither a covering snapshot nor a create header (recovery
    would skip it)."""
    import re

    from .config import resolve_device
    from .store.wal import iter_owned_files, scan_log

    report: dict = {"collections": {}, "warnings": [], "ok": True}

    def entry(name):
        return report["collections"].setdefault(
            name, {"snapshot": None, "wal": None}
        )

    if autosave_dir is not None and Path(autosave_dir).is_dir():
        for p in sorted(Path(autosave_dir).iterdir()):
            if p.suffix != ".vlc" or not p.is_file():
                continue
            info: dict = {"path": str(p), "bytes": p.stat().st_size}
            name = None
            try:
                if deep:
                    from .persist.vlc import load_collection_from_file

                    col = load_collection_from_file(
                        p, device=resolve_device(device)
                    )
                    name = col.name
                    ci = col.get_info()
                    info.update(
                        parses=True, vector_count=ci.count,
                        dimension=ci.dimension,
                    )
                else:
                    head = p.open("rb").read(65536).decode(
                        "utf-8", "replace"
                    )
                    fields = dict(
                        re.findall(
                            r'"(version|format|name|index_type)":\s*"'
                            r'([^"]*)"',
                            head,
                        )
                    )
                    counts = dict(
                        re.findall(
                            r'"(vector_count|dimension)":\s*(\d+)', head
                        )
                    )
                    name = fields.get("name")
                    info.update(
                        header_version=fields.get("version"),
                        vector_count=int(counts.get("vector_count", -1)),
                        dimension=int(counts.get("dimension", -1)),
                        index_type=fields.get("index_type"),
                    )
                    if fields.get("format") != "vectorlite-collection":
                        raise ValueError("bad format field")
            except Exception as e:  # noqa: BLE001 — diagnostic tool
                report["ok"] = False
                report["warnings"].append(
                    f"snapshot {p.name}: unreadable ({e})"
                )
                info["error"] = str(e)
            entry(name or p.stem)["snapshot"] = info

    if wal_dir is not None and Path(wal_dir).is_dir():
        for p, name in iter_owned_files(wal_dir, ".wal"):
            size = p.stat().st_size
            # same intact rule resume/recovery applies (wal.scan_log)
            entries, intact = scan_log(p)
            ops: dict = {}
            for e in entries:
                ops[e.get("op", "?")] = ops.get(e.get("op", "?"), 0) + 1
            last_drop = max(
                (
                    i
                    for i, e in enumerate(entries)
                    if e.get("op") == "drop"
                ),
                default=None,
            )
            replayable = (
                len(entries)
                if last_drop is None
                else len(entries) - last_drop - 1
            )
            info = {
                "path": str(p),
                "bytes": size,
                "entries": len(entries),
                "replayable_ops": replayable,
                "ops": ops,
                "seq_range": [
                    int(entries[0].get("s", 0)) if entries else 0,
                    int(entries[-1].get("s", 0)) if entries else 0,
                ],
            }
            if intact < size:
                info["torn_tail"] = True
                report["warnings"].append(
                    f"wal {p.name}: torn tail (resume will truncate; "
                    "the partial op was never acknowledged)"
                )
            if last_drop is not None and replayable == 0:
                report["warnings"].append(
                    f"wal {p.name}: drop tombstone — recovery will "
                    "discard this collection"
                )
            e = entry(name)
            e["wal"] = info
            if (
                replayable
                and e["snapshot"] is None
                and not any(x.get("op") == "create" for x in entries)
            ):
                report["ok"] = False
                report["warnings"].append(
                    f"wal {p.name}: no covering snapshot and no create "
                    "header — recovery would skip these ops"
                )
    return report


_HF_REPO = "sentence-transformers/all-MiniLM-L6-v2"
_MODEL_FILES = ("config.json", "tokenizer.json")
_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


def fetch_model(
    repo: str = _HF_REPO,
    dest: Optional[str] = None,
    revision: str = "main",
    progress=None,
) -> Path:
    """Download the embedding model into the reference's on-disk layout
    (``./models/all-MiniLM-L6-v2`` — src/embeddings.rs:190), where
    ``MiniLMEmbedder.from_pretrained()`` (this package's and the JAX
    package's), the CLI and the real-model test harness
    (tests/test_real_model.py) find it.

    Fetches config.json + tokenizer.json + the first available weight
    file (model.safetensors, else pytorch_model.bin) from the Hugging
    Face hub via plain HTTPS — no hub SDK needed. Files already present
    are kept (delete to re-fetch). Requires network egress; in an
    air-gapped environment, copy the files in by hand instead — the
    layout is just those three files in one directory."""
    import urllib.error
    import urllib.request

    dest_dir = Path(dest or f"./models/{repo.rsplit('/', 1)[-1]}")
    dest_dir.mkdir(parents=True, exist_ok=True)
    base = f"https://huggingface.co/{repo}/resolve/{revision}"

    def grab(name: str, required: bool) -> bool:
        out = dest_dir / name
        if out.exists() and out.stat().st_size > 0:
            if progress:
                progress(f"{name}: already present, keeping")
            return True
        tmp = out.with_suffix(out.suffix + ".part")
        try:
            with urllib.request.urlopen(
                f"{base}/{name}", timeout=60
            ) as r, open(tmp, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            tmp.replace(out)
            if progress:
                progress(f"{name}: {out.stat().st_size} bytes")
            return True
        except (urllib.error.URLError, OSError) as e:
            tmp.unlink(missing_ok=True)
            if required:
                raise RuntimeError(
                    f"failed to fetch {base}/{name}: {e}"
                ) from e
            return False

    for name in _MODEL_FILES:
        grab(name, required=True)
    if not any((dest_dir / w).exists() for w in _WEIGHT_FILES):
        if not grab(_WEIGHT_FILES[0], required=False):
            grab(_WEIGHT_FILES[1], required=True)
    return dest_dir


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vectorlite_tpu_torch.tools",
        description="JSONL dataset import/export for vectorlite_tpu_torch",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, help_ in (
        ("import", "stream a JSONL file into a collection"),
        ("export", "write a collection out as JSONL"),
    ):
        p = sub.add_parser(name, help=help_)
        p.add_argument("file", help="JSONL file path")
        p.add_argument("-c", "--collection", required=True)
        group = p.add_mutually_exclusive_group(required=True)
        group.add_argument("--url", help="running server base URL")
        group.add_argument("--vlc", help=".vlc snapshot path (no server)")
        p.add_argument("--batch", type=int, default=_DEFAULT_BATCH)
        p.add_argument(
            "--device", default=None,
            help="torch device of a --vlc collection (default: the CUDA "
            "card; 'cpu' for the plain-torch paths)",
        )
        p.add_argument(
            "--api-key",
            default=None,
            help="bearer token for an auth-enabled server "
            "(default: $VECTORLITE_API_KEY)",
        )
        if name == "import":
            p.add_argument(
                "--append", action="store_true",
                help="append to an existing .vlc instead of replacing",
            )
            p.add_argument("--id-field", default="id")
            p.add_argument("--text-field", default="text")
            p.add_argument(
                "--embedding-field", default=None,
                help="default: 'embedding', falling back to 'values'",
            )
            p.add_argument("--metadata-field", default="metadata")
    for name, help_ in (
        ("snapshot", "download a collection's .vlc over HTTP"),
        ("restore", "upload a .vlc to create a collection over HTTP"),
    ):
        p = sub.add_parser(name, help=help_)
        p.add_argument("file", help=".vlc file path")
        p.add_argument("-c", "--collection", required=True)
        p.add_argument("--url", required=True, help="server base URL")
        p.add_argument(
            "--api-key",
            default=None,
            help="bearer token for an auth-enabled server "
            "(default: $VECTORLITE_API_KEY)",
        )
    p = sub.add_parser(
        "fetch-model",
        help="download the embedding model into ./models/ "
        "(where the real-model tests find it)",
    )
    p.add_argument(
        "--repo", default=_HF_REPO,
        help=f"Hugging Face repo id (default: {_HF_REPO})",
    )
    p.add_argument(
        "--dest", default=None,
        help="target directory (default: ./models/<repo-name>)",
    )
    p.add_argument("--revision", default="main")
    p = sub.add_parser(
        "fsck",
        help="offline health report for autosave/WAL directories",
    )
    p.add_argument(
        "--autosave-dir", default=None, help="snapshot directory"
    )
    p.add_argument("--wal-dir", default=None, help="oplog directory")
    p.add_argument(
        "--deep", action="store_true",
        help="fully parse each snapshot (slow at multi-GB scale) "
        "instead of sniffing the header prefix",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device --deep loads on (default: the CUDA card)",
    )
    p.add_argument("--json", action="store_true", dest="as_json")
    args = parser.parse_args(argv)
    if args.cmd == "fetch-model":
        dest = fetch_model(
            repo=args.repo,
            dest=args.dest,
            revision=args.revision,
            progress=lambda m: print(f"  {m}", file=sys.stderr),
        )
        print(f"model ready at {dest}")
        print(
            "run `python -m pytest tests/test_real_model.py -q` to "
            "activate the real-model parity harness"
        )
        return 0
    if args.cmd == "fsck":
        if not args.autosave_dir and not args.wal_dir:
            parser.error("fsck needs --autosave-dir and/or --wal-dir")
        report = fsck_dirs(
            args.autosave_dir, args.wal_dir, deep=args.deep,
            device=args.device,
        )
        if args.as_json:
            print(json.dumps(report, indent=2))
        else:
            for name, e in sorted(report["collections"].items()):
                snap, wal = e["snapshot"], e["wal"]
                bits = []
                if snap:
                    bits.append(
                        f"snapshot {snap.get('vector_count', '?')} "
                        f"vectors, {snap['bytes']} B"
                        + (" [UNREADABLE]" if "error" in snap else "")
                    )
                if wal:
                    bits.append(
                        f"wal {wal['replayable_ops']} replayable op(s), "
                        f"{wal['bytes']} B"
                        + (" [torn tail]" if wal.get("torn_tail") else "")
                    )
                print(f"{name}: " + "; ".join(bits or ["(nothing)"]))
            for w in report["warnings"]:
                print(f"warning: {w}", file=sys.stderr)
            print("ok" if report["ok"] else "PROBLEMS FOUND")
        return 0 if report["ok"] else 1
    if args.api_key is None:
        import os

        args.api_key = os.environ.get("VECTORLITE_API_KEY") or None

    def progress(n, _last=[0]):
        if n - _last[0] >= 10 * args.batch:
            _last[0] = n
            print(f"  ... {n} records", file=sys.stderr)

    if args.cmd in ("snapshot", "restore"):
        from .remote import RemoteClient

        rc = RemoteClient(args.url, api_key=args.api_key)
        if args.cmd == "snapshot":
            n = rc.download_snapshot(args.collection, args.file)
            print(
                f"downloaded snapshot of '{args.collection}' "
                f"({n} bytes) to {args.file}"
            )
        else:
            n = rc.restore_snapshot(args.collection, args.file)
            print(
                f"restored '{args.collection}' from {args.file} "
                f"({n} vectors)"
            )
        return 0

    if args.cmd == "import":
        n = import_jsonl(
            args.file,
            args.collection,
            url=args.url,
            vlc=args.vlc,
            append=args.append,
            batch_size=args.batch,
            id_field=args.id_field,
            text_field=args.text_field,
            embedding_field=args.embedding_field,
            metadata_field=args.metadata_field,
            api_key=args.api_key,
            progress=progress,
            device=args.device,
        )
        print(f"imported {n} records into '{args.collection}'")
    else:
        n = export_jsonl(
            args.file,
            args.collection,
            url=args.url,
            vlc=args.vlc,
            batch_size=args.batch,
            api_key=args.api_key,
            progress=progress,
            device=args.device,
        )
        print(f"exported {n} records from '{args.collection}'")
    return 0


if __name__ == "__main__":
    sys.exit(main())
