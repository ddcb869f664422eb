"""CLI entry point: ``python -m vectorlite_tpu_torch.cli``.

Port of ``vectorlite_tpu/cli.py`` (reference: src/main.rs:6-51):
``--filepath`` preloads one ``.vlc`` collection, ``--port`` defaults to
3001, ``--host`` to 127.0.0.1; ``--autosave-dir`` restores its snapshots
and ``--wal-dir`` replays its logs before the server starts.

The server runs on the CUDA card; ``--device cpu`` asks for the CPU (the
tests do). Without a card and without ``--device``, it fails with
``config.resolve_device``'s error and never falls back to the CPU.

The embedder is the MiniLM encoder loaded from ``--model-path`` on the
server's device (``embed/minilm.py``; the encoder never falls back to the
CPU). Where the model files are missing the CLI serves the deterministic
mock with the JAX CLI's warning; ``--mock-embeddings`` asks for the mock.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

logger = logging.getLogger("vectorlite_tpu_torch.cli")


def build_embedder(model_path: str | None, mock: bool, device=None):
    """The MiniLM encoder of ``model_path`` on ``device`` (None: the CUDA
    card); the mock where ``mock`` is set or the model files are missing
    (with the JAX CLI's warning). Any other loading error raises."""
    from .embed.minilm import MiniLMEmbedder, ModelFilesMissing
    from .embed.mock import MockEmbeddingFunction

    if mock:
        return MockEmbeddingFunction()
    try:
        return MiniLMEmbedder.from_pretrained(model_path, device=device)
    except ModelFilesMissing as e:
        logger.warning("Could not load embedding model (%s); using mock embedder", e)
        return MockEmbeddingFunction()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vectorlite_tpu_torch.cli",
        description=(
            "VectorLite on PyTorch and CUDA - an in-memory vector database "
            "optimized for AI agent workloads"
        ),
    )
    parser.add_argument(
        "-f", "--filepath", default=None, help="Preload a .vlc collection"
    )
    parser.add_argument("-p", "--port", type=int, default=3001)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument(
        "--model-path",
        default=os.environ.get("VECTORLITE_MODEL_PATH"),
        help="Path to a MiniLM model dir (tokenizer.json + weights); "
        "defaults to $VECTORLITE_MODEL_PATH or ./models/all-MiniLM-L6-v2",
    )
    parser.add_argument(
        "--mock-embeddings",
        action="store_true",
        help="Use the deterministic mock embedder (no model files needed)",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="torch device to serve on (default: the CUDA card; 'cpu' runs "
        "the plain-torch paths on the CPU)",
    )
    parser.add_argument(
        "--api-key",
        default=os.environ.get("VECTORLITE_API_KEY"),
        help="Require 'Authorization: Bearer <key>' (or X-API-Key) on "
        "every route except GET /health (extension; the reference "
        "server is unauthenticated). Defaults to $VECTORLITE_API_KEY; "
        "pass --api-key '' to serve unauthenticated even when the env "
        "var is set",
    )
    parser.add_argument(
        "--autosave-dir",
        default=os.environ.get("VECTORLITE_AUTOSAVE_DIR"),
        help="Directory for periodic crash-resume snapshots; collections "
        "found there are restored at startup and dirty ones re-saved "
        "every --autosave-interval seconds (extension; the reference "
        "only saves on explicit POST .../save)",
    )
    parser.add_argument(
        "--autosave-interval",
        type=float,
        default=float(os.environ.get("VECTORLITE_AUTOSAVE_INTERVAL", 30.0)),
        help="Seconds between autosave ticks (default 30)",
    )
    parser.add_argument(
        "--wal-dir",
        default=os.environ.get("VECTORLITE_WAL_DIR"),
        help="Directory for per-collection write-ahead oplogs: every "
        "acknowledged mutation is appended before the call returns, so "
        "a crash replays forward to the last write instead of rewinding "
        "to the last snapshot. Pair with --autosave-dir (snapshots "
        "rotate the logs); without it the log grows until a snapshot "
        "exists. Fsync policy: $VECTORLITE_WAL_FSYNC=batch|always|off",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    logger.info("Starting VectorLite server...")
    logger.info("Host: %s", args.host)
    logger.info("Port: %s", args.port)

    from .config import resolve_device
    from .store.client import VectorLiteClient

    device = resolve_device(args.device)
    logger.info("Device: %s", device)
    client = VectorLiteClient(
        build_embedder(args.model_path, args.mock_embeddings, device), device=device
    )

    if args.filepath:
        from .persist.vlc import load_collection_from_file

        logger.info("Loading collection from VLC file: %s", args.filepath)
        collection = load_collection_from_file(
            args.filepath, **client.flat_index_kwargs()
        )
        client.add_collection(collection)
        logger.info(
            "Successfully loaded collection '%s' from %s",
            collection.name,
            args.filepath,
        )
    else:
        logger.info("Starting with empty server - no collections loaded")

    autosave = None
    if args.autosave_dir:
        from .store.autosave import restore_into

        restored = restore_into(
            client, args.autosave_dir, **client.flat_index_kwargs()
        )
        if restored:
            logger.info("Restored collections: %s", restored)

    wal_manager = None
    if args.wal_dir:
        from .store import wal as _wal

        # recovery order: snapshots above rewound to the last autosave;
        # the logs now replay forward to the last acknowledged write
        # (and re-snapshot + rotate when an autosave dir exists)
        recovered = _wal.recover_into(
            client,
            args.wal_dir,
            snapshot_dir=args.autosave_dir or None,
        )
        if recovered:
            logger.info("WAL recovery applied: %s", recovered)
        wal_manager = _wal.WalManager(
            args.wal_dir, snapshot_dir=args.autosave_dir or None
        )
        client.set_collection_observer(wal_manager)
        if not args.autosave_dir:
            logger.warning(
                "--wal-dir without --autosave-dir: logs are only "
                "rotated by snapshots, so they will grow unboundedly"
            )

    if args.autosave_dir:
        from .store.autosave import AutosaveDaemon

        autosave = AutosaveDaemon(
            client, args.autosave_dir, interval_s=args.autosave_interval
        ).start()

    from .api.server import start_server

    # pass '' through unchanged: an explicit --api-key '' must disable
    # auth (create_app only falls back to the env var on None)
    start_server(
        client, args.host, args.port, autosave=autosave,
        api_key=args.api_key, wal=wal_manager,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
