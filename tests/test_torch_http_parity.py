"""The port's HTTP server against the JAX package's aiohttp app, route by
route.

Both apps run on the CPU over real sockets on ephemeral localhost ports,
each over its own client with the same 16-d mock embedder: the JAX app on
aiohttp in a thread (as tests/test_remote.py runs it), the port's on the
standard library (``api.server.bind``). One seeded request script goes to
both through ``http.client``; every answer must agree in status, content
type, the CORS headers (and ``Allow`` / ``Content-Disposition``), and its
body: JSON bodies exactly except scores (within 1e-5), text bodies exactly
after masking what is the run's own (temporary paths, timestamps,
latencies, process-wide counters); ``/stats`` by its route keys and
counts.

HNSW collections get a script of their own, once for each metric
(``hnsw_steps``): create, inserts, searches with ``ef``, filters,
mutations, compaction, save and load, and the snapshot round trip.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import re
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np
import pytest

import vectorlite_tpu as jvl
import vectorlite_tpu_torch as tvl
from vectorlite_tpu.api.server import create_app as jax_create_app
from vectorlite_tpu_torch.api import server as port_server

DIM = 16
SCORE_TOL = 1e-5
COMPARED_HEADERS = ("access-control-allow-origin", "access-control-allow-methods",
                    "access-control-allow-headers", "allow", "content-disposition")


@pytest.fixture(autouse=True, scope="module")
def _jax_search_pool_off():
    """The JAX package's native search pool can read a builder freed right
    after a batched search (ROADMAP §3): its batched HNSW searches here
    run on the calling thread."""
    import os

    before = os.environ.get("VECTORLITE_SEARCH_THREADS")
    os.environ["VECTORLITE_SEARCH_THREADS"] = "1"
    yield
    if before is None:
        del os.environ["VECTORLITE_SEARCH_THREADS"]
    else:
        os.environ["VECTORLITE_SEARCH_THREADS"] = before


class _JaxServer:
    """The JAX package's aiohttp app on 127.0.0.1:<ephemeral> in its own
    event loop."""

    def __init__(self, client, api_key=None):
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._app = lambda: jax_create_app(client, api_key=api_key)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._started.wait(30):
            raise RuntimeError("the aiohttp server did not start")

    def _run(self):
        from aiohttp import web

        asyncio.set_event_loop(self._loop)
        self._runner = web.AppRunner(self._app())
        self._loop.run_until_complete(self._runner.setup())
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        self._loop.run_until_complete(site.start())
        self.port = self._runner.addresses[0][1]
        self._started.set()
        self._loop.run_forever()

    def close(self):
        asyncio.run_coroutine_threadsafe(self._runner.cleanup(), self._loop).result(10)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(10)


class _PortServer:
    def __init__(self, client, api_key=None):
        self._server = port_server.bind(
            port_server.create_app(client, api_key=api_key)).start()
        self.port = self._server.port

    def close(self):
        self._server.close()


@dataclass
class Answer:
    status: int
    headers: dict
    body: bytes

    @property
    def content_type(self):
        return self.headers.get("content-type")


def exchange(port: int, method: str, path: str, body=None, headers=None,
             chunks=None) -> Answer:
    """One request on a fresh connection. ``body``: a dict or list (sent as
    JSON), str or bytes (sent as is); ``chunks``: byte strings sent with
    chunked transfer encoding."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        headers = dict(headers or {})
        if chunks is not None:
            headers["Transfer-Encoding"] = "chunked"
            conn.request(method, path, body=iter(chunks), headers=headers,
                         encode_chunked=True)
        else:
            if isinstance(body, (dict, list)):
                body = json.dumps(body)
                headers.setdefault("Content-Type", "application/json")
            if isinstance(body, str):
                body = body.encode("utf-8")
            conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return Answer(resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read())
    finally:
        conn.close()


@dataclass
class Step:
    method: str
    path: str
    body: Union[None, dict, list, str, bytes, Callable] = None
    headers: dict = field(default_factory=dict)
    chunks: Optional[list] = None
    #: what is compared besides status and headers: "json" (a JSON body
    #: as JSON, any other as text), "text", "stats", "metrics" or
    #: "snapshot"
    kind: str = "json"


class Side:
    """One server and what the script keeps of its answers."""

    def __init__(self, name, server, tmp):
        self.name = name
        self.server = server
        self.tmp = str(tmp)
        self.snapshot = b""

    def send(self, step: Step) -> Answer:
        body = step.body(self) if callable(step.body) else step.body
        if isinstance(body, (dict, list)):
            body = json.loads(json.dumps(body).replace("<tmp>", self.tmp))
        return exchange(self.server.port, step.method, step.path.replace("<tmp>", self.tmp),
                        body, step.headers, step.chunks)

    def masked(self, raw: bytes) -> str:
        text = raw.decode("utf-8", "replace").replace(self.tmp, "<tmp>")
        return re.sub(r"\d{4}-\d\d-\d\dT[\d:.]+Z", "<time>", text)


def close_enough(a, b, path="$"):
    """JSON values equal, except "score" members within SCORE_TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, a, b)
        for key in a:
            if key == "score":
                assert abs(a[key] - b[key]) <= SCORE_TOL, (path, a[key], b[key])
            else:
                close_enough(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            close_enough(x, y, f"{path}[{i}]")
    else:
        assert a == b and type(a) is type(b), (path, a, b)


_VOLATILE = re.compile(r"^(vectorlite_request_latency_seconds|vectorlite_coalesce_|"
                       r"vectorlite_filter_)\S* ")


def compare(step: Step, jax_side: Side, port_side: Side, a: Answer, b: Answer) -> None:
    where = f"{step.method} {step.path}"
    assert (a.status, a.content_type) == (b.status, b.content_type), (where, a, b)
    for h in COMPARED_HEADERS:
        assert a.headers.get(h) == b.headers.get(h), (where, h, a.headers, b.headers)
    is_json = (a.content_type or "").startswith("application/json")
    if step.method == "HEAD" or step.kind == "text" or (step.kind == "json" and not is_json):
        assert jax_side.masked(a.body) == port_side.masked(b.body), where
    elif step.kind == "json":
        if a.body or b.body:
            close_enough(json.loads(jax_side.masked(a.body)),
                         json.loads(port_side.masked(b.body)), where)
    elif step.kind == "stats":
        sa, sb = json.loads(a.body), json.loads(b.body)
        assert sorted(sa) == sorted(sb), where
        routes = [k for k in sa if " " in k]
        assert {r: (sa[r]["count"], sa[r]["errors"]) for r in routes} == {
            r: (sb[r]["count"], sb[r]["errors"]) for r in routes}, where
    elif step.kind == "metrics":
        def lines(raw):
            return [_VOLATILE.match(x).group(0) if _VOLATILE.match(x) else x
                    for x in raw.decode().splitlines()]
        assert lines(a.body) == lines(b.body), where
    elif step.kind == "snapshot":
        assert a.status != 200 or jax_side.masked(a.body) == port_side.masked(b.body), where
        jax_side.snapshot, port_side.snapshot = a.body, b.body
    else:
        raise ValueError(step.kind)


def run_script(pair, steps) -> None:
    jax_side, port_side = pair
    for step in steps:
        a, b = jax_side.send(step), port_side.send(step)
        compare(step, jax_side, port_side, a, b)


def reset(pair) -> None:
    """Drop every collection on both servers (not compared)."""
    for side in pair:
        names = json.loads(exchange(side.server.port, "GET", "/collections").body)
        for name in names["collections"]:
            from urllib.parse import quote

            assert exchange(side.server.port, "DELETE",
                            f"/collections/{quote(name, safe='')}").status == 200


def make_pair(tmp_path_factory, api_key=None):
    jax_client = jvl.VectorLiteClient(jvl.MockEmbeddingFunction(DIM))
    port_client = tvl.VectorLiteClient(tvl.MockEmbeddingFunction(DIM), device="cpu")
    return (Side("jax", _JaxServer(jax_client, api_key), tmp_path_factory.mktemp("jax")),
            Side("port", _PortServer(port_client, api_key), tmp_path_factory.mktemp("port")))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    sides = make_pair(tmp_path_factory)
    yield sides
    for side in sides:
        side.server.close()


# ------------------------------------------------------------- the script

RNG = np.random.default_rng(12)
ROWS = RNG.standard_normal((12, DIM)).round(6).tolist()
QUERIES = RNG.standard_normal((3, DIM)).round(6).tolist()
TEXTS = [f"doc {i} {w}" for i, w in enumerate(
    ("amber sky", "birch tree", "cobalt sea", "delta river", "ember fire", "fjord ice",
     "granite hill", "harbor boat", "indigo dye", "juniper gin", "kelp bed", "lumen light"))]
METAS = [{"tag": "ab"[i % 2], "n": i, "lang": ["en", "de", "fr"][i % 3]} for i in range(12)]


def _texts_setup(name="c"):
    return [
        Step("POST", "/collections", {"name": name, "index_type": "flat"}),
        Step("POST", f"/collections/{name}/texts", {"texts": TEXTS, "metadatas": METAS}),
    ]


def _vectors_setup(name="v"):
    return [
        Step("POST", "/collections", {"name": name, "index_type": "flat"}),
        Step("POST", f"/collections/{name}/vectors", {"vectors": [
            {"values": r, "text": t, "metadata": m} for r, t, m in zip(ROWS, TEXTS, METAS)]}),
    ]


SECTIONS = {
    "meta": [
        Step("GET", "/health"),
        Step("HEAD", "/health"),
        Step("GET", "/collections"),
        Step("GET", "/openapi.yaml", kind="text"),
        Step("POST", "/debug/trace"),
        Step("OPTIONS", "/collections/c/search/text"),
        Step("OPTIONS", "/nowhere"),
        Step("GET", "/nowhere", kind="text"),
        Step("GET", "/collections/", kind="text"),
        Step("POST", "/health", kind="text"),
        Step("PUT", "/collections/load", kind="text"),
        Step("PATCH", "/collections", kind="text"),
        Step("DELETE", "/collections/x/text", kind="text"),
        Step("GET", "/collections/x/search/text", kind="text"),
    ],
    "create": [
        Step("POST", "/collections", {"name": "c", "index_type": "flat"}),
        Step("POST", "/collections", {"name": "c", "index_type": "flat"}),
        Step("POST", "/collections", {"name": "x", "index_type": "btree"}),
        Step("POST", "/collections", {"name": "x", "index_type": "flat", "metric": "nope"}),
        Step("POST", "/collections", {"name": 5, "index_type": "flat"}),
        Step("POST", "/collections", {"name": "x", "index_type": None}),
        Step("POST", "/collections", {"index_type": "flat"}),
        Step("POST", "/collections", {"name": "x", "index_type": "flat", "metric": None}),
        Step("POST", "/collections", [1, 2]),
        Step("POST", "/collections", "{bad"),
        Step("POST", "/collections", ""),
        Step("POST", "/collections", b"\xff\xfe"),
        Step("POST", "/collections", chunks=[b'{"name": "chunky", ', b'"index_type": "Flat", ',
                                             b'"metric": "Cosine"}']),
        Step("POST", "/collections", {"name": "a/b c", "index_type": "FLAT",
                                      "metric": "euclidean"}),
        Step("POST", "/collections", {"name": "m", "index_type": "flat", "metric": ""}),
        Step("GET", "/collections"),
        Step("GET", "/collections/a%2Fb%20c"),
        Step("GET", "/collections/chunky"),
        Step("GET", "/collections/missing"),
        Step("DELETE", "/collections/a%2Fb%20c"),
        Step("DELETE", "/collections/a%2Fb%20c"),
        Step("GET", "/collections"),
    ],
    "text": [
        Step("POST", "/collections", {"name": "c", "index_type": "flat"}),
        Step("POST", "/collections/c/text", {"text": "hello world",
                                             "metadata": {"lang": "en", "n": 1}}),
        Step("POST", "/collections/c/text", {"text": "plain"}),
        Step("POST", "/collections/c/text", {"text": 5}),
        Step("POST", "/collections/c/text", {}),
        Step("POST", "/collections/missing/text", {"text": "x"}),
        Step("POST", "/collections/c/texts", {"texts": TEXTS, "metadatas": METAS}),
        Step("POST", "/collections/c/texts", {"texts": "x"}),
        Step("POST", "/collections/c/texts", {"texts": ["a", 1]}),
        Step("POST", "/collections/c/texts", {"texts": ["a"], "metadatas": [1, 2]}),
        Step("POST", "/collections/c/texts", chunks=[b'{"texts": ["chunked one", ',
                                                     b'"chunked two"]}']),
        Step("GET", "/collections/c"),
        Step("GET", "/collections/c/vectors/1"),
        Step("GET", "/collections/c/vectors?limit=50"),
    ],
    "search": _texts_setup() + [
        Step("POST", "/collections/c/search/text", {"query": "doc 3 delta river"}),
        Step("POST", "/collections/c/search/text", {"query": "amber", "k": 3}),
        Step("POST", "/collections/c/search/text", {"query": "amber", "k": None}),
        *[Step("POST", "/collections/c/search/text", {"query": "amber", "k": k})
          for k in (0, 1001, 1.5, True, "3", -1)],
        Step("POST", "/collections/c/search/text", {"query": 7}),
        Step("POST", "/collections/c/search/text", {"k": 2}),
        *[Step("POST", "/collections/c/search/text",
               {"query": "fire", "k": 4, "similarity_metric": m})
          for m in ("dot", "dotproduct", "Euclidean", "manhattan", "cosine", "", "nope", 5)],
        Step("POST", "/collections/c/search/text",
             {"query": "fire", "k": 12, "similarity_metric": None}),
        *[Step("POST", "/collections/c/search/text", {"query": "sea", "k": 5, "where": w})
          for w in ({"lang": "en"}, {"n": {"$gt": 5}}, {"$or": [{"tag": "a"}, {"n": 1}]},
                    {"n": {"$bogus": 1}}, "x", [1], {"n": {"$in": 3}})],
        *[Step("POST", "/collections/c/search/text", {"query": "sea", "k": 12, "min_score": s})
          for s in (0.0, 0.25, -1, "x", True)],
        Step("POST", "/collections/c/search/text",
             '{"query": "sea", "min_score": Infinity}'),
        Step("POST", "/collections/c/search/text", '{"query": "sea", "min_score": 1e400}'),
        *[Step("POST", "/collections/c/search/text", {"query": "sea", "k": 3, "ef": ef})
          for ef in (0, 5, 65536, -1, 70000, 2.0)],
        Step("POST", "/collections/missing/search/text", {"query": "x"}),
        Step("POST", "/collections/c/search/texts",
             {"queries": ["amber", "fjord ice", "kelp"], "k": 2}),
        Step("POST", "/collections/c/search/texts",
             {"queries": ["amber"], "k": 4, "where": {"tag": "b"}, "min_score": -0.5}),
        Step("POST", "/collections/c/search/texts", {"queries": "x"}),
        Step("POST", "/collections/c/search/texts", {"queries": ["a", None]}),
        Step("POST", "/collections/c/search/texts", {"queries": ["a"], "k": 0}),
        Step("POST", "/collections/c/search/hybrid", {"query": "amber sky", "k": 3}),
        Step("POST", "/collections/c/search/hybrid",
             {"query": "river", "k": 5, "alpha": 0.3, "pool": 6}),
        Step("POST", "/collections/c/search/hybrid",
             {"query": "doc", "k": 4, "alpha": 0, "where": {"lang": "de"}}),
        Step("POST", "/collections/c/search/hybrid", {"query": "doc", "alpha": 1}),
        *[Step("POST", "/collections/c/search/hybrid", {"query": "doc", "alpha": a})
          for a in (2, -0.1, "x", True)],
        *[Step("POST", "/collections/c/search/hybrid", {"query": "doc", "pool": p})
          for p in (0, 1001, 2.5)],
        Step("POST", "/collections/c/search/hybrid", {"query": "doc", "k": 0}),
    ],
    "vectors": _vectors_setup() + [
        Step("POST", "/collections/v/vectors", {"vectors": [
            {"values": ROWS[0], "id": 100, "metadata": {"x": 1}},
            {"values": ROWS[1], "id": 101, "text": None}]}),
        Step("POST", "/collections/v/vectors", {"vectors": [{"values": ROWS[2], "id": 100}]}),
        Step("POST", "/collections/v/vectors", {"vectors": [
            {"values": ROWS[3], "id": 200}, {"values": ROWS[4]}]}),
        Step("POST", "/collections/v/vectors", {"vectors": [
            {"values": ROWS[3]}, {"values": ROWS[4][:8]}]}),
        Step("POST", "/collections/v/vectors", {"vectors": [{"values": [True] * DIM}]}),
        Step("POST", "/collections/v/vectors", {"vectors": [{"values": []}]}),
        Step("POST", "/collections/v/vectors", {"vectors": [{"values": ROWS[0][:5]}]}),
        Step("POST", "/collections/v/vectors", {"vectors": [{"values": ROWS[0], "id": -1}]}),
        Step("POST", "/collections/v/vectors", {"vectors": [{"values": ROWS[0], "id": 2**64}]}),
        Step("POST", "/collections/v/vectors", {"vectors": [{"values": ROWS[0], "text": 5}]}),
        Step("POST", "/collections/v/vectors", {"vectors": [{"text": "no values"}]}),
        Step("POST", "/collections/v/vectors", {"vectors": "x"}),
        Step("POST", "/collections/v/vectors", {"vectors": [1]}),
        Step("POST", "/collections/v/vectors", {}),
        Step("POST", "/collections/v/vectors",
             '{"vectors": [{"values": [NaN' + ", 1.0" * (DIM - 1) + "]}]}"),
        Step("POST", "/collections/v/search/vector", {"vector": QUERIES[0], "k": 3}),
        Step("POST", "/collections/v/search/vector",
             {"vector": QUERIES[1], "k": 4, "similarity_metric": "manhattan"}),
        Step("POST", "/collections/v/search/vector",
             {"vector": QUERIES[1], "k": 5, "similarity_metric": "DotProduct", "where": {"tag": "a"}}),
        Step("POST", "/collections/v/search/vector", {"vector": QUERIES[0][:4]}),
        Step("POST", "/collections/v/search/vector", {"vector": []}),
        Step("POST", "/collections/v/search/vector",
             {"vector": [1, 2.5, -3] + QUERIES[0][3:], "k": 2}),
        Step("POST", "/collections/v/search/vector",
             '{"vector": [1' + "0" * 400 + ', 2.0]}'),
        Step("POST", "/collections/v/search/vector", {"vector": [None] + QUERIES[0][1:]}),
        Step("POST", "/collections/v/search/vector", {"vector": ["1"]}),
        Step("POST", "/collections/v/search/vector", {}),
        Step("POST", "/collections/v/search/vectors", {"vectors": QUERIES, "k": 4}),
        Step("POST", "/collections/v/search/vectors",
             {"vectors": QUERIES, "k": 14, "similarity_metric": "euclidean",
              "where": {"n": {"$lte": 6}}, "min_score": 0.05}),
        Step("POST", "/collections/v/search/vectors", {"vectors": []}),
        Step("POST", "/collections/v/search/vectors", {"vectors": [QUERIES[0], QUERIES[1][:3]]}),
        Step("POST", "/collections/v/search/vectors", {"vectors": [QUERIES[0], 5]}),
        Step("POST", "/collections/v/search/vectors", {"vectors": "x"}),
        Step("POST", "/collections/missing/search/vectors", {"vectors": QUERIES}),
        Step("GET", "/collections/v/vectors/100"),
        Step("GET", "/collections/v"),
    ],
    "listing": _vectors_setup() + [
        Step("GET", "/collections/v/vectors"),
        Step("GET", "/collections/v/vectors?offset=2&limit=3"),
        Step("GET", "/collections/v/vectors?offset=2&limit=3&include_values=1"),
        Step("GET", "/collections/v/vectors?limit=0"),
        Step("GET", "/collections/v/vectors?include_values=true&limit=2"),
        *[Step("GET", f"/collections/v/vectors?{q}")
          for q in ("limit=1001", "offset=-1", "offset=x", "limit=", "limit=%2B5")],
        Step("GET", "/collections/v/vectors?where=%7B%22tag%22%3A%20%22b%22%7D&limit=4"),
        Step("GET", "/collections/v/vectors?where=%7B%22n%22%3A%7B%22%24gte%22%3A9%7D%7D"),
        Step("GET", "/collections/v/vectors?where=notjson"),
        Step("GET", "/collections/v/vectors?where=%5B1%5D"),
        Step("GET", "/collections/v/vectors?where="),
        Step("GET", "/collections/v/vectors?where=%7B%22n%22%3A%7B%22%24bad%22%3A1%7D%7D"),
        Step("GET", "/collections/v/vectors?ids=3,0,99,7"),
        Step("GET", "/collections/v/vectors?ids=3,0&include_values=1"),
        Step("GET", "/collections/v/vectors?ids=1,2,3,4&where=%7B%22tag%22%3A%22a%22%7D"),
        *[Step("GET", f"/collections/v/vectors?ids={q}")
          for q in ("", "a", "1,,2", "-1", "18446744073709551616", "1%2C2", "+1")],
        Step("GET", "/collections/v/vectors?ids=" + ",".join(["1"] * 1001)),
        Step("GET", "/collections/missing/vectors"),
        Step("GET", "/collections/missing/vectors?ids=1"),
        *[Step("GET", f"/collections/v/vectors/{i}")
          for i in ("0", "11", "+3", "99999", "abc", "-1", "18446744073709551616",
                    "1_0", "%201")],
        Step("GET", "/collections/missing/vectors/0"),
    ],
    "mutations": _vectors_setup() + [
        Step("PATCH", "/collections/v/vectors/1", {"metadata": {"k": "v", "tag": "z"}}),
        Step("PATCH", "/collections/v/vectors/2", {"metadata": None}),
        Step("PATCH", "/collections/v/vectors/1", {}),
        Step("PATCH", "/collections/v/vectors/999", {"metadata": {}}),
        Step("PATCH", "/collections/v/vectors/x", {"metadata": {}}),
        Step("GET", "/collections/v/vectors?ids=1,2"),
        Step("POST", "/collections/v/search/vector",
             {"vector": QUERIES[0], "k": 12, "where": {"tag": "z"}}),
        Step("PUT", "/collections/v/vectors/3", {"text": "replaced text", "metadata": {"r": 1}}),
        Step("PUT", "/collections/v/vectors/4", {"text": "replaced, no metadata"}),
        Step("PUT", "/collections/v/vectors/5", {"metadata": {}}),
        Step("PUT", "/collections/v/vectors/999", {"text": "x"}),
        Step("GET", "/collections/v/vectors?ids=3,4&include_values=1"),
        Step("DELETE", "/collections/v/vectors/6"),
        Step("DELETE", "/collections/v/vectors/6"),
        Step("DELETE", "/collections/v/vectors/abc"),
        Step("DELETE", "/collections/v/vectors"),
        Step("DELETE", "/collections/v/vectors?where=%7B%22tag%22%3A%22b%22%7D"),
        Step("DELETE", "/collections/v/vectors?where=bad"),
        Step("DELETE", "/collections/missing/vectors?where=%7B%7D"),
        Step("GET", "/collections/v"),
        Step("POST", "/collections/v/compact"),
        Step("POST", "/collections/v/compact"),
        Step("POST", "/collections/missing/compact"),
        Step("POST", "/collections/v/search/vectors", {"vectors": QUERIES, "k": 12}),
        Step("DELETE", "/collections/v/vectors?where=%7B%7D"),
        Step("GET", "/collections/v"),
        Step("POST", "/collections/v/search/vector", {"vector": QUERIES[0]}),
    ],
    "persistence": _vectors_setup() + [
        Step("POST", "/collections/v/save", {"file_path": "<tmp>/v.vlc"}),
        Step("POST", "/collections/v/save", {}),
        Step("POST", "/collections/v/save", {"file_path": 5}),
        Step("POST", "/collections/missing/save", {"file_path": "<tmp>/m.vlc"}),
        Step("POST", "/collections/load", {"file_path": "<tmp>/v.vlc",
                                           "collection_name": "v2"}),
        Step("POST", "/collections/load", {"file_path": "<tmp>/v.vlc",
                                           "collection_name": "v2"}),
        Step("POST", "/collections/load", {"file_path": "<tmp>/v.vlc"}),
        Step("POST", "/collections/load", {"file_path": "<tmp>/absent.vlc"}),
        Step("POST", "/collections/load", {"file_path": "<tmp>/v.vlc",
                                           "collection_name": 3}),
        Step("POST", "/collections/load", {}),
        Step("DELETE", "/collections/v"),
        Step("POST", "/collections/load", {"file_path": "<tmp>/v.vlc"}),
        Step("GET", "/collections"),
        Step("GET", "/collections/v2"),
        Step("POST", "/collections/v2/search/vectors", {"vectors": QUERIES, "k": 5}),
        Step("GET", "/collections/v2/vectors?limit=3&include_values=1"),
        Step("POST", "/collections/v2/text", {"text": "after the load"}),
    ],
    "snapshot": _vectors_setup() + [
        Step("GET", "/collections/v/snapshot", kind="snapshot"),
        Step("HEAD", "/collections/v/snapshot"),
        Step("GET", "/collections/missing/snapshot"),
        Step("POST", "/collections/v3/snapshot", lambda side: side.snapshot),
        Step("POST", "/collections/v3/snapshot", lambda side: side.snapshot),
        Step("POST", "/collections/v4/snapshot", b'{"version": "9.9.9"}'),
        Step("POST", "/collections/v5/snapshot", b"not json"),
        Step("GET", "/collections/v3"),
        Step("POST", "/collections/v3/search/vectors", {"vectors": QUERIES, "k": 4}),
        Step("GET", "/collections/v3/vectors?ids=0,5,11&include_values=1"),
        Step("GET", "/collections"),
    ],
    "observability": _texts_setup("obs") + [
        Step("POST", "/collections/obs/search/text", {"query": "amber"}),
        Step("GET", "/collections/obs/vectors/1"),
        Step("GET", "/collections/nope"),
        Step("GET", "/stats", kind="stats"),
        Step("GET", "/metrics", kind="metrics"),
    ],
}


@pytest.mark.parametrize("section", list(SECTIONS))
def test_route_parity(pair, section):
    reset(pair)
    run_script(pair, SECTIONS[section])


def test_script_covers_every_route():
    """Every route of create_app answers at least one scripted request."""
    app = port_server.create_app(tvl.VectorLiteClient(tvl.MockEmbeddingFunction(DIM),
                                                      device="cpu"))
    from vectorlite_tpu_torch.api._http import _path_safe

    reached = set()
    for steps in SECTIONS.values():
        for step in steps:
            path = step.path.partition("?")[0]
            template, _, _ = app.resolve(step.method, _path_safe(path))
            if template is not None:
                reached.add((step.method, template))
    routes = {(m, t) for m, t, _ in port_server._ROUTES}
    assert routes <= reached, sorted(routes - reached)


def test_body_cap_parity(tmp_path_factory, monkeypatch):
    """The body cap: 413 with the canonical message at or past the cap
    (also for a chunked body), bodies under it served; the snapshot upload
    is not held to it."""
    monkeypatch.setenv("VECTORLITE_MAX_BODY_MB", "0.001")  # 1,048 bytes
    sides = make_pair(tmp_path_factory)
    try:
        big = "x" * 2000
        run_script(sides, [
            Step("POST", "/collections", {"name": "c", "index_type": "flat"}),
            Step("POST", "/collections/c/text", {"text": big}),
            Step("POST", "/collections/c/text", {"text": "x" * 1000}),
            # {"text": "..."} is 12 bytes past its text: 1,047 bytes are
            # served, 1,048 (the cap) are not
            Step("POST", "/collections/c/text", {"text": "y" * 1035}),
            Step("POST", "/collections/c/text", {"text": "z" * 1036}),
            Step("POST", "/collections/c/text", chunks=[b'{"text": "', b"w" * 1036, b'"}']),
            Step("POST", "/collections/c/text", chunks=[b'{"text": "', b"v" * 1035, b'"}']),
            Step("POST", "/collections/c/text", chunks=[b'{"text": "', big.encode(), b'"}']),
            Step("POST", "/collections/c/text", {"text": "small"}),
            Step("GET", "/collections/c/snapshot", kind="snapshot"),
            Step("POST", "/collections/c2/snapshot", lambda side: side.snapshot),
            Step("GET", "/collections/c2"),
        ])
    finally:
        for side in sides:
            side.server.close()


def test_auth_parity(tmp_path_factory):
    """API-key auth: 401 with CORS headers without the key (unknown paths
    too), GET /health and OPTIONS open, Bearer (any case) and X-API-Key
    accepted."""
    sides = make_pair(tmp_path_factory, api_key="s3cret")
    try:
        run_script(sides, [
            Step("GET", "/collections"),
            Step("GET", "/nowhere"),
            Step("POST", "/health"),
            Step("GET", "/health"),
            Step("OPTIONS", "/collections"),
            Step("GET", "/collections", headers={"Authorization": "Bearer wrong"}),
            Step("GET", "/collections", headers={"Authorization": "Bearer s3cret"}),
            Step("GET", "/collections", headers={"Authorization": "bEaReR s3cret"}),
            Step("GET", "/collections", headers={"Authorization": "Basic s3cret"}),
            Step("GET", "/collections", headers={"X-API-Key": "s3cret"}),
            Step("GET", "/nowhere", headers={"X-API-Key": "s3cret"}, kind="text"),
            Step("POST", "/collections", {"name": "c", "index_type": "flat"},
                 headers={"X-API-Key": "s3cret"}),
            Step("GET", "/stats", headers={"X-API-Key": "s3cret"}, kind="stats"),
        ])
    finally:
        for side in sides:
            side.server.close()


def hnsw_steps(metric: str) -> list:
    """An HNSW collection of ``metric`` from create to reload, through
    every route that reads or writes it."""
    h = "/collections/h"
    return [
        Step("POST", "/collections", {"name": "h", "index_type": "hnsw"}),
        Step("POST", "/collections", {"name": "h", "index_type": "HNSW", "metric": metric}),
        Step("POST", f"{h}/texts", {"texts": TEXTS, "metadatas": METAS}),
        Step("POST", f"{h}/vectors", {"vectors": [
            {"values": r, "text": t, "metadata": m} for r, t, m in zip(ROWS, TEXTS, METAS)]}),
        Step("POST", f"{h}/text", {"text": "one more", "metadata": {"n": 99}}),
        Step("GET", h),
        Step("POST", f"{h}/search/text", {"query": "doc 3 delta river", "k": 5}),
        *[Step("POST", f"{h}/search/text", {"query": "amber", "k": 4, "ef": ef})
          for ef in (0, 8, 65536, -1)],
        Step("POST", f"{h}/search/text", {"query": "amber", "similarity_metric": metric}),
        Step("POST", f"{h}/search/text",
             {"query": "amber", "similarity_metric": "cosine" if metric != "cosine"
              else "euclidean"}),
        Step("POST", f"{h}/search/text", {"query": "sea", "k": 5, "where": {"tag": "a"}}),
        Step("POST", f"{h}/search/text", {"query": "sea", "k": 25, "min_score": 0.1}),
        Step("POST", f"{h}/search/texts", {"queries": ["amber", "fjord ice"], "k": 3, "ef": 4}),
        Step("POST", f"{h}/search/vector", {"vector": QUERIES[0], "k": 6}),
        Step("POST", f"{h}/search/vectors",
             {"vectors": QUERIES, "k": 8, "where": {"n": {"$lte": 6}}}),
        Step("POST", f"{h}/search/hybrid", {"query": "river", "k": 5, "alpha": 0.3}),
        Step("GET", f"{h}/vectors?offset=2&limit=5&include_values=1"),
        Step("GET", f"{h}/vectors?ids=3,0,99"),
        Step("PATCH", f"{h}/vectors/1", {"metadata": {"tag": "z"}}),
        Step("PUT", f"{h}/vectors/2", {"text": "replaced text"}),
        Step("DELETE", f"{h}/vectors/5"),
        Step("DELETE", f"{h}/vectors?where=%7B%22tag%22%3A%22b%22%7D"),
        Step("POST", f"{h}/search/vectors", {"vectors": QUERIES, "k": 6}),
        Step("POST", f"{h}/compact"),
        Step("POST", f"{h}/search/vectors", {"vectors": QUERIES, "k": 6, "ef": 16}),
        Step("POST", f"{h}/save", {"file_path": "<tmp>/h.vlc"}),
        Step("POST", "/collections/load", {"file_path": "<tmp>/h.vlc",
                                           "collection_name": "h2"}),
        Step("GET", "/collections/h2"),
        Step("POST", "/collections/h2/search/vectors", {"vectors": QUERIES, "k": 6}),
        Step("GET", f"{h}/snapshot", kind="snapshot"),
        Step("POST", "/collections/h3/snapshot", lambda side: side.snapshot),
        Step("POST", "/collections/h3/search/text", {"query": "amber", "k": 4}),
        Step("GET", "/collections"),
    ]


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dotproduct", "manhattan"])
def test_hnsw_route_parity(pair, metric):
    reset(pair)
    run_script(pair, hnsw_steps(metric))
