"""HTTP/1.1 transport on the Python standard library.

The JAX package serves its routes on aiohttp (``vectorlite_tpu/api/
server.py``); this module gives the port's server what it took from
aiohttp, on ``http.server.ThreadingHTTPServer`` so that it runs where
only the standard library, torch and numpy are installed:

- a router with aiohttp's resolution: ``{name}`` templates match
  ``[^{}/]+`` of the path with ``%2F`` and ``%25`` still encoded, match
  values are then decoded; candidates are tried from the most specific
  plain path up, then in registration order; a path some route matches
  under another method is a 405 with an ``Allow`` header (sorted, comma
  joined), any other a 404, both with aiohttp's ``text/plain`` bodies;
  every GET route answers HEAD too;
- request bodies by ``Content-Length`` or chunked transfer encoding,
  read whole under a cap (a body of the cap or more is refused, as
  aiohttp's ``client_max_size`` refuses it, and one whose
  ``Content-Length`` says so is refused before it is read) or streamed
  without one;
- responses with a ``Content-Length``, or streamed with chunked transfer
  encoding; keep-alive.

There is no event loop: each connection's thread runs its handlers
itself. ``App.middleware`` wraps every handler (the server's error and
auth policy); this module knows nothing of the routes' contract.
"""

from __future__ import annotations

import http.server
import json
import logging
import re
import socketserver
import threading
import urllib.parse
from typing import Callable, Optional

logger = logging.getLogger("vectorlite_tpu_torch.http")

#: an unread request body up to this size is read and dropped after the
#: answer so that the connection stays open; a larger one closes it
_DRAIN_MAX = 1 << 20
_CHUNK = 1 << 20


class HTTPError(Exception):
    """An answer raised from a handler (aiohttp's ``web.HTTPException``)."""

    def __init__(self, status: int, text: str,
                 content_type: str = "application/json", headers=None):
        super().__init__(text)
        self.response = Response(text.encode("utf-8"), status=status,
                                 content_type=content_type, headers=headers)

    @classmethod
    def message(cls, status: int, message: str) -> "HTTPError":
        """The contract's ``{"message": ...}`` error body."""
        return cls(status, json.dumps({"message": message}))


class BodyTooLarge(Exception):
    """The request body reached the app's cap."""


class Response:
    def __init__(self, body: bytes = b"", *, status: int = 200,
                 content_type: Optional[str] = None, headers=None):
        self.status = status
        self.body = body
        self.headers = dict(headers or {})
        if content_type is not None:
            self.headers["Content-Type"] = f"{content_type}; charset=utf-8"


def json_response(data, status: int = 200) -> Response:
    """``web.json_response``: ``json.dumps`` with its default separators."""
    return Response(json.dumps(data).encode("utf-8"), status=status,
                    content_type="application/json")


def text_response(text: str, content_type: str, status: int = 200) -> Response:
    return Response(text.encode("utf-8"), status=status, content_type=content_type)


class StreamResponse:
    """A response already sent by its handler through ``Request.stream``."""

    status = 200


def _path_safe(raw: str) -> str:
    """The path decoded except for ``%2F`` and ``%25`` (yarl's
    ``path_safe``, what aiohttp matches routes against)."""
    parts = re.split(r"(%2[fF]|%25)", raw)
    return "".join(p.upper() if i % 2 else urllib.parse.unquote(p)
                   for i, p in enumerate(parts))


def _unquote_path_safe(value: str) -> str:
    return value.replace("%2F", "/").replace("%25", "%")


class _Route:
    def __init__(self, template: str):
        self.template = template
        self.methods: dict[str, Callable] = {}
        if "{" in template:
            pattern = ""
            for literal, name in re.findall(r"([^{]*)(?:\{(\w+)\})?", template):
                pattern += re.escape(literal)
                if name:
                    pattern += f"(?P<{name}>[^{{}}/]+)"
            self._pattern = re.compile(pattern)
            key = template.partition("{")[0].rpartition("/")[0]
        else:
            self._pattern = None
            key = template
        self.key = key.rstrip("/") or "/"

    def match(self, path_safe: str) -> Optional[dict]:
        if self._pattern is None:
            return {} if path_safe == self.template else None
        m = self._pattern.fullmatch(path_safe)
        if m is None:
            return None
        return {k: _unquote_path_safe(v) for k, v in m.groupdict().items()}


class App:
    """Routes, the middleware around every handler, shared state and
    the clean-up hooks run once when the server closes."""

    def __init__(self, *, max_body: int, middleware: Callable):
        self.max_body = int(max_body)
        self.middleware = middleware
        self.state: dict = {}
        self.on_cleanup: list[Callable[[], None]] = []
        self._routes: dict[str, _Route] = {}
        self._index: dict[str, list[_Route]] = {}
        self._cleaned = False

    def add_route(self, method: str, template: str, handler: Callable) -> None:
        route = self._routes.get(template)
        if route is None:
            route = self._routes[template] = _Route(template)
            self._index.setdefault(route.key, []).append(route)
        route.methods[method] = handler
        if method == "GET":
            route.methods["HEAD"] = handler

    def resolve(self, method: str, path_safe: str):
        """(template, handler, match_info) or (None, HTTPError, {})."""
        allowed: set = set()
        part = path_safe
        while part:
            for route in self._index.get(part, ()):
                match = route.match(path_safe)
                if match is None:
                    continue
                handler = route.methods.get(method)
                if handler is not None:
                    return route.template, handler, match
                allowed |= set(route.methods)
            if part == "/":
                break
            part = part.rpartition("/")[0] or "/"
        if allowed:
            return None, HTTPError(405, "405: Method Not Allowed", "text/plain",
                                   {"Allow": ",".join(sorted(allowed))}), {}
        return None, HTTPError(404, "404: Not Found", "text/plain"), {}

    def cleanup(self) -> None:
        if self._cleaned:
            return
        self._cleaned = True
        for hook in self.on_cleanup:
            hook()


class Request:
    """One request as a handler sees it."""

    def __init__(self, conn: "_Handler", app: App):
        self._conn = conn
        self.app = app
        self.method = conn.command
        raw_path, _, query = conn.path.partition("?")
        self.path = urllib.parse.unquote(raw_path)
        self.path_safe = _path_safe(raw_path)
        self.query: dict[str, str] = {}
        for key, value in urllib.parse.parse_qsl(query, keep_blank_values=True):
            self.query.setdefault(key, value)
        self.headers = conn.headers
        self.route, self.handler, self.match_info = app.resolve(self.method, self.path_safe)
        self.chunked = "chunked" in self.headers.get("Transfer-Encoding", "").lower()
        length = self.headers.get("Content-Length")
        if self.chunked or length is None:
            self.content_length = None
        elif length.isdigit():
            self.content_length = int(length)
        else:
            raise HTTPError(400, "400: Bad Request", "text/plain")
        self._left = self.content_length or 0  # unread bytes of a sized body
        self._eof = not self.chunked and not self._left
        self.streamed = False

    # ---------------------------------------------------------- the body

    def _next_chunk(self) -> bytes:
        rfile = self._conn.rfile
        if self._eof:
            return b""
        if not self.chunked:
            data = rfile.read(min(self._left, _CHUNK))
            if not data:
                raise ConnectionError("client closed the connection mid-body")
            self._left -= len(data)
            self._eof = not self._left
            return data
        line = rfile.readline(1024)
        try:
            size = int(line.split(b";")[0].strip(), 16)
        except ValueError:
            raise HTTPError(400, "400: Bad Request", "text/plain") from None
        if size == 0:
            while rfile.readline(1024) not in (b"\r\n", b"\n", b""):
                pass  # trailers
            self._eof = True
            return b""
        data = rfile.read(size)
        rfile.readline(8)
        if len(data) < size:
            raise ConnectionError("client closed the connection mid-body")
        return data

    def iter_body(self):
        """The body's chunks as they arrive, with no cap."""
        while True:
            chunk = self._next_chunk()
            if not chunk:
                return
            yield chunk

    def read(self) -> bytes:
        """The whole body; ``BodyTooLarge`` once it reaches the app's cap
        (at once where ``Content-Length`` reaches it)."""
        cap = self.app.max_body
        if self.content_length is not None and self.content_length >= cap:
            raise BodyTooLarge()
        body = bytearray()
        for chunk in self.iter_body():
            body += chunk
            if len(body) >= cap:
                raise BodyTooLarge()
        return bytes(body)

    def text(self) -> str:
        """The body decoded by its ``Content-Type`` charset (utf-8 if none)."""
        charset = self.headers.get_content_charset() or "utf-8"
        return self.read().decode(charset)

    def json(self):
        return json.loads(self.text())

    def finish_body(self) -> bool:
        """Drop what the handler left unread; False where the connection
        must close instead."""
        if self._eof:
            return True
        if self.chunked or self._left > _DRAIN_MAX:
            return False
        try:
            for _ in self.iter_body():
                pass
        except (OSError, HTTPError):
            return False
        return True

    # ---------------------------------------------------------- streaming

    def stream(self, headers: dict) -> "_ChunkWriter":
        """Send a 200 with ``headers`` and chunked transfer encoding; the
        handler writes the body through the writer and returns
        ``StreamResponse()``. A write to a client that went away raises
        ``ConnectionError``."""
        conn = self._conn
        keep = self.finish_body()
        conn.send_response(200)
        for key, value in headers.items():
            conn.send_header(key, value)
        conn.send_header("Transfer-Encoding", "chunked")
        if not keep:
            conn.send_header("Connection", "close")
        conn.end_headers()
        self.streamed = True
        return _ChunkWriter(conn.wfile, head=self.method == "HEAD")


class _ChunkWriter:
    """The body of a streamed response, one chunk a write (none for HEAD)."""

    def __init__(self, wfile, head: bool):
        self._wfile = wfile
        self._head = head

    def write(self, data: bytes) -> None:
        if data and not self._head:
            self._wfile.write(b"%x\r\n%s\r\n" % (len(data), data))

    def close(self) -> None:
        """The last chunk."""
        if not self._head:
            self._wfile.write(b"0\r\n\r\n")


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def __getattr__(self, name: str):
        # every method reaches the router, which answers 405 or 404 as
        # aiohttp does (BaseHTTPRequestHandler answers 501 for a method
        # without a do_ attribute)
        if name.startswith("do_"):
            return self._serve
        raise AttributeError(name)

    def _serve(self) -> None:
        app: App = self.server.app
        try:
            request = Request(self, app)
        except HTTPError as e:
            self.close_connection = True
            self._send(e.response, head=False, keep=False)
            return
        try:
            response = app.middleware(request)
        except (ConnectionError, TimeoutError) as e:
            logger.info("client went away: %s", e)
            self.close_connection = True
            return
        if request.streamed:
            return
        self._send(response, head=request.method == "HEAD", keep=request.finish_body())

    def _send(self, response: Response, head: bool, keep: bool) -> None:
        self.send_response(response.status)
        for key, value in response.headers.items():
            self.send_header(key, value)
        self.send_header("Content-Length", str(len(response.body)))
        if not keep:
            self.send_header("Connection", "close")
        self.end_headers()
        if not head:
            self.wfile.write(response.body)

    def log_message(self, format, *args) -> None:  # noqa: A002 - the base's name
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("%s %s", self.address_string(), format % args)


class Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
    """A bound server: ``start()`` serves from a thread of its own,
    ``serve_forever()`` from the caller's; ``close()`` stops serving and
    runs the app's clean-up hooks."""

    daemon_threads = True
    request_queue_size = 1024

    def __init__(self, app: App, host: str, port: int):
        self.app = app
        self._thread: Optional[threading.Thread] = None
        super().__init__((host, port), _Handler)

    def server_bind(self) -> None:
        # HTTPServer.server_bind asks the resolver for the host's FQDN,
        # which only CGI reads; bind without any name lookup
        socketserver.TCPServer.server_bind(self)
        self.server_name, self.server_port = self.server_address[:2]

    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.server_address[0]}:{self.port}"

    def start(self) -> "Server":
        # a short poll keeps close() quick: shutdown waits for one poll
        self._thread = threading.Thread(
            target=self.serve_forever, kwargs={"poll_interval": 0.05},
            name=f"vectorlite-http-{self.port}", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self.shutdown()
            self._thread.join(timeout=30)
            self._thread = None
        self.server_close()
        self.app.cleanup()
