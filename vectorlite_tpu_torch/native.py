"""Host code in native libraries: the f64 re-score and the .vlc codec.

Bindings of ``csrc/host_rescore.cpp`` (the port's copy of the JAX
package's ``flat_rescore_f64``) and ``csrc/vlc_emit.cpp`` (its copy of
``native/vlc_emit.cpp``), each built with ``g++`` at first use by
``kernels/_build.py`` and loaded with ctypes. Each keeps a Python twin
that serves when ``VECTORLITE_NO_NATIVE=1`` or when the library fails to
build (a warning says so once): ``FlatIndex._exact_rescore``'s numpy
re-score and ``persist/vlc.py``'s Python emitter and ``json`` parser.
``RESCORE.calls`` and ``VLC.calls`` count the calls the native code
served.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional

import numpy as np

from .core.metrics import SimilarityMetric
from .kernels import _build

logger = logging.getLogger("vectorlite_tpu_torch.native")

_METRIC_CODE = {
    SimilarityMetric.COSINE: 0,
    SimilarityMetric.EUCLIDEAN: 1,
    SimilarityMetric.DOT_PRODUCT: 2,
    SimilarityMetric.MANHATTAN: 3,
}

_D = ctypes.c_void_p
_I64 = ctypes.c_int64


class NativeRescore:
    """The compiled ``flat_rescore_f64`` and the count of its calls."""

    def __init__(self):
        self.calls = 0
        self._fn = None
        self._failed = False
        self._lock = threading.Lock()

    def _function(self):
        with self._lock:
            if self._fn is None and not self._failed:
                try:
                    fn = _build.load("host_rescore").flat_rescore_f64
                except (RuntimeError, OSError) as exc:
                    self._failed = True
                    logger.warning(
                        "native f64 re-score unavailable, numpy serves: %s", exc
                    )
                    return None
                fn.argtypes = [_D, _D, _D, _D, _D, _I64, _I64, _I64, ctypes.c_int32]
                fn.restype = None
                self._fn = fn
            return self._fn

    def __call__(
        self,
        values64: np.ndarray,  # [cap, D] f64 truth, C-contiguous
        norms: Optional[np.ndarray],  # [cap] f64 row norms (cosine only)
        q64: np.ndarray,  # [B, D] f64 queries
        slots: np.ndarray,  # [B, k] row indices into values64
        metric: SimilarityMetric,
    ) -> Optional[np.ndarray]:
        """Exact f64 scores [B, k], or None when the native code is
        disabled (``VECTORLITE_NO_NATIVE=1``) or did not build."""
        if os.environ.get("VECTORLITE_NO_NATIVE") == "1" or slots.size == 0:
            return None
        fn = self._function()
        if fn is None:
            return None
        cap, dim = values64.shape
        if values64.dtype != np.float64 or not values64.flags.c_contiguous:
            raise ValueError("values64 must be a C-contiguous float64 matrix")
        if q64.shape != (slots.shape[0], dim):
            raise ValueError(f"queries must be [{slots.shape[0]}, {dim}]")
        if slots.min() < 0 or slots.max() >= cap:
            raise ValueError(f"slots must lie in [0, {cap})")
        if metric is SimilarityMetric.COSINE:
            if norms is None or norms.shape != (cap,) or norms.dtype != np.float64:
                raise ValueError(f"cosine needs a [{cap}] float64 norm table")
            norms = np.ascontiguousarray(norms)
        q = np.ascontiguousarray(q64, dtype=np.float64)
        s = np.ascontiguousarray(slots, dtype=np.int64)
        b, k = s.shape
        out = np.empty((b, k), dtype=np.float64)
        fn(
            values64.ctypes.data,
            norms.ctypes.data if metric is SimilarityMetric.COSINE else None,
            q.ctypes.data, s.ctypes.data, out.ctypes.data,
            dim, b, k, _METRIC_CODE[metric],
        )
        self.calls += 1
        return out


RESCORE = NativeRescore()


_P = ctypes.POINTER


def _bind_vlc(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Signatures of the codec's C entries, as the JAX package's
    ``_bind_vlc`` declares them; ``vlc_emit_keyed_arrays`` renders only
    HNSW payloads and stays unbound."""
    c = ctypes
    lib.vlc_fmt_f64.restype = c.c_int32
    lib.vlc_fmt_f64.argtypes = [c.c_double, c.c_char_p]
    lib.vlc_emit_f64_elems.restype = c.c_int64
    lib.vlc_emit_f64_elems.argtypes = [
        _P(c.c_double), c.c_int64, c.c_int32, c.c_int32, c.c_char_p, c.c_int64,
    ]
    lib.vlc_emit_i64_elems.restype = c.c_int64
    lib.vlc_emit_i64_elems.argtypes = [
        _P(c.c_int64), c.c_int64, c.c_int32, c.c_int32, c.c_char_p, c.c_int64,
    ]
    lib.vlc_emit_rows.restype = c.c_int64
    lib.vlc_emit_rows.argtypes = [
        _P(c.c_uint64),  # ids
        _P(c.c_double),  # vals [n, d]
        c.c_int64,  # n_rows
        c.c_int64,  # d
        c.c_char_p,  # texts (raw utf-8, concatenated)
        _P(c.c_int64),  # text_offs [n+1]
        c.c_char_p,  # metas (pre-rendered fragments, concatenated)
        _P(c.c_int64),  # meta_offs [n+1]
        c.c_int32,  # elem_indent
        c.c_int32,  # last_no_comma
        c.c_char_p,  # out
        c.c_int64,  # out_cap
    ]
    lib.vlc_parse_doc.restype = c.c_int32
    lib.vlc_parse_doc.argtypes = [
        c.c_char_p,  # doc
        c.c_int64,  # len
        c.c_char_p,  # nonce
        c.c_void_p,  # skel buffer
        c.c_int64,  # skel cap
        _P(c.c_double),  # dvals
        c.c_int64,  # dcap
        _P(c.c_int64),  # ivals
        c.c_int64,  # icap
        _P(c.c_int64),  # lens
        c.c_int64,  # lens cap
        _P(c.c_int64),  # out_counts[4]
    ]
    return lib


class NativeVLC:
    """The compiled ``.vlc`` codec and the count of the calls it served."""

    def __init__(self):
        self.calls = 0
        self._lib = None
        self._failed = False
        self._lock = threading.Lock()

    def library(self) -> Optional[ctypes.CDLL]:
        """The bound library, or None when the native code is disabled
        (``VECTORLITE_NO_NATIVE=1``) or did not build."""
        if os.environ.get("VECTORLITE_NO_NATIVE") == "1":
            return None
        with self._lock:
            if self._lib is None and not self._failed:
                try:
                    self._lib = _bind_vlc(_build.load("vlc_emit"))
                except (RuntimeError, OSError) as exc:
                    self._failed = True
                    logger.warning(
                        "native .vlc codec unavailable, Python serves: %s", exc
                    )
            return self._lib

    def call(self, symbol: str, *args):
        """Call one C entry of the codec (``library()`` must have given a
        library) and count it."""
        out = getattr(self._lib, symbol)(*args)
        with self._lock:  # autosave saves beside foreground ones
            self.calls += 1
        return out


VLC = NativeVLC()
