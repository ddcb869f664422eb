"""Exact float64 re-score of a candidate pool on the host, in native code.

Binding of ``csrc/host_rescore.cpp`` (the port's copy of the JAX
package's ``flat_rescore_f64``), built with ``g++`` at first use by
``kernels/_build.py`` and loaded with ctypes. ``FlatIndex._exact_rescore``
calls ``flat_rescore_f64`` and keeps its numpy version as the plain twin,
which serves when ``VECTORLITE_NO_NATIVE=1`` or when the library fails to
build (a warning says so once). ``RESCORE.calls`` counts the calls that
the native code served.
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
