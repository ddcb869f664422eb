"""The control: the reference put in the program's place, one precision
down. The deployments state float32 with TF32 off (the SDK turns it off
for its exact paths), so the control scores in TF32: a
``torch.mm`` over float32 rows with ``allow_tf32`` on, then a top-k. Its
answers go through the same comparison as the program's, which has to
find them wrong. Only ``calibrate.py`` and the tests run it; a
benchmark run never does.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from . import compare, reference

Hit = namedtuple("Hit", "id score")


class Tf32System:
    """The same call surface as ``system.SdkSystem``: ``call(queries)``
    gives one list of hits a query."""

    def __init__(self, config: dict, traffic: dict, rows: np.ndarray, device):
        self.k = int(traffic["k"])
        self.metric = config["metric"]
        if self.metric not in ("cosine", "euclidean", "dot"):
            raise ValueError(f"no TF32 control for {self.metric!r}")
        self.device = device
        self.rows = torch.from_numpy(rows).to(device)
        self.norms = torch.linalg.vector_norm(self.rows, dim=1)
        allowed = reference.where_mask(
            traffic.get("where"), compare.metadata_columns(config), rows.shape[0])
        self.blocked = None if allowed is None else ~torch.from_numpy(allowed).to(device)

    def call(self, queries: np.ndarray) -> list:
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(self.device)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            dot = q @ self.rows.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        qn = torch.linalg.vector_norm(q, dim=1)
        if self.metric == "cosine":
            s = (dot / (qn[:, None] * self.norms[None, :]).clamp_min(1e-30)).clamp_max(1.0)
        elif self.metric == "euclidean":
            d2 = (qn * qn)[:, None] + (self.norms * self.norms)[None, :] - 2.0 * dot
            s = 1.0 / (1.0 + d2.clamp_min(0.0).sqrt())
        else:
            s = dot
        if self.blocked is not None:
            s.masked_fill_(self.blocked[None, :], -torch.inf)
        top = torch.topk(s, self.k, dim=1)
        ids, scores = top.indices.cpu().tolist(), top.values.cpu().tolist()
        return [[Hit(i, v) for i, v in zip(ri, rv)] for ri, rv in zip(ids, scores)]

    def close(self) -> None:
        self.rows = self.norms = self.blocked = None
