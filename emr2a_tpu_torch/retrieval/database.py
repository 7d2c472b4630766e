"""The case-retrieval embedding database on one GPU.

Port of ``emr2a_tpu/retrieval/database.py`` (``ShardedEmbeddingDatabase``),
with its class name, constructor and methods (``topk``, ``topk_chained``,
``add_cases``, ``save``, ``load``, ``search``) and its npz format, so a
database saved by either package loads in the other. The (n, dim) matrix
lives on one device (``device``, default ``cuda``) in its storage dtype:

- ``torch.float32`` or ``torch.bfloat16``: the scan is ``q . dbᵀ`` in f32
  and a stable top-k (the XLA path's counterpart), or, with
  ``use_pallas=True``, the fused kernel K6 (``ops/topk.cosine_topk_fused``);
- ``torch.int8``: per-row codes and f32 scales (``quantize_rows_int8``), and
  the scan is always K6's int8 variant (``cosine_topk_fused_int8``), on the
  card the kernel and on the CPU its plain version, for any k.

Reserving ``capacity`` keeps the buffer's shape: ``add_cases`` writes the
new rows in place (an in-place update, where JAX donates the buffer); past
capacity the buffer grows geometrically. K6 takes the true row count as
``n_valid``, so it runs on a padded buffer too: the JAX package's gate that
turns ``use_pallas`` off under padding has no counterpart. ``mesh`` is
rejected unless None (one device, no shards).

    python -m emr2a_tpu_torch.retrieval.database build|add|query ...
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from emr2a_tpu_torch.ops.similarity import l2_normalize_rows
from emr2a_tpu_torch.ops.topk import (
    cosine_topk_fused,
    cosine_topk_fused_int8,
    topk_scores,
)

logger = logging.getLogger(__name__)

DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def quantize_rows_int8(x: np.ndarray):
    """Symmetric per-row int8 quantization, the DB's own recipe: scale =
    max|row| / 127 (a zero row gets 1.0), codes rint(x / scale) clipped to
    +-127. Returns (int8 codes, f32 per-row scales)."""
    x = np.asarray(x, dtype=np.float32)
    scales = np.abs(x).max(axis=1) / 127.0
    scales = np.where(scales == 0, 1.0, scales)
    q = np.clip(np.rint(x / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales.astype(np.float32)


def _scores(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """f32 scores of q against db, both in the storage dtype."""
    if q.dtype == torch.float32:
        return q @ db.T
    if q.is_cuda:
        return torch.mm(q, db.T, out_dtype=torch.float32)
    return q.float() @ db.float().T


class ShardedEmbeddingDatabase:
    """Case-retrieval database on one device.

    Parameters
    ----------
    embeddings : (n, dim) array of case embeddings (``normalize=True``
        L2-normalises them once, so every query is a plain dot product).
    labels / ids : optional per-case metadata for ``search``.
    dtype : storage dtype, ``torch.float32``, ``torch.bfloat16`` or
        ``torch.int8``.
    """

    def __init__(self, embeddings: np.ndarray,
                 labels: Optional[Sequence[str]] = None,
                 ids: Optional[Sequence[str]] = None,
                 mesh=None,
                 normalize: bool = True,
                 dtype: torch.dtype = torch.float32,
                 use_pallas: bool = False,
                 capacity: Optional[int] = None,
                 device: str = "cuda"):
        if mesh is not None:
            raise ValueError("mesh (a database sharded over chips) has no "
                             "counterpart in the one-GPU port")
        if dtype not in DTYPES:
            raise TypeError(f"dtype must be one of {DTYPES}, got {dtype}")
        self.device = torch.device(device)
        self.n, self.dim = embeddings.shape
        self.capacity = capacity
        self.labels = list(labels) if labels is not None else None
        self.ids = list(ids) if ids is not None else None
        self.use_pallas = use_pallas
        emb = np.asarray(embeddings, dtype=np.float32)
        if normalize:
            emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
        self.dtype = dtype
        self._host_emb = emb  # normalised f32, unpadded (ingest, persist)
        self._upload()

    def _upload(self) -> None:
        """Place the host matrix on the device in the storage dtype, padded
        with zero rows up to the capacity."""
        emb = self._host_emb
        self.n = emb.shape[0]
        pad = max(self.n, self.capacity or 0) - self.n
        if pad:
            emb = np.pad(emb, ((0, pad), (0, 0)))
        if self.dtype == torch.int8:
            q8, scales = quantize_rows_int8(emb)
            self.db = torch.from_numpy(q8).to(self.device)
            self.db_scales = torch.from_numpy(scales).to(self.device)
        else:
            self.db = torch.from_numpy(emb).to(self.device, self.dtype)
            self.db_scales = None

    def _queries(self, queries, normalize: bool) -> torch.Tensor:
        qdtype = torch.float32 if self.db_scales is not None else self.dtype
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device, qdtype)
        if q.dim() == 1:
            q = q[None, :]
        if normalize:
            q = l2_normalize_rows(q).to(qdtype)
        return q

    def _scan(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.db_scales is not None:
            return cosine_topk_fused_int8(q, self.db, self.db_scales, k,
                                          n_valid=self.n)
        if self.use_pallas:
            return cosine_topk_fused(q, self.db, k, n_valid=self.n)
        vals, idx = topk_scores(_scores(q, self.db[:self.n]), k)
        return vals, idx.to(torch.int32)

    def topk(self, queries: np.ndarray, k: int,
             normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q, dim) queries -> (values (q, k) f32, indices (q, k) int32), on
        the database's device. k is clamped to the number of cases."""
        k = min(k, self.n)
        return self._scan(self._queries(queries, normalize), k)

    def topk_chained(self, query: np.ndarray, k: int, repeats: int = 256,
                     normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Single-query latency probe: ``repeats`` back-to-back (1, dim)
        scans queued on the device, of which the last result is returned
        (read back once by the caller). Scan i adds ``i * 1e-9`` to the
        query, as the JAX package's chain does so that XLA cannot hoist the
        scan; it is about 1e-7 of a unit query at the last scan, far below
        ranking resolution, so the result equals the unchained one."""
        k = min(k, self.n)
        q = self._queries(np.asarray(query, np.float32).reshape(1, -1), normalize)
        perturb = (torch.arange(repeats, dtype=torch.float32) * 1e-9).to(
            self.device, q.dtype)
        vals = idx = None
        for i in range(repeats):
            vals, idx = self._scan(q + perturb[i], k)
        return vals, idx

    # -- serving: incremental updates + persistence --

    def add_cases(self, embeddings: np.ndarray,
                  labels: Optional[Sequence[str]] = None,
                  ids: Optional[Sequence[str]] = None,
                  normalize: bool = True) -> None:
        """Append cases. Within the reserved capacity the rows are written
        into the device buffer in place; past it the buffer is rebuilt.
        Labels and ids stay row-aligned: give them exactly when the
        database was built with them."""
        new = np.asarray(embeddings, dtype=np.float32)
        if new.ndim == 1:
            new = new[None, :]
        if normalize:
            new = new / (np.linalg.norm(new, axis=1, keepdims=True) + 1e-12)
        if (self.labels is None) != (labels is None):
            raise ValueError(
                "add_cases labels must match the database: provide labels "
                "iff it was built with labels (metadata stays row-aligned)")
        if (self.ids is None) != (ids is None):
            raise ValueError(
                "add_cases ids must match the database: provide ids iff it "
                "was built with ids")
        if labels is not None and len(labels) != new.shape[0]:
            raise ValueError("len(labels) must equal the number of new rows")
        if ids is not None and len(ids) != new.shape[0]:
            raise ValueError("len(ids) must equal the number of new rows")
        if new.shape[1] != self.dim:
            raise ValueError(
                f"new embeddings must be {self.dim}-dim, got {new.shape[1]}")
        start = self._host_emb.shape[0]
        # concatenate before touching labels/ids: a failure here must not
        # leave the metadata misaligned with the rows
        self._host_emb = np.concatenate([self._host_emb, new], axis=0)
        if labels is not None:
            self.labels.extend(labels)
        if ids is not None:
            self.ids.extend(ids)
        end = start + new.shape[0]
        if end <= self.db.shape[0]:
            if self.db_scales is not None:
                q8, scales = quantize_rows_int8(new)
                self.db[start:end] = torch.from_numpy(q8).to(self.device)
                self.db_scales[start:end] = torch.from_numpy(scales).to(self.device)
            else:
                self.db[start:end] = torch.from_numpy(new).to(self.device, self.dtype)
            self.n = end
        else:
            if self.capacity is not None:
                # grow geometrically: repeated appends amortise to O(log)
                # rebuilds instead of one per batch
                self.capacity = max(end, 2 * self.capacity)
            self._upload()

    def save(self, path) -> None:
        """Persist to npz (embeddings pre-normalised as stored)."""
        payload = {"embeddings": self._host_emb, "n": np.asarray(self.n)}
        if self.labels is not None:
            payload["labels"] = np.asarray(self.labels, dtype=object)
        if self.ids is not None:
            payload["ids"] = np.asarray(self.ids, dtype=object)
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path, mesh=None, dtype: torch.dtype = torch.float32,
             use_pallas: bool = False, capacity: Optional[int] = None,
             device: str = "cuda") -> "ShardedEmbeddingDatabase":
        data = np.load(path, allow_pickle=True)
        labels = [str(x) for x in data["labels"]] if "labels" in data else None
        ids = [str(x) for x in data["ids"]] if "ids" in data else None
        return cls(data["embeddings"], labels=labels, ids=ids, mesh=mesh,
                   normalize=False,  # stored pre-normalised
                   dtype=dtype, use_pallas=use_pallas, capacity=capacity,
                   device=device)

    def search(self, queries: np.ndarray, k: int, normalize: bool = True
               ) -> List[List[dict]]:
        """Per-query lists of neighbour dicts {index, score, label,
        patient_id}."""
        k = min(k, self.n)
        vals, idx = self.topk(queries, k, normalize=normalize)
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy()
        out = []
        for qi in range(vals.shape[0]):
            hits = []
            for j in range(k):
                i = int(idx[qi, j])
                hit = {"index": i, "score": float(vals[qi, j])}
                if self.labels is not None:
                    hit["label"] = self.labels[i]
                if self.ids is not None:
                    hit["patient_id"] = self.ids[i]
                hits.append(hit)
            out.append(hits)
        return out


if __name__ == "__main__":  # python -m emr2a_tpu_torch.retrieval.database
    from emr2a_tpu_torch.retrieval.database_cli import main
    main()
