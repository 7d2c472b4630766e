"""The case-retrieval embedding database, sharded over the mesh's ``data``
axis.

Port of ``emr2a_tpu/retrieval/database.py`` (``ShardedEmbeddingDatabase``),
with its class name, constructor and methods (``topk``, ``topk_chained``,
``add_cases``, ``save``, ``load``, ``search``) and its npz format, so a
database saved by either package loads in the other.

Layout (JAX's ``_upload``): the normalised (n, dim) matrix is padded with
zero rows to ``max(n, capacity)`` rounded up to a multiple of the shard
count, and shard i, on the i-th device of ``data``, holds rows ``[i *
shard_size, (i + 1) * shard_size)`` in the storage dtype (int8 codes with
their f32 scales, sharded alike):

- ``torch.float32`` or ``torch.bfloat16``: a shard's scan is ``q . dbᵀ`` in
  f32 and a stable top-k (the XLA path's counterpart), or, with
  ``use_pallas=True``, the fused kernel K6 (``ops/topk.cosine_topk_fused``);
- ``torch.int8``: K6's int8 variant (``cosine_topk_fused_int8``), on the
  card the kernel and on the CPU its plain version, for any k.

Search (JAX's ``_sharded_topk_fn``): the normalised queries go to every
shard's device; shard i scans its ``n_valid_local = clip(n - base, 0,
shard_size)`` valid rows for ``min(k, shard_size, n_valid_local)``
candidates (``shard_topk``; an empty shard gives none) and offsets them by
``base = i * shard_size``; every shard's query copy, then every shard's
scan, is queued before anything is read back, so the cards run together;
the candidates are gathered to the
first device and a stable top-k over them in shard-major order gives the
answer (``merge_topk``). Ties go to the lowest global index, as in one
scan, so the answer equals the one-shard answer. JAX's shards scan a short
shard for ``min(k, shard_size)`` candidates with ``NEG_INF`` filler; the
filler never surfaces (the shards hold at least k valid candidates
together), so leaving it out changes no answer. One shard is one scan,
with no merge.

Over several processes (a mesh from ``create_mesh`` / ``default_mesh``
after ``parallel.initialize_distributed``; JAX's ``_sharded_topk_fn`` on a
global mesh): every process passes the same embeddings, as in JAX, and
places only its own shards (``local_shards``); each scans them with
``shard_topk`` (K6 on the card, its plain version on the CPU). A
collective needs equal shapes, so every shard then gives ``min(k,
shard_size)`` candidates, padded past its valid rows with ``-inf`` and
index -1 as JAX's shards are (``pack_candidates``); one all-gather of the
packed values and index bits (``torch.distributed``: on the card with
NCCL, over host copies with gloo) gives every process every shard's
candidates, and ``merge_gathered`` puts them in shard order for the
stable top-k that ``merge_topk`` takes, so every process holds the same
answer, ties to the lowest global index. The shards' real candidates number at
least k, and every real score is finite, so the filler never surfaces
(asserted on the host from the shard sizes, and on the indices ``search``
reads back). Every process calls ``topk``, ``search`` and ``add_cases``
together, with the same arguments. ``save`` writes from process 0 alone
and the others wait at a barrier (a divergence: JAX has every process
write the same file). A mesh of one process keeps the path above.

``mesh=None`` means ``default_mesh()``, every visible card, as in JAX,
except where ``device`` names one device: ``"cpu"`` (a one-device CPU mesh)
or ``"cuda:N"`` (that card alone). Reserving ``capacity`` keeps the shards'
shapes: ``add_cases`` writes the new rows into their shards in place (JAX
donates the buffer); past capacity the shards grow geometrically and are
placed anew. K6 takes each shard's valid rows as ``n_valid``, so it runs on
padded shards too: the JAX package's gate that turns ``use_pallas`` off
under padding has no counterpart.

    python -m emr2a_tpu_torch.retrieval.database build|add|query ...
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from emr2a_tpu_torch.ops.similarity import l2_normalize_rows
from emr2a_tpu_torch.utils.profiling import annotate
from emr2a_tpu_torch.ops.topk import (
    cosine_topk_fused,
    cosine_topk_fused_int8,
    score_matmul,
    topk_scores,
)
from emr2a_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    default_mesh,
    process_count,
    process_index,
)
from emr2a_tpu_torch.parallel.sharding import local_shards, shard_owners

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
    """f32 scores of q against db, both in the storage dtype (on the CPU
    summed as ``score_matmul`` sums them)."""
    if not q.is_cuda:
        return score_matmul(q.float(), db.float().T)
    if q.dtype == torch.float32:
        return q @ db.T
    return torch.mm(q, db.T, out_dtype=torch.float32)


def shard_topk(q: torch.Tensor, shard: torch.Tensor,
               scales: Optional[torch.Tensor], n_valid_local: int, base: int,
               k_local: int, use_pallas: bool
               ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """One shard's candidates: the top ``min(k_local, n_valid_local)`` of
    its first ``n_valid_local`` rows against ``q`` (on the shard's device,
    in the scan's dtype), as (values (q, k') f32, global indices (q, k')
    int32, offset by ``base``); None for an empty shard."""
    k = min(k_local, n_valid_local)
    if k < 1:
        return None
    if scales is not None:
        vals, idx = cosine_topk_fused_int8(q, shard, scales, k, n_valid=n_valid_local)
    elif use_pallas:
        vals, idx = cosine_topk_fused(q, shard, k, n_valid=n_valid_local)
    else:
        vals, idx = topk_scores(_scores(q, shard[:n_valid_local]), k)
        idx = idx.to(torch.int32)
    return vals, (idx + base if base else idx)


def merge_topk(candidates, k: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k of the shards' candidates (``shard_topk``'s results, in
    shard order, None for an empty shard), gathered to ``device``: a stable
    top-k in shard-major order, so ties go to the lowest global index."""
    present = [c for c in candidates if c is not None]
    if len(present) == 1:
        vals, idx = present[0]
        return vals.to(device)[:, :k], idx.to(device)[:, :k]
    on = lambda t: t.to(device, non_blocking=device.type == "cuda")
    vals = torch.cat([on(v) for v, _ in present], dim=1)
    idx = torch.cat([on(i) for _, i in present], dim=1)
    mvals, cols = topk_scores(vals, k)
    return mvals, torch.take_along_dim(idx, cols, dim=1)


def pack_candidates(candidates, q: int, k_local: int, slots: int,
                    device: torch.device) -> torch.Tensor:
    """A process's shards' candidates (``shard_topk``'s, None for an empty
    shard) as one int32 tensor (q, slots, 2, k_local) on ``device``: per
    shard the bits of its f32 values, then its indices, each padded to
    ``k_local`` with ``-inf`` and index -1 (JAX's filler), and ``slots``
    shards, the missing ones all filler (a collective needs equal
    shapes)."""
    out = torch.full((q, slots, 2, k_local), -1, dtype=torch.int32, device=device)
    out.view(torch.float32)[:, :, 0] = float("-inf")
    on = lambda t: t.to(device, non_blocking=device.type == "cuda")
    for j, c in enumerate(candidates):
        if c is not None:
            vals, idx = c
            out[:, j, 0, :vals.shape[1]] = on(vals).view(torch.int32)
            out[:, j, 1, :idx.shape[1]] = on(idx)
    return out


def all_gather_candidates(packed: torch.Tensor) -> torch.Tensor:
    """Every process's ``pack_candidates`` tensor, stacked in process order
    on ``packed``'s device: one all-gather, on that device with NCCL, over
    host copies with gloo."""
    world = torch.distributed.get_world_size()
    if torch.distributed.get_backend() == "nccl":
        out = torch.empty((world,) + tuple(packed.shape), dtype=packed.dtype,
                          device=packed.device)
        torch.distributed.all_gather_into_tensor(out, packed.contiguous())
        return out
    host = packed.cpu()
    parts = [torch.empty_like(host) for _ in range(world)]
    torch.distributed.all_gather(parts, host)
    return torch.stack(parts).to(packed.device)


def merge_gathered(gathered: torch.Tensor, order: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``all_gather_candidates``' (processes, q, slots, 2, k_local) tensor
    -> the top k: ``order`` lists each shard's (process * slots + slot) in
    shard order, so the candidates stand shard-major as in one process and
    ``merge_topk``'s stable top-k keeps ties to the lowest global index."""
    p, q, slots, _, k_local = gathered.shape
    flat = gathered.transpose(0, 1).reshape(q, p * slots, 2, k_local)
    flat = flat.index_select(1, order)
    vals = flat[:, :, 0].contiguous().view(torch.float32).reshape(q, -1)
    idx = flat[:, :, 1].reshape(q, -1)
    mvals, cols = topk_scores(vals, k)
    return mvals, torch.take_along_dim(idx, cols, dim=1)


class ShardedEmbeddingDatabase:
    """Case-retrieval database sharded over the mesh's ``data`` axis.

    Parameters
    ----------
    embeddings : (n, dim) array of case embeddings (``normalize=True``
        L2-normalises them once, so every query is a plain dot product).
    labels / ids : optional per-case metadata for ``search``.
    mesh : the mesh whose ``data`` axis holds the shards (see the module
        docstring for None).
    dtype : storage dtype, ``torch.float32``, ``torch.bfloat16`` or
        ``torch.int8``.
    """

    def __init__(self, embeddings: np.ndarray,
                 labels: Optional[Sequence[str]] = None,
                 ids: Optional[Sequence[str]] = None,
                 mesh: Optional[Mesh] = None,
                 normalize: bool = True,
                 dtype: torch.dtype = torch.float32,
                 use_pallas: bool = False,
                 capacity: Optional[int] = None,
                 device: str = "cuda"):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be an emr2a_tpu_torch.parallel.Mesh, "
                            f"got {type(mesh).__name__}")
        if dtype not in DTYPES:
            raise TypeError(f"dtype must be one of {DTYPES}, got {dtype}")
        if mesh is None:
            one = torch.device(device)
            mesh = (default_mesh() if one.type == "cuda" and one.index is None
                    else create_mesh((1, 1), devices=[one]))
        self.mesh = mesh
        owners = shard_owners(mesh)
        self.n_shards = len(owners)
        self.shard_ids = local_shards(mesh)   # this process's shards
        self.devices = [owners[i][1] for i in self.shard_ids]
        self.spans_processes = not mesh.is_local
        if self.spans_processes:
            self._check_processes(owners)
        self.device = self.devices[0]   # the queries' and the answers' device
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
        """Place the host matrix on the shards in the storage dtype, padded
        with zero rows (JAX's layout, module docstring)."""
        emb = self._host_emb
        self.n = emb.shape[0]
        target = max(self.n, self.capacity or 0)
        self.shard_size = -(-target // self.n_shards)
        self.shards, self.scale_shards = [], []
        for i, dev in zip(self.shard_ids, self.devices):
            rows = emb[i * self.shard_size:(i + 1) * self.shard_size]
            if rows.shape[0] < self.shard_size:
                rows = np.pad(rows, ((0, self.shard_size - rows.shape[0]), (0, 0)))
            if self.dtype == torch.int8:
                q8, scales = quantize_rows_int8(rows)
                self.shards.append(torch.from_numpy(q8).to(dev))
                self.scale_shards.append(torch.from_numpy(scales).to(dev))
            else:
                self.shards.append(torch.from_numpy(rows).to(dev, self.dtype))
        if self.dtype != torch.int8:
            self.scale_shards = None

    def _queries(self, queries, normalize: bool) -> torch.Tensor:
        qdtype = torch.float32 if self.scale_shards is not None else self.dtype
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device, qdtype)
        if q.dim() == 1:
            q = q[None, :]
        if normalize:
            q = l2_normalize_rows(q).to(qdtype)
        return q

    def _check_processes(self, owners) -> None:
        """A mesh over several processes: every process holds a shard, and
        the same number of them (one all-gather carries every process's)."""
        counts = [sum(p == r for p, _ in owners) for r in range(process_count())]
        if min(counts) == 0 or len(set(counts)) != 1:
            raise ValueError(f"a database over {process_count()} processes needs "
                             f"the same number of shards in each, at least one; "
                             f"the mesh's data axis gives {counts}")
        # each shard's place in the gathered (process * slots + slot) order
        slot = {r: 0 for r in range(len(counts))}
        order = []
        for p, _ in owners:
            order.append(p * counts[0] + slot[p])
            slot[p] += 1
        self._order = torch.tensor(order, device=self.devices[0])

    def _candidates(self, q: torch.Tensor, k_local: int) -> list:
        """The query sent to this process's shards' devices, then every
        shard's scan queued (module docstring). The copies go first: a
        copy from the first device runs on that device's stream, so one
        queued after the first shard's scan would hold the other cards'
        scans until that scan ends."""
        queries = [q.to(dev, non_blocking=True) for dev in self.devices]
        candidates = []
        for j, (i, qd, shard) in enumerate(zip(self.shard_ids, queries, self.shards)):
            base = i * self.shard_size
            candidates.append(shard_topk(
                qd, shard, None if self.scale_shards is None else self.scale_shards[j],
                min(max(self.n - base, 0), self.shard_size), base, k_local,
                self.use_pallas))
        return candidates

    def _scan(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The shards' candidates, then the merge: in one process directly,
        over several by one all-gather of the padded candidates."""
        k_local = min(k, self.shard_size)
        candidates = self._candidates(q, k_local)
        if not self.spans_processes:
            return merge_topk(candidates, k, self.device)
        real = sum(min(k_local, max(min(self.n - i * self.shard_size, self.shard_size), 0))
                   for i in range(self.n_shards))
        assert real >= k, f"{real} real candidates for k = {k}: filler would surface"
        packed = pack_candidates(candidates, q.shape[0], k_local, len(self.shards),
                                 self.device)
        return merge_gathered(all_gather_candidates(packed), self._order, k)

    def topk(self, queries: np.ndarray, k: int,
             normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q, dim) queries -> (values (q, k) f32, global indices (q, k)
        int32), on the mesh's first device. k is clamped to the number of
        cases."""
        k = min(k, self.n)
        return self._scan(self._queries(queries, normalize), k)

    def topk_chained(self, query: np.ndarray, k: int, repeats: int = 256,
                     normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Single-query latency probe: ``repeats`` back-to-back (1, dim)
        searches queued on the devices, of which the last result is returned
        (read back once by the caller). Search i adds ``i * 1e-9`` to the
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
        into their shards in place; past it the shards are rebuilt.
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
        if end <= self.shard_size * self.n_shards:
            self._write_rows(new, start)
            self.n = end
        else:
            if self.capacity is not None:
                # grow geometrically: repeated appends amortise to O(log)
                # rebuilds instead of one per batch
                self.capacity = max(end, 2 * self.capacity)
            self._upload()

    def _write_rows(self, rows: np.ndarray, start: int) -> None:
        """Write normalised f32 ``rows`` as global rows ``start..`` into the
        shards that hold them, in the storage dtype."""
        if self.scale_shards is not None:
            codes, scales = quantize_rows_int8(rows)
        end = start + rows.shape[0]
        for j, (i, dev, shard) in enumerate(zip(self.shard_ids, self.devices, self.shards)):
            lo = max(start, i * self.shard_size)
            hi = min(end, (i + 1) * self.shard_size)
            if lo >= hi:
                continue
            at = slice(lo - i * self.shard_size, hi - i * self.shard_size)
            part = slice(lo - start, hi - start)
            if self.scale_shards is not None:
                shard[at] = torch.from_numpy(codes[part]).to(dev)
                self.scale_shards[j][at] = torch.from_numpy(scales[part]).to(dev)
            else:
                shard[at] = torch.from_numpy(rows[part]).to(dev, self.dtype)

    def save(self, path) -> None:
        """Persist to npz (embeddings pre-normalised as stored); over
        several processes process 0 writes and the others wait for it."""
        if process_index() == 0 or not self.spans_processes:
            payload = {"embeddings": self._host_emb, "n": np.asarray(self.n)}
            if self.labels is not None:
                payload["labels"] = np.asarray(self.labels, dtype=object)
            if self.ids is not None:
                payload["ids"] = np.asarray(self.ids, dtype=object)
            np.savez_compressed(path, **payload)
        if self.spans_processes:
            torch.distributed.barrier()

    @classmethod
    def load(cls, path, mesh: Optional[Mesh] = None, dtype: torch.dtype = torch.float32,
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
        patient_id}. Traced (``utils/profiling``), a call is the span
        ``db.search`` over ``db.queries`` (normalise and upload),
        ``db.scan`` (the shards' scans and the merge, with the device's
        time), ``db.readback`` and ``db.hits``."""
        k = min(k, self.n)
        with annotate("db.search"):
            with annotate("db.queries"):
                q = self._queries(queries, normalize)
            with annotate("db.scan", device=self.device):
                vals, idx = self._scan(q, k)
            with annotate("db.readback"):
                vals = vals.cpu().numpy()
                idx = idx.cpu().numpy()
            assert (idx >= 0).all(), "a shard's filler candidate surfaced"
            with annotate("db.hits"):
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
