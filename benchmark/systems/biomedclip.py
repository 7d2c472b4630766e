"""BioMedCLIP's cells: step2's embedding of a cohort (traffic kind
``batches``) and case retrieval (kind ``cases``), through the program's
public entry points: ``BioMedCLIPEncoder.encode_batch_images`` (the bf16
tower on the fused blocks, K1 and K3, as step2's ``--fast``) and
``ShardedEmbeddingDatabase.search`` (K6's scan over the cases).

Weights come from the reference's plan, drawn on the device from the seed
(``core/seeded.py``) and loaded through the encoder's constructor; the
slices from ``inputs/ct_slices.py``; the database's rows from the seed.
``precision`` ("bf16" or the program's own "int8" path) and the database's
``dtype`` come from the configuration, which the control overrides.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core import registry, seeded
from benchmark.core.traffic import Schedule
from benchmark.inputs.ct_slices import make_slices, rgb

KEEP_UNITS = {"batches": 4, "cases": 8}    # units the reference judges


def _pool(cfg: dict, mix: dict, seed: int, device) -> np.ndarray:
    """The mix's slices, patient-major: (patients x slices_per_patient,
    size, size, 3) uint8."""
    n_pat, per = int(mix["patients"]), int(mix["slices_per_patient"])
    patients = np.repeat(np.arange(n_pat), per)
    depths = np.tile(np.arange(per) / per, n_pat)
    return rgb(make_slices(patients, depths, cfg["image_size"], seed, device))


def _encoder(cfg: dict, state: dict, device, max_batch: int):
    from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
    from emr2a_tpu_torch.models.clip import BioMedCLIPConfig
    from emr2a_tpu_torch.models.vit import ViTConfig

    vit = ViTConfig(image_size=cfg["image_size"], patch_size=cfg["patch_size"],
                    hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
                    num_heads=cfg["num_attention_heads"], mlp_dim=cfg["intermediate_size"],
                    activation=cfg["hidden_act"], ln_eps=cfg["layer_norm_eps"], pooling="cls")
    config = BioMedCLIPConfig(vision=vit, text=None, projection_dim=cfg["projection_dim"])
    fast = {"bf16": True, "int8": "int8"}[cfg["precision"]]
    return BioMedCLIPEncoder(config=config, params={f"image.{k}": v for k, v in state.items()},
                             fast=fast, device=str(device), max_batch=max_batch)


def _rows(cfg: dict, seed: int, device) -> torch.Tensor:
    db = cfg["database"]
    return torch.randn((int(db["cases"]), int(db["dim"])), device=device,
                       generator=seeded.generator(seed, "rows", device))


class Cell:
    def __init__(self, ctx):
        cfg, mix = ctx.config, ctx.mix
        self.ctx, self.kind = ctx, mix["kind"]
        ref = registry.reference(cfg["name"], ctx.root)
        state = seeded.draw(ref.weight_plan(cfg), ctx.seed, ctx.device, torch.bfloat16)
        batch = int(mix["batch"]) if self.kind == "batches" else int(mix["slices"][1])
        self.encoder = _encoder(cfg, state, ctx.device, batch)
        del state
        self.pool = list(_pool(cfg, mix, ctx.seed, ctx.device))
        self.schedule = Schedule(mix, ctx.seed)
        self.db = None
        if self.kind == "cases":
            from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase
            dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg["database"]["dtype"]]
            host = _rows(cfg, ctx.seed, ctx.device).cpu().numpy()
            self.db = ShardedEmbeddingDatabase(host, dtype=dtype, use_pallas=True,
                                               device=str(ctx.device))
            del host
        self.keep = KEEP_UNITS[self.kind]
        self.kept = []                                   # reservoir of records
        self.choice = seeded.rng(ctx.seed, "keep")

    def warm(self) -> None:
        mix = self.ctx.mix
        if self.kind == "batches":
            for i in range(2):
                self.encoder.encode_batch_images([self.pool[j] for j in
                                                  self.schedule.unit(i)["indices"]])
            return
        lo, hi = (int(x) for x in mix["slices"])
        for n in range(lo, hi + 1):             # every batch size the cases send
            emb = self.encoder.encode_batch_images(self.pool[:n])
        for _ in range(3):
            self.db.search(np.mean(emb, axis=0)[None], int(mix["k"]))

    def _reservoir(self, rec: dict, payload) -> None:
        i = rec["unit_index"]
        if len(self.kept) < self.keep:
            self.kept.append(rec)
        else:
            j = int(self.choice.integers(i + 1))
            if j >= self.keep:
                return
            self.kept[j].pop("out", None)
            self.kept[j] = rec
        rec["out"] = payload

    def step(self, i: int) -> dict:
        unit = self.schedule.unit(i)
        span = self.ctx.tracer.span
        if self.kind == "batches":
            images = [self.pool[j] for j in unit["indices"]]
            t0 = time.perf_counter()
            with span("encode_batch_images"):
                out = self.encoder.encode_batch_images(images)
            failed = sum(o is None for o in out)
            rec = {"unit_index": i, "unit": unit, "items": len(images), "failed": failed,
                   "seconds": time.perf_counter() - t0}
            if not failed:
                self._reservoir(rec, np.stack(out))
            return rec
        start = unit["patient"] * int(self.ctx.mix["slices_per_patient"]) + unit["start"]
        images = self.pool[start:start + unit["n"]]
        t0 = time.perf_counter()
        with span("encode_batch_images"):
            emb = self.encoder.encode_batch_images(images)
        with span("case_mean"):
            q = np.mean(np.stack(emb), axis=0)
            q = q / np.linalg.norm(q)
        with span("search"):
            hits = self.db.search(q[None], int(self.ctx.mix["k"]))[0]
        latency = time.perf_counter() - t0
        failed = int(any(e is None for e in emb) or len(hits) < int(self.ctx.mix["k"]))
        rec = {"unit_index": i, "unit": unit, "items": 1, "failed": failed,
               "latency_s": latency, "seconds": latency}
        if not failed:
            self._reservoir(rec, {"emb": np.stack(emb), "q": q,
                                  "hits": [(h["index"], h["score"]) for h in hits]})
        return rec

    def release(self) -> None:
        self.encoder = self.db = self.pool = None


def build(ctx) -> Cell:
    return Cell(ctx)


def judge(ctx, records) -> list:
    """(name, value, limit) for the cell's numbers (``cells/<workload>.json``
    holds the limits): ``emb_gap``, the widest distance between a judged
    slice's embedding and the reference's (both unit vectors); ``emb_bias``,
    the length of the mean of those differences (the program's systematic
    error: a lower precision's shows here, while rounding's averages out);
    and in the retrieval cell ``hit_gap``, the widest of, over the judged cases' hits
    j: the reference's j-th best score less the reference's score of the
    program's j-th hit, and the distance between the program's score of a
    hit and the reference's (scores of the program's own case vector, in
    float64, over the same seeded rows)."""
    cfg, mix, limits = ctx.config, ctx.mix, ctx.cell["limits"]
    ref = registry.reference(cfg["name"], ctx.root)
    kept = [r for r in records if "out" in r]
    if not kept:
        return [("judged_units", 0.0, -1.0)]
    pool = _pool(cfg, mix, ctx.seed, ctx.device)
    if mix["kind"] == "batches":
        idx = [j for r in kept for j in r["unit"]["indices"]]
        got = np.concatenate([r["out"] for r in kept])
    else:
        per = int(mix["slices_per_patient"])
        idx = [r["unit"]["patient"] * per + r["unit"]["start"] + j
               for r in kept for j in range(r["unit"]["n"])]
        got = np.concatenate([r["out"]["emb"] for r in kept])
    w = seeded.draw(ref.weight_plan(cfg), ctx.seed, ctx.device, torch.bfloat16)
    want = torch.cat([ref.image_embeddings(w, torch.from_numpy(pool[idx[lo:lo + 64]]).to(ctx.device),
                                           cfg) for lo in range(0, len(idx), 64)])
    del w
    got_t = torch.from_numpy(got).to(want.device).float()
    err = got_t - want
    gaps = err.norm(dim=-1)
    ctx.diag.update(emb_gap_mean=float(gaps.mean()), judged_rows=len(idx))
    checks = [("emb_gap", float(gaps.max()), limits["emb_gap"]),
              ("emb_bias", float(err.mean(dim=0).norm()), limits["emb_bias"])]
    if mix["kind"] == "cases":
        rows = _rows(cfg, ctx.seed, ctx.device)
        q = torch.from_numpy(np.stack([r["out"]["q"] for r in kept])).to(ctx.device)
        k = int(mix["k"])
        best, _ = ref.top_k(q, rows, k)
        hit_idx = torch.tensor([[h[0] for h in r["out"]["hits"]] for r in kept], device=q.device)
        hit_score = torch.tensor([[h[1] for h in r["out"]["hits"]] for r in kept],
                                 dtype=torch.float64, device=q.device)
        theirs = ref.scores_of(q, rows, hit_idx)
        gap = torch.maximum(best - theirs, (hit_score - theirs).abs())
        checks.append(("hit_gap", float(gap.max()), limits["hit_gap"]))
    return checks
