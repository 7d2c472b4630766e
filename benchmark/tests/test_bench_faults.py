"""Faults planted under the timed path, at test sizes on the CPU: each run
must come out not correct (the harness's look for a card is skipped; the
rest of the run is the benchmark's own)."""

import numpy as np
import pytest

from bench_sizes import run


def _alter_first_row(monkeypatch):
    from emr2a_tpu_torch.encoders import jit_encoder
    original = jit_encoder.BatchedImageTextEncoder._image_forward

    def altered(self, batch):
        out = original(self, batch)
        out[0] = -out[0]
        return out

    monkeypatch.setattr(jit_encoder.BatchedImageTextEncoder, "_image_forward", altered)


def _half_batch(monkeypatch):
    from emr2a_tpu_torch.encoders import jit_encoder
    original = jit_encoder.BatchedImageTextEncoder._image_forward

    def half(self, batch):
        n = (len(batch) + 1) // 2
        out = original(self, batch[:n])
        return np.concatenate([out, out])[:len(batch)]

    monkeypatch.setattr(jit_encoder.BatchedImageTextEncoder, "_image_forward", half)


def _wrong_hit(monkeypatch):
    from emr2a_tpu_torch.retrieval import database
    original = database.ShardedEmbeddingDatabase.search

    def wrong(self, queries, k, normalize=True):
        out = original(self, queries, k, normalize)
        for hits in out:
            hits[0]["index"] = (hits[0]["index"] + 1) % self.n
        return out

    monkeypatch.setattr(database.ShardedEmbeddingDatabase, "search", wrong)


def _alter_tokens(rows):
    rows = np.array(rows, copy=True)
    rows[:, :2] = (rows[:, :2] + 7919) % 150000 + 1000
    return rows


def _token_in_batcher(monkeypatch):
    from emr2a_tpu_torch.models import serving
    original = serving.ContinuousBatcher.serve

    def altered(self, *args, **kwargs):
        return [_alter_tokens([row])[0] for row in original(self, *args, **kwargs)]

    monkeypatch.setattr(serving.ContinuousBatcher, "serve", altered)


def _token_in_generator(monkeypatch):
    from emr2a_tpu_torch.models import qwen3_vl
    original = qwen3_vl.Qwen3VLGenerator.generate

    def altered(self, *args, **kwargs):
        return _alter_tokens(original(self, *args, **kwargs))

    monkeypatch.setattr(qwen3_vl.Qwen3VLGenerator, "generate", altered)


FAULTS = [("biomedclip.embed", _alter_first_row), ("biomedclip.embed", _half_batch),
          ("biomedclip.query", _alter_first_row), ("biomedclip.query", _wrong_hit),
          ("qwen3-vl-8b.audit", _token_in_batcher),
          ("qwen3-vl-8b.audit-solo", _token_in_generator)]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = run(workload)
    assert out["correct"] is False, out["checks"]
