"""The port's tracer (``emr2a_tpu_torch/utils/profiling.py``) and the spans
and counters the hot path records with it, on the CPU:

- off (no profiler): ``annotate`` is one shared no-op that opens no
  profiler range, reads no clock and stores nothing, and ``count`` stores
  nothing, through the database and the encode engine too;
- the tiny Qwen3-VL judge served through ``generate_stream`` and through
  ``generate``: the spans' names, parents and request ids, and the decode
  counters against hand counts of the budgets (``generate``'s 64-step
  chunks included);
- the encode engine's ``encode.*`` and the database's ``db.*`` spans;
- each stored start within 1 ms of its ``record_function`` range;
- one profiled window per store;
- ``trace_to``'s ``spans.json``: spans, counters and launch-counter
  increments.
"""

import json
import types

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from emr2a_tpu_torch.utils import profiling
from emr2a_tpu_torch.utils.profiling import StageTimer, annotate, count, snapshot, trace_to

torch.set_num_threads(1)


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def tiny_database(n=300, dim=16, seed=0):
    from emr2a_tpu_torch.retrieval.database import ShardedEmbeddingDatabase
    rows = np.random.RandomState(seed).randn(n, dim).astype(np.float32)
    return ShardedEmbeddingDatabase(rows, device="cpu")


class MeanTower(torch.nn.Module):
    """(B, H, W, 3) pixels -> (B, 3 * 8) features."""

    def forward(self, x):
        return torch.cat([x.mean(dim=(1, 2))] * 8, dim=1)


def tiny_encoder():
    from emr2a_tpu_torch.encoders.jit_encoder import BatchedImageTextEncoder
    from emr2a_tpu_torch.ops.preprocess import PreprocessSpec
    spec = PreprocessSpec(resize_size=16, crop_size=16, shortest_edge=False)
    return BatchedImageTextEncoder(MeanTower(), preprocess=spec, max_batch=4, device="cpu")


def images(n, size=20, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(size, size, 3) * 255).astype(np.uint8) for _ in range(n)]


def by_name(snap):
    out = {}
    for i, s in enumerate(snap["spans"]):
        out.setdefault(s["name"], []).append(dict(s, index=i))
    return out


def test_off_path_touches_nothing(monkeypatch):
    before = snapshot()

    def boom(*args, **kwargs):
        raise AssertionError("called while no profiler records")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    # the spans' clock (StageTimer keeps its own)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        time_ns=boom, perf_counter=profiling.time.perf_counter))
    assert annotate("a") is annotate("b", request=3, device="cuda:0") is profiling._OFF
    with annotate("a", request=1, device=torch.device("cpu")):
        count("c", 5)
    timer = StageTimer()
    with timer.stage("stage"):
        pass
    assert timer.summary()["stage"]["calls"] == 1
    db = tiny_database()
    assert len(db.search(np.ones((1, 16), np.float32), 3)[0]) == 3
    assert len(tiny_encoder().encode_batch_images(images(5))) == 5
    assert snapshot() == before


@pytest.fixture(scope="module")
def judge():
    """The judge backend over a tiny random Qwen3-VL (f32, on the CPU), with
    the stub word tokenizer; ``rows`` collects each decoded row."""
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    from emr2a_tpu_torch.models import qwen3_vl as pq
    from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

    config = pq.Qwen3VLConfig(
        vision=pq.QwenVisionConfig(
            depth=2, hidden_size=32, intermediate_size=64, num_heads=2, patch_size=16,
            temporal_patch_size=2, spatial_merge_size=2, out_hidden_size=64,
            num_position_embeddings=16, deepstack_visual_indexes=(0,)),
        text=pq.QwenTextConfig(
            vocab_size=151936, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, intermediate_size=128, mrope_section=(4, 2, 2)),
        image_token_id=151655, vision_start_token_id=151652)
    backend = QwenVLBackend(config=config, params=pq.random_state(config, 0, "cpu"),
                            tokenizer=WordTokenizer(), prompt_bucket=32, device="cpu")
    rows = []
    decode = backend._decode_row
    backend._decode_row = lambda row: rows.append(np.asarray(row).copy()) or decode(row)
    return backend, rows


def requests(n):
    img = Image.fromarray(images(1, size=64)[0])
    return [{"images": [img], "prompt": f"audit case {i}", "system": "be brief",
             "max_new_tokens": b} for i, b in zip(range(n), (3, 5, 4))]


def kept(row, eos):
    row = list(row)
    return row.index(eos) + 1 if eos in row else len(row)


def test_judge_spans_and_counters(judge):
    backend, rows = judge
    eos = backend.generator.eos_token_id
    reqs = requests(3)

    # continuous: 3 requests over 2 slots, budgets 3, 5 and 4, chunks of 16
    rows.clear()
    with profiled():
        backend.generate_stream(reqs, max_new_tokens=8, n_slots=2)
    snap = snapshot()
    names = by_name(snap)
    assert [s["request"] for s in names["judge.prepare"]] == [0, 1, 2]
    for stage in ("resize", "patches", "tokens"):
        parents = {s["parent"] for s in names[f"judge.prepare.{stage}"]}
        assert parents == {s["index"] for s in names["judge.prepare"]}
    (wave,) = names["batcher.wave"]
    for child in ("batcher.shared_prefix", "batcher.refill", "batcher.dispatch",
                  "batcher.emit"):
        assert {s["parent"] for s in names[child]} == {wave["index"]}, child
    refills = {s["index"] for s in names["batcher.refill"]}
    assert {s["parent"] for s in names["batcher.prefill"]} == refills
    assert {s["parent"] for s in names["batcher.insert"]} == refills
    # the two first requests prefill together, the third alone
    assert [s["request"] for s in names["batcher.prefill"]] == [(0, 1), (2,)]
    assert len(names["judge.detokenize"]) == 3
    assert all(s["device_ms"] is None and s["end_ns"] >= s["start_ns"]
               for s in snap["spans"])
    c = snap["counters"]
    # chunk 1 serves both first slots to their budgets; the third request
    # takes chunk 2 alone (no lookahead: no budget outlives a chunk)
    assert c["batcher.refills"] == 2 and c["batcher.prefill_rows"] == 3
    assert c["batcher.dispatches"] == 2 and "batcher.lookahead_dispatches" not in c
    assert c["decode.steps"] == 32 and c["decode.row_steps"] == 64
    assert c["decode.active_row_steps"] == 2 * 16 + 16
    assert c["decode.tokens_kept"] == sum(kept(r, eos) for r in rows)
    assert len(rows) == 3 and [len(r) for r in rows] == [3, 5, 4]

    # one at a time: generate decodes whole 64-step chunks
    rows.clear()
    with profiled():
        for r, budget in zip(reqs[:2], (10, 70)):
            backend.generate(r["images"], r["prompt"], system=r["system"],
                             max_new_tokens=budget)
    snap = snapshot()
    names = by_name(snap)
    assert [s["request"] for s in names["judge.prepare"]] == [None, None]
    assert len(names["generator.prefill"]) == 2
    assert len(names["generator.decode"]) == 1 + 2
    assert len(names["generator.read"]) == 2
    assert all(s["parent"] is None for n in ("generator.prefill", "generator.decode")
               for s in names[n])
    c = snap["counters"]
    assert c["decode.steps"] == c["decode.row_steps"] == 64 + 128
    assert c["decode.tokens_kept"] == sum(kept(r, eos) for r in rows)
    assert c["decode.tokens_kept"] <= 10 + 70


def test_kept_tokens_counts_to_the_first_eos():
    from emr2a_tpu_torch.models.qwen3_vl import kept_tokens
    tokens = np.array([[5, 6, 9, 9, 9, 9], [5, 6, 7, 8, 1, 2], [9, 9, 9, 9, 9, 9]])
    assert kept_tokens(tokens, 9, 4) == 3 + 4 + 1
    assert kept_tokens(tokens, 9, 6) == 3 + 6 + 1


def test_encode_and_search_spans():
    encoder, db = tiny_encoder(), tiny_database()
    with profiled():
        encoder.encode_batch_images(images(6))       # two device batches of 4 and 2
        db.search(np.ones((2, 16), np.float32), 5)
    names = by_name(snapshot())
    (batch,) = names["encode.batch"]
    assert len(names["encode.resize"]) == 1
    for stage in ("encode.stack", "encode.upload", "encode.tower", "encode.readback"):
        assert len(names[stage]) == 2, stage
    for stage in ("encode.resize", "encode.stack", "encode.upload", "encode.tower",
                  "encode.readback"):
        assert {s["parent"] for s in names[stage]} == {batch["index"]}, stage
    (search,) = names["db.search"]
    for stage in ("db.queries", "db.scan", "db.readback", "db.hits"):
        (s,) = names[stage]
        assert s["parent"] == search["index"]
        assert search["start_ns"] <= s["start_ns"] <= s["end_ns"] <= search["end_ns"]
    assert names["db.scan"][0]["device_ms"] is None      # no device events on the CPU


def test_span_starts_lie_on_the_profiler_clock():
    db = tiny_database()
    with profiled():                                     # the first range's set-up
        db.search(np.ones((1, 16), np.float32), 3)
    with profiled() as prof:
        for _ in range(5):
            db.search(np.ones((1, 16), np.float32), 3)
    stored = [s for s in snapshot()["spans"]]
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e.start_ns())
    assert len(stored) == 5 * 5
    for s in stored:
        nearest = min(abs(t - s["start_ns"]) for t in events[s["name"]])
        assert nearest < 1_000_000, (s["name"], nearest)


def test_one_window_per_store():
    with profiled():
        with annotate("first", request=1):
            count("first.count")
    assert [s["name"] for s in snapshot()["spans"]] == ["first"]
    with profiled():
        with annotate("second", request=2):
            count("second.count", 4)
    snap = snapshot()
    assert [(s["name"], s["request"]) for s in snap["spans"]] == [("second", 2)]
    assert snap["counters"] == {"second.count": 4}
    with profiled():
        pass
    assert snapshot() == {"spans": [], "counters": {}}


def test_trace_to_writes_spans_json(tmp_path, monkeypatch):
    from emr2a_tpu_torch.models import cuda_graph
    from emr2a_tpu_torch.ops import topk
    monkeypatch.setattr(topk, "LAUNCHES", 7)
    monkeypatch.setattr(cuda_graph, "CAPTURES", 1)
    with trace_to(str(tmp_path)):
        with annotate("outer", request="r1"):
            with annotate("inner"):
                count("things", 2)
        topk.LAUNCHES += 3
        cuda_graph.CAPTURES += 1
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1
    out = json.loads((tmp_path / "spans.json").read_text())
    assert [(s["name"], s["parent"], s["request"]) for s in out["spans"]] == [
        ("outer", None, "r1"), ("inner", 0, None)]
    assert out["counters"] == {"things": 2}
    assert out["launches"]["topk.LAUNCHES"] == 3
    assert out["launches"]["cuda_graph.CAPTURES"] == 1
    assert out["launches"]["mlp.LAUNCHES"] == 0
