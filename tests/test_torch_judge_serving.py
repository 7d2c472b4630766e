"""The judge's batched and continuous serving above the batcher, on the CPU
against the JAX package, with both packages' ``QwenVLBackend`` over the tiny
random-init HF Qwen3-VL of ``tests/test_qwen3_vl_parity.py`` (one state
dict, f32) and the JAX suite's ``ToyTokenizer``:

- ``generate_batch`` and ``generate_stream`` give JAX's texts, and equal
  each other and ``generate`` per request; a sampled request beside them
  leaves the greedy rows alone and repeats; a per-request budget cuts its
  row's stream;
- ``audit_batch`` with ``vlm_batch_size=3`` and with ``serving=
  "continuous"`` gives JAX's audit rows, and the one-case loop's; with the
  fake backend, the batch and slot shapes handed to the backend equal
  JAX's, and a case whose evidence image is unreadable abstains alone;
- step4's CLI with ``--vlm_batch_size 2 --serving continuous --device cpu``
  writes JAX's artifacts.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from emr2a_tpu.judge.audit import VLMAuditModule as JaxAudit
from emr2a_tpu.judge.backends import FakeVLMBackend as JaxFakeBackend
from emr2a_tpu.pipelines.step4_vlm_review.run import (
    run_vlm_audit_pipeline as jax_run_pipeline,
)
from emr2a_tpu_torch.judge.audit import VLMAuditModule
from emr2a_tpu_torch.judge.backends import FakeVLMBackend
from emr2a_tpu_torch.pipelines.step4_vlm_review import run as step4
from tests.test_torch_judge import cv_experiment  # noqa: F401  (a fixture)

torch.set_num_threads(1)
pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def backends():
    """(JAX backend, port backend) over one tiny HF state dict."""
    import emr2a_tpu.models.qwen3_vl as jq
    from emr2a_tpu.encoders.qwen3_vl_encoder import make_image_processor as jax_processor
    from emr2a_tpu.judge.qwen_backend import QwenVLBackend as JaxBackend
    from emr2a_tpu_torch.encoders.qwen3_vl_encoder import make_image_processor
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    from emr2a_tpu_torch.models import qwen3_vl as pq
    from emr2a_tpu_torch.models.convert import params_from_jax
    from tests.test_qwen3_vl_parity import tiny_hf_model
    from tests.test_qwen_encoder_backend import ToyTokenizer

    model, cfg = tiny_hf_model()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    jcfg = jq.qwen3_vl_config_from_hf(cfg.to_dict())
    jax_be = JaxBackend(None, config=jcfg, params=jq.convert_hf_qwen3_vl(sd, 3, 2),
                        tokenizer=ToyTokenizer(), prompt_bucket=32,
                        image_processor=jax_processor(jcfg.vision, min_pixels=16,
                                                      max_pixels=16384))
    pcfg = pq.qwen3_vl_config_from_hf(cfg.to_dict())
    port_be = QwenVLBackend(config=pcfg, params=params_from_jax(pq.convert_hf_qwen3_vl(
        sd, 3, 2)), tokenizer=ToyTokenizer(), prompt_bucket=32, device="cpu",
        image_processor=make_image_processor(pcfg.vision, min_pixels=16,
                                             max_pixels=16384))
    return jax_be, port_be


def test_backend_batch_and_stream_equal_jax(backends, rng):
    jax_be, be = backends
    img = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
    requests = [{"images": [img], "prompt": p}
                for p in ("describe", "what is this", "findings please")]
    batch = be.generate_batch(requests, max_new_tokens=8)
    assert batch == jax_be.generate_batch(requests, max_new_tokens=8)
    assert batch == [be.generate(r["images"], r["prompt"], max_new_tokens=8)
                     for r in requests]
    stream = be.generate_stream(requests, max_new_tokens=8, n_slots=2)
    assert stream == batch == jax_be.generate_stream(requests, max_new_tokens=8, n_slots=2)
    assert len(be._batchers) == 1                     # one per (bucket, slots, budget)

    mixed = requests + [dict(requests[0], temperature=0.8, top_p=0.9, seed=7)]
    sampled = be.generate_stream(mixed, max_new_tokens=8, n_slots=2)
    assert sampled[:3] == batch
    assert sampled == be.generate_stream(mixed, max_new_tokens=8, n_slots=2)
    short = be.generate_stream([dict(requests[0], max_new_tokens=4)], max_new_tokens=8,
                               n_slots=2)[0]
    assert short.split() == batch[0].split()[:4]
    assert be.generate_batch([]) == be.generate_stream([]) == []


def _records(tmp_path, rng, n=3, unreadable=()):
    records = []
    for i in range(n):
        slices = []
        for s in range(2):
            p = tmp_path / f"p{i}_{s}.png"
            if i in unreadable:
                p.write_bytes(b"not a png")
            else:
                Image.fromarray((rng.rand(16, 16, 3) * 255).astype(np.uint8)).save(p)
            slices.append(str(p))
        records.append({"patient_id": f"p{i}", "label": "PJP", "slices": slices,
                        "meta": {"sex": "M", "age": "50"}})
    return dict(retrieval_predictions=["PJP", "Viral", "Normal", "PJP"][:n],
                retrieval_similarities=[[0.9]] * n, retrieval_labels=[["PJP"]] * n,
                query_patients=records, top_neighbors_list=[[("p0", "PJP", 0.9)]] * n,
                manifest=records, max_new_tokens=6)


@pytest.mark.parametrize("mode", [dict(vlm_batch_size=3),
                                  dict(vlm_batch_size=2, serving="continuous")])
def test_audit_batch_modes_equal_jax(backends, rng, tmp_path, mode):
    jax_be, be = backends
    kwargs = _records(tmp_path, rng)
    want = JaxAudit(backend=jax_be).audit_batch(output_dir=tmp_path / "j", **mode, **kwargs)
    got = VLMAuditModule(backend=be).audit_batch(output_dir=tmp_path / "p", **mode, **kwargs)
    assert got == want and len(got["audit_results"]) == 3
    one = VLMAuditModule(backend=be).audit_batch(output_dir=tmp_path / "o", **kwargs)
    assert one["audit_results"] == got["audit_results"]


@pytest.mark.parametrize("mode", [dict(vlm_batch_size=2),
                                  dict(vlm_batch_size=3, serving="continuous")])
def test_audit_batch_shapes_and_abstain_alone_equal_jax(rng, tmp_path, mode):
    """Four cases, the second with unreadable slices: it abstains alone, the
    others go to the backend in the batches (2 + 1) or the one stream JAX's
    audit hands its backend."""
    kwargs = _records(tmp_path, rng, n=4, unreadable=(1,))
    jax_be, be = JaxFakeBackend(), FakeVLMBackend()
    want = JaxAudit(backend=jax_be).audit_batch(output_dir=tmp_path / "j", **mode, **kwargs)
    got = VLMAuditModule(backend=be).audit_batch(output_dir=tmp_path / "p", **mode, **kwargs)
    assert got == want
    assert [r["final_decision"] for r in got["audit_results"]] == \
        ["accept", "abstain", "accept", "accept"]
    for name in ("batch_calls", "stream_calls"):
        assert getattr(be, name, None) == getattr(jax_be, name, None), name
    assert (be.batch_calls == [2, 1]) if "serving" not in mode else \
        (be.stream_calls == [{"n": 3, "n_slots": 3, "temperatures": [0.0] * 3}])


def test_step4_cli_continuous_equals_jax(tmp_path, cv_experiment):  # noqa: F811
    exp_dir, manifest = cv_experiment
    jax_run_pipeline(exp_dir, manifest, tmp_path / "jax", max_samples=3,
                     backend=JaxFakeBackend(), vlm_batch_size=2, serving="continuous")
    step4.main(["--exp_dir", str(exp_dir), "--manifest_path", str(manifest),
                "--output_dir", str(tmp_path / "port"), "--model_path", "fake",
                "--device", "cpu", "--max_samples", "3", "--vlm_batch_size", "2",
                "--serving", "continuous"])
    for name in ("vlm_audit_summary.json", "vlm_audit_details.jsonl"):
        assert (tmp_path / "port" / name).read_text(encoding="utf-8") == \
            (tmp_path / "jax" / name).read_text(encoding="utf-8"), name
    summary = json.loads((tmp_path / "port" / "vlm_audit_summary.json").read_text())
    assert summary["audit_summary"]["accept_count"] == 3
