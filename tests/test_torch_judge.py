"""The port's step4 judge layer on the CPU against the JAX package:

- the numpy/PIL Qwen image processor against transformers'
  ``Qwen2VLImageProcessor`` (pixel values within 1e-6, grids equal);
- the numpy copies of sklearn's ``roc_curve``, ``roc_auc_score``,
  ``precision_recall_curve`` and ``f1_score`` against sklearn, and the audit
  metrics against JAX's;
- the parsers and prompts equal to JAX's;
- ``run_vlm_audit_pipeline`` with ``FakeVLMBackend`` on the same fold files
  writes the same ``vlm_audit_summary.json`` and details as JAX's, and the
  step4 CLI runs;
- ``QwenVLBackend`` generates on a tiny random Qwen3-VL in bf16, int8 and
  int4 on the CPU, its batched and continuous serving give each request's
  own text, and the port's divergences hold: a backend that fails to load
  raises, a backend error propagates out of the audit (one case at a time,
  batched or continuous).
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from emr2a_tpu.eval import audit_metrics as jax_metrics
from emr2a_tpu.judge import parsers as jax_parsers
from emr2a_tpu.judge import prompts as jax_prompts
from emr2a_tpu.judge.backends import FakeVLMBackend as JaxFakeBackend
from emr2a_tpu.pipelines.step4_vlm_review.run import (
    run_vlm_audit_pipeline as jax_run_pipeline,
)
from emr2a_tpu_torch.encoders.qwen3_vl_encoder import QwenImageProcessor, make_image_processor
from emr2a_tpu_torch.eval import audit_metrics
from emr2a_tpu_torch.judge import parsers, prompts
from emr2a_tpu_torch.judge.audit import VLMAuditModule
from emr2a_tpu_torch.judge.backends import FakeVLMBackend, load_backend
from emr2a_tpu_torch.parallel import force_cpu_devices
from emr2a_tpu_torch.parallel import mesh as port_mesh
from emr2a_tpu_torch.pipelines.step4_vlm_review import run as step4
from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

torch.set_num_threads(1)

SCRIPT = ['{"decision": "accept", "confidence": 0.9, "cited_neighbors": [1], '
          '"rationale": "consistent"}',
          '```json\n{"decision": "reject", "confidence": 0.8}\n```',
          "garbage",
          "<think>hmm</think> I would accept this. Confidence: 0.75",
          '{"decision": "uncertain", "confidence": "high"}',
          '{"decision": "support", "confidence": 1.7, "cited_neighbors": ["2", "x"]}']


@pytest.mark.parametrize("h,w,patch,min_px,max_px,mode", [
    (16, 16, 4, 16, 16384, "RGB"), (24, 16, 4, 16, 16384, "RGB"),
    (512, 512, 16, 3136, 12845056, "L"), (300, 417, 16, 3136, 12845056, "RGB"),
    (40, 31, 4, 16, 400, "RGB"), (50, 700, 14, 3136, 50176, "L")])
def test_image_processor_matches_transformers(rng, h, w, patch, min_px, max_px, mode):
    from transformers.models.qwen2_vl.image_processing_qwen2_vl import Qwen2VLImageProcessor
    arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    img = Image.fromarray(arr).convert(mode)
    kw = dict(patch_size=patch, temporal_patch_size=2, merge_size=2,
              min_pixels=min_px, max_pixels=max_px)
    want = Qwen2VLImageProcessor(**kw)(images=[img], return_tensors="np")
    got = QwenImageProcessor(**kw)(images=[img])
    assert got["pixel_values"].dtype == want["pixel_values"].dtype
    np.testing.assert_array_equal(got["image_grid_thw"], want["image_grid_thw"])
    np.testing.assert_allclose(got["pixel_values"], want["pixel_values"], atol=1e-6, rtol=0)
    if mode == "RGB":       # an RGB uint8 array, as the backend passes it
        got = QwenImageProcessor(**kw)(images=[np.asarray(img)])
        np.testing.assert_allclose(got["pixel_values"], want["pixel_values"], atol=1e-6)


def test_make_image_processor_follows_the_vision_config():
    from emr2a_tpu_torch.models.qwen3_vl import QwenVisionConfig
    proc = make_image_processor(QwenVisionConfig())
    out = proc(images=[np.zeros((512, 512, 3), np.uint8)])
    assert out["image_grid_thw"].tolist() == [[1, 32, 32]]
    assert out["pixel_values"].shape == (1024, 3 * 2 * 16 * 16)


def test_sklearn_copies_equal_sklearn(rng):
    from sklearn import metrics as sk
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _compare_with_sklearn(rng, sk)


def _compare_with_sklearn(rng, sk):
    for _ in range(200):
        n = rng.randint(2, 40)
        y = rng.randint(0, 2, n).astype(float)
        if len(np.unique(y)) < 2:
            continue
        scale = rng.choice([1, 4, 10, 100])
        s = np.round(rng.rand(n) * scale) / scale          # many ties
        for got, want in zip(audit_metrics.roc_curve(y, s), sk.roc_curve(y, s)):
            np.testing.assert_array_equal(got, want)
        assert audit_metrics.roc_auc_score(y, s) == sk.roc_auc_score(y, s)
        for got, want in zip(audit_metrics.precision_recall_curve(y, s),
                             sk.precision_recall_curve(y, s)):
            np.testing.assert_array_equal(got, want)
        for t in (0.0, 0.5, 1.1):
            p = (s >= t).astype(int)
            assert audit_metrics.f1_score(y, p, zero_division=0) == \
                sk.f1_score(y, p, zero_division=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_audit_metrics_equal_jax(seed):
    r = np.random.RandomState(seed)
    n = 20
    labels = list("ABCD")
    preds = [labels[i] for i in r.randint(0, 4, n)]
    truth = [labels[i] if r.rand() < 0.7 else preds[k] for k, i in enumerate(r.randint(0, 4, n))]
    decisions = [["accept", "reject", "abstain"][i] for i in r.randint(0, 3, n)]
    conf = np.round(r.rand(n), 2).tolist()
    scores = [c if d == "reject" else 1 - c if d == "accept" else 0.5
              for d, c in zip(decisions, conf)]
    args = (preds, truth, decisions, conf, scores)
    assert json.dumps(audit_metrics.compute_audit_metrics(*args)) == \
        json.dumps(jax_metrics.compute_audit_metrics(*args))
    same = ([preds[0]] * n, [preds[0]] * n, decisions, conf, scores)   # one class
    assert json.dumps(audit_metrics.compute_audit_metrics(*same)) == \
        json.dumps(jax_metrics.compute_audit_metrics(*same))


def test_parsers_and_prompts_equal_jax():
    for text in SCRIPT + ["", "accept", '{"decision": "reject", "confidence": 0.2, '
                          '"cited_neighbors": [3], "rationale": "x"} tail {"a": 1}']:
        assert parsers.parse_audit_output(text) == jax_parsers.parse_audit_output(text)
        assert parsers.extract_json_payload(text) == jax_parsers.extract_json_payload(text)
    names = [n for n in dir(jax_prompts) if not n.startswith("_")]
    for name in names:
        want = getattr(jax_prompts, name)
        got = getattr(prompts, name)
        if isinstance(want, str):
            assert got == want, name
        elif callable(want) and name.startswith("get_"):
            assert got() == want(), name
    assert prompts.split_audit_prompt(prompts.get_vlm_audit_prompt(True)) == \
        jax_prompts.split_audit_prompt(jax_prompts.get_vlm_audit_prompt(True))


@pytest.fixture()
def cv_experiment(tmp_path):
    """A manifest of 8 patients with PNG slices and the port's CV fold
    files for it (fake encoders, 2 folds)."""
    records = []
    for p in range(8):
        slices = []
        for s in range(3):
            path = tmp_path / f"p{p}_s{s}.png"
            Image.fromarray(np.full((16, 16, 3), 20 * p + 5 * s, np.uint8)).save(path)
            slices.append(str(path))
        records.append({"patient_id": f"P{p}", "label": "AB"[p % 2], "slices": slices,
                        "meta": {"age": str(30 + p), "sex": "MF"[p % 2], "fever": "yes"}})
    manifest = tmp_path / "manifest.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in records), encoding="utf-8")
    from emr2a_tpu_torch.analysis.run_cv_experiments import main as cv_main
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cv_main(["--manifest_path", str(manifest), "--output_dir", str(tmp_path / "cv"),
                 "--image_encoder", "fake", "--text_encoder", "fake", "--experiment_id",
                 "x", "--cv_folds", "2", "--pca_dim", "4", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return tmp_path / "cv" / "exp_x", manifest


@pytest.mark.parametrize("conservative", [False, True])
def test_step4_artifacts_equal_jax(tmp_path, cv_experiment, conservative):
    exp_dir, manifest = cv_experiment
    jax_run_pipeline(exp_dir, manifest, tmp_path / "jax", max_samples=6,
                     backend=JaxFakeBackend(script=SCRIPT), conservative=conservative)
    backend = FakeVLMBackend(script=SCRIPT)
    step4.run_vlm_audit_pipeline(exp_dir, manifest, tmp_path / "port", max_samples=6,
                                 backend=backend, conservative=conservative)
    for name in ("vlm_audit_summary.json", "vlm_audit_details.jsonl"):
        assert (tmp_path / "port" / name).read_text(encoding="utf-8") == \
            (tmp_path / "jax" / name).read_text(encoding="utf-8"), name
    assert len(backend.calls) == 6 and backend.calls[0]["system"]
    assert backend.calls[0]["n_images"] >= 3


def test_step4_cli_with_the_fake_backend(tmp_path, cv_experiment):
    exp_dir, manifest = cv_experiment
    step4.main(["--exp_dir", str(exp_dir), "--manifest_path", str(manifest),
                "--output_dir", str(tmp_path / "out"), "--model_path", "fake",
                "--device", "cpu", "--max_samples", "3"])
    summary = json.loads((tmp_path / "out" / "vlm_audit_summary.json").read_text())
    assert summary["audit_summary"]["accept_count"] == 3
    assert len((tmp_path / "out" / "vlm_audit_details.jsonl").read_text().splitlines()) == 3


def _tiny_backend(precision):
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    from emr2a_tpu_torch.models import qwen3_vl as q
    cfg = q.Qwen3VLConfig(
        vision=q.QwenVisionConfig(depth=2, hidden_size=32, intermediate_size=64,
                                  num_heads=2, patch_size=4, out_hidden_size=48,
                                  num_position_embeddings=64, deepstack_visual_indexes=(0,)),
        text=q.QwenTextConfig(vocab_size=151936, hidden_size=48, num_layers=2, num_heads=4,
                              num_kv_heads=2, head_dim=12, intermediate_size=96,
                              mrope_section=(2, 2, 2), tie_word_embeddings=False))
    state = q.random_state(cfg, seed=0, device="cpu")
    return QwenVLBackend(config=cfg, params=state, tokenizer=WordTokenizer(),
                         image_processor=make_image_processor(cfg.vision, min_pixels=16,
                                                              max_pixels=16384),
                         precision=precision, prompt_bucket=32)


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
def test_qwen_backend_generates_on_the_cpu(precision):
    from emr2a_tpu_torch.models.layers import Int4Dense, Int8Dense
    backend = _tiny_backend(precision)
    kind = {"bf16": torch.nn.Module, "int8": Int8Dense, "int4": Int4Dense}[precision]
    assert isinstance(backend.model.language_model.layers[1].up_proj, kind)
    images = [np.full((16, 16, 3), 30 * i, np.uint8) for i in range(3)]
    ids, patches, grids = backend._prepare(images, "Is the label right?", "be brief")
    assert grids == [(1, 4, 4)] * 3 and patches.shape == (48, 3 * 2 * 16)
    assert ids.count(backend.config.image_token_id) == 3 * 4
    text = backend.generate(images, "Is the label right?", system="be brief",
                            max_new_tokens=5)
    assert isinstance(text, str) and len(text.split()) <= 5
    # batched and continuous serving: each request's text is its own
    # generate's (held against JAX in tests/test_torch_judge_serving.py)
    requests = [{"images": images, "prompt": "Is the label right?", "system": "be brief"},
                {"images": images[:1], "prompt": "x"}]
    alone = [backend.generate(r["images"], r["prompt"], system=r.get("system"),
                              max_new_tokens=5) for r in requests]
    assert alone[0] == text
    assert backend.generate_batch(requests, max_new_tokens=5) == alone
    assert backend.generate_stream(requests, max_new_tokens=5, n_slots=2) == alone


def test_divergences_raise_instead_of_abstaining(tmp_path):
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend
    with pytest.raises(FileNotFoundError):
        load_backend(str(tmp_path / "no_such_checkpoint"), device="cpu")
    assert isinstance(load_backend("fake:x"), FakeVLMBackend)
    # tp is ported (tests/test_torch_serving_tp.py); a tp that does not
    # divide the visible devices raises JAX's ValueError
    saved = port_mesh._default_mesh
    try:
        force_cpu_devices(8)
        with pytest.raises(ValueError, match="tp=3 does not divide the 8-device slice"):
            QwenVLBackend(config=_tiny_backend("bf16").config, params={}, tp=3)
    finally:
        port_mesh.set_default_mesh(saved)
    # int4_awq is ported: K7's layers on folded weights (held against JAX's
    # audit in tests/test_torch_awq_backend.py)
    from emr2a_tpu_torch.models.layers import Int4Dense
    awq = _tiny_backend("int4_awq")
    assert isinstance(awq.model.language_model.layers[1].down_proj, Int4Dense)
    assert isinstance(awq.generate([np.zeros((16, 16, 3), np.uint8)], "x", max_new_tokens=3),
                      str)
    img = tmp_path / "q.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(img)
    evidence = {"query_images": [str(img)], "query_text": "q", "neighbors": []}

    def broken(images, prompt):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")
    module = VLMAuditModule(backend=FakeVLMBackend(fn=broken))
    with pytest.raises(RuntimeError, match="CUDA"):
        module.query_vlm_audit(evidence, "A")
    # batched and continuous audits (ported) raise on a failed generation
    # too, where JAX's retry smaller batches and then abstain
    from emr2a_tpu.judge.audit import VLMAuditModule as JaxAudit
    record = {"patient_id": "q", "label": "A", "slices": [str(img)], "meta": {}}
    args = (["A"], [[0.9]], [["A"]], [record], [[]], [record], tmp_path)
    for mode in (dict(vlm_batch_size=4), dict(serving="continuous")):
        with pytest.raises(RuntimeError, match="CUDA"):
            module.audit_batch(*args, **mode)
        jax_out = JaxAudit(backend=JaxFakeBackend(fn=broken)).audit_batch(*args, **mode)
        assert jax_out["abstain_count"] == 1
        want = JaxAudit(backend=JaxFakeBackend()).audit_batch(*args, **mode)
        assert VLMAuditModule(backend=FakeVLMBackend()).audit_batch(*args, **mode) == want
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    module = VLMAuditModule(backend=FakeVLMBackend())
    assert module.query_vlm_audit({**evidence, "query_images": [str(bad)]}, "A") is None
    assert module.query_vlm_audit(evidence, "A")["decision"] == "accept"
