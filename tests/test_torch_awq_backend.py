"""The judge's int4_awq precision and speculative draft above the models, on
the CPU against the JAX package: both packages' ``QwenVLBackend`` over the
tiny random-init HF Qwen3-VL of ``tests/test_qwen3_vl_parity.py`` (one
state dict, f32), the JAX suite's ``ToyTokenizer``, and for the draft an
independent flax init (seed 11, JAX's ``test_speculative_backend_matches_
plain`` draft) converted into the port.

- ``precision="int4_awq"``: K7's layers on folded weights, with JAX's
  alphas and codes (calibrated on the same ids: JAX's calibration scan
  also tokenizes its prompts module's docstring, so JAX's
  ``_calib_ids_from_tokenizer`` is set to the port's here), gives JAX's
  texts and audit rows.
- ``draft_config`` / ``draft_params``: ``generate`` goes through the
  speculative generator and says what the plain backend says and what
  JAX's speculative backend says; ``generate_stream`` serves with the
  batcher's speculative chunk, JAX's texts; ``generate_batch`` ignores the
  draft.
- Step4's CLI (``--precision int4_awq`` in static batches; ``--draft_model``
  with ``--serving continuous``: JAX's one-case loop drops the token
  budget, ``judge/audit.py``) and the serve
  CLI (``--draft_model --spec_k``) with ``--device cpu``, each package's
  loader handing back the tiny backend of the flags it was given: the
  artifacts equal JAX's.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import emr2a_tpu.judge.audit as jax_audit_mod
import emr2a_tpu.judge.qwen_backend as jax_backend_mod
import emr2a_tpu.judge.serve as jax_serve
from emr2a_tpu.judge.audit import VLMAuditModule as JaxAudit
from emr2a_tpu.pipelines.step4_vlm_review.run import (
    run_vlm_audit_pipeline as jax_run_pipeline,
)
import emr2a_tpu_torch.judge.audit as audit_mod
from emr2a_tpu_torch.judge import serve
from emr2a_tpu_torch.judge.audit import VLMAuditModule
from emr2a_tpu_torch.judge.qwen_backend import _calib_ids_from_tokenizer
from emr2a_tpu_torch.pipelines.step4_vlm_review import run as step4
from tests.test_torch_judge import cv_experiment  # noqa: F401  (a fixture)
from tests.test_torch_judge_serving import _records

torch.set_num_threads(1)
pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def build():
    """A factory of (JAX backend, port backend) pairs by (precision,
    draft), built once each."""
    import jax
    import jax.numpy as jnp

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
    pcfg = pq.qwen3_vl_config_from_hf(cfg.to_dict())
    jparams = jq.convert_hf_qwen3_vl(sd, 3, 2)
    ids = jnp.concatenate([jnp.zeros((1, 2), jnp.int32),
                           jnp.full((1, 4), jcfg.image_token_id, jnp.int32),
                           jnp.zeros((1, 2), jnp.int32)], axis=1)
    jdraft = jq.Qwen3VLModel(jcfg).init(
        jax.random.PRNGKey(11), ids, jnp.zeros((3, 1, 8), jnp.int32),
        pixel_patches=jnp.zeros((16, 4 * 4 * 3 * 2), jnp.float32),
        grid_thw=((1, 4, 4),))["params"]
    pairs = {}

    def make(precision="bf16", draft=False):
        key = (precision, draft)
        if key not in pairs:
            jkw = dict(draft_config=jcfg, draft_params=jdraft, spec_k=2) if draft else {}
            pkw = dict(draft_config=pcfg, draft_params=params_from_jax(jdraft),
                       spec_k=2) if draft else {}
            pairs[key] = (
                JaxBackend(None, config=jcfg, params=jparams, tokenizer=ToyTokenizer(),
                           prompt_bucket=32, precision=precision,
                           image_processor=jax_processor(jcfg.vision, min_pixels=16,
                                                         max_pixels=16384), **jkw),
                QwenVLBackend(config=pcfg, params=params_from_jax(
                    pq.convert_hf_qwen3_vl(sd, 3, 2)), tokenizer=ToyTokenizer(),
                    prompt_bucket=32, device="cpu", precision=precision,
                    image_processor=make_image_processor(pcfg.vision, min_pixels=16,
                                                         max_pixels=16384), **pkw))
        return pairs[key]

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_backend_mod, "_calib_ids_from_tokenizer", _calib_ids_from_tokenizer)
    yield make
    mp.undo()


def test_int4_awq_backend_equals_jax(build, rng, tmp_path):
    from emr2a_tpu_torch.models.layers import Int4Dense
    jax_be, be = build("int4_awq")
    assert isinstance(be.model.language_model.layers[0].gate_proj, Int4Dense)
    img = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
    for prompt in ("describe", "what is this"):
        assert be.generate([img], prompt, max_new_tokens=8) == \
            jax_be.generate([img], prompt, max_new_tokens=8)
    # batched: JAX's one-case loop drops the token budget (judge/audit.py)
    kwargs = _records(tmp_path, rng)
    want = JaxAudit(backend=jax_be).audit_batch(output_dir=tmp_path / "j", vlm_batch_size=3,
                                                **kwargs)
    got = VLMAuditModule(backend=be).audit_batch(output_dir=tmp_path / "p", vlm_batch_size=3,
                                                 **kwargs)
    assert got == want and len(got["audit_results"]) == 3


def test_draft_backend_equals_jax_and_plain(build, rng):
    jax_be, be = build("bf16", draft=True)
    _, plain = build("bf16")
    assert be.spec_generator is not None and be.spec_generator.spec_k == 2
    img = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
    requests = [{"images": [img], "prompt": p} for p in ("describe", "findings please")]
    for r in requests:
        text = be.generate(r["images"], r["prompt"], max_new_tokens=8)
        assert text == plain.generate(r["images"], r["prompt"], max_new_tokens=8)
        assert text == jax_be.generate(r["images"], r["prompt"], max_new_tokens=8)
    stream = be.generate_stream(requests, max_new_tokens=8, n_slots=2)
    assert stream == jax_be.generate_stream(requests, max_new_tokens=8, n_slots=2)
    assert stream == plain.generate_stream(requests, max_new_tokens=8, n_slots=2)
    assert [k[3] for k in be._batchers] == [True]
    assert next(iter(be._batchers.values())).draft_model is be.spec_generator.dm
    assert be.generate_batch(requests, max_new_tokens=8) == \
        plain.generate_batch(requests, max_new_tokens=8)


def loaders(monkeypatch, build, seen):
    """Each package's step4 / serve loader replaced by one that records the
    flags it was handed and returns the tiny backend built for them."""
    def loader(index):
        def load(model_path, device="cuda", precision="bf16", kv_dtype="bf16",
                 draft_model_path=None, spec_k=4, prefill_chunk=None, tp=1):
            seen.append((index, model_path, device, precision, draft_model_path, spec_k))
            return build(precision, draft_model_path is not None)[index]
        return load
    for module, index in ((jax_audit_mod, 0), (jax_serve, 0), (audit_mod, 1), (serve, 1)):
        monkeypatch.setattr(module, "load_backend", loader(index))


@pytest.mark.parametrize("flags", [
    ["--precision", "int4_awq", "--vlm_batch_size", "2"],
    ["--draft_model", "draft", "--vlm_batch_size", "2", "--serving", "continuous"]])
def test_step4_cli_equals_jax(build, monkeypatch, tmp_path, cv_experiment, flags):  # noqa: F811
    exp_dir, manifest = cv_experiment
    seen = []
    loaders(monkeypatch, build, seen)
    precision = flags[1] if flags[0] == "--precision" else "bf16"
    draft = flags[1] if flags[0] == "--draft_model" else None
    jax_run_pipeline(exp_dir, manifest, tmp_path / "jax", max_samples=2, model_path="tiny",
                     device="cpu", precision=precision, draft_model_path=draft,
                     vlm_max_new_tokens=6, vlm_batch_size=2,
                     serving="continuous" if draft else "static")
    step4.main(["--exp_dir", str(exp_dir), "--manifest_path", str(manifest),
                "--output_dir", str(tmp_path / "port"), "--model_path", "tiny",
                "--device", "cpu", "--max_samples", "2", "--vlm_max_new_tokens", "6",
                *flags])
    assert [s[1:5] for s in seen] == [("tiny", "cpu", precision, draft)] * 2
    for name in ("vlm_audit_summary.json", "vlm_audit_details.jsonl"):
        assert (tmp_path / "port" / name).read_text(encoding="utf-8") == \
            (tmp_path / "jax" / name).read_text(encoding="utf-8"), name


def test_serve_cli_with_a_draft_equals_jax(build, monkeypatch, tmp_path, rng):
    seen = []
    loaders(monkeypatch, build, seen)
    img = tmp_path / "a.png"
    Image.fromarray((rng.rand(16, 16, 3) * 255).astype(np.uint8)).save(img)
    inp = tmp_path / "in.jsonl"
    inp.write_text("\n".join(json.dumps(r) for r in (
        {"id": "a", "prompt": "describe", "images": [str(img)]},
        {"id": "b", "prompt": "findings please", "images": [str(img)],
         "max_new_tokens": 4})) + "\n")
    out = {}
    for name, cli in (("jax", jax_serve.main), ("port", serve.main)):
        res = tmp_path / f"{name}.jsonl"
        cli(["--model_path", "tiny", "--device", "cpu", "--input", str(inp), "--output",
             str(res), "--draft_model", "draft", "--spec_k", "2", "--n_slots", "2",
             "--max_new_tokens", "6"])
        out[name] = [{k: v for k, v in json.loads(line).items() if k != "wave_s"}
                     for line in res.read_text().splitlines()]
    assert out["port"] == out["jax"] and all(r["ok"] for r in out["port"])
    assert [s[3:] for s in seen] == [("bf16", "draft", 2)] * 2
