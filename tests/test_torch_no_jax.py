"""The port never loads JAX, nor any module of the JAX package, nor
sklearn, pandas, transformers or safetensors (the card's machine lacks the
last four): in a fresh interpreter, import every module of
``emr2a_tpu_torch``, run the step1 CLI on a raw CSV + folder tree, the
fake-encoder step2 CLI, the step3 CLI (``--device cpu``), the database CLI
(``build`` and ``query --cpu``), the CV runner (``--device cpu``, fake
encoders, ``--vlm_review`` with the fake judge), the step4 CLI on its fold files (``--model_path fake``,
``--device cpu``), the layer-breakdown tool (``--device cpu``, ``tune
--merge_batch``) and every encoder of the zoo at a small width (ViT, DINOv3
and CLIP in f32 and W8A8, Qwen3-VL's taps and text mean), the continuous
batcher on a tiny Qwen3-VL (greedy and sampled rows, and with a draft),
the speculative generator (greedy and sampled), AWQ's pipeline and the
int4_awq quantizer, the reasoning evaluator and the LLM factory, the
JSONL judge service with the fake backend, the CNN baseline's CLI
(``--device cpu``, both models, ``--pretrained_path`` on a
torchvision-layout checkpoint) and ``compute_cnn_metrics``, the VLM
direct-judging CLI (``--model_path fake --device cpu``, sequential and
continuous), the contrastive trainer (one step, save and restore), a
``trace_to`` capture and the Qwen3-VL bring-up on a tiny checkpoint
directory, then check that no module of jax, jaxlib, flax, optax,
sklearn, pandas, transformers, safetensors or ``emr2a_tpu`` was
imported."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

_PROGRAM = r"""
import importlib, os, pkgutil, sys
import emr2a_tpu_torch
names = [m.name for m in pkgutil.walk_packages(emr2a_tpu_torch.__path__,
                                               "emr2a_tpu_torch.")]
assert "emr2a_tpu_torch.judge.review" in names
assert {"emr2a_tpu_torch.models.serving", "emr2a_tpu_torch.models.cuda_graph",
        "emr2a_tpu_torch.judge.serve"} <= set(names)
assert {"emr2a_tpu_torch.models.speculative", "emr2a_tpu_torch.models.awq",
        "emr2a_tpu_torch.llms.qwen3_llm", "emr2a_tpu_torch.llms.openai_llm",
        "emr2a_tpu_torch.reasoning.evaluator"} <= set(names)
assert {"emr2a_tpu_torch.encoders.vit_encoder", "emr2a_tpu_torch.encoders.clip_encoder",
        "emr2a_tpu_torch.encoders.dino_encoder", "emr2a_tpu_torch.models.dinov3"} <= set(names)
assert {"emr2a_tpu_torch.utils.profiling", "emr2a_tpu_torch.models.resnet",
        "emr2a_tpu_torch.baselines.cnn.train_cnn_baseline",
        "emr2a_tpu_torch.baselines.cnn.compute_cnn_metrics",
        "emr2a_tpu_torch.baselines.vlm_direct.run_vlm_direct_judging",
        "emr2a_tpu_torch.training.clip_trainer"} <= set(names)
for name in names:
    importlib.import_module(name)
manifest, out, data_root = sys.argv[1], sys.argv[2], sys.argv[3]
from emr2a_tpu_torch.pipelines.step1_manifest.build_manifest import main as step1_main
step1_main(["--data_root", data_root, "--out_dir", out + "/step1"])
from emr2a_tpu_torch.pipelines.step2_embeddings.build_embeddings import main
main(["--manifest_path", manifest, "--encoder_type", "fake",
      "--device", "cpu", "--output_dir", out])
from emr2a_tpu_torch.pipelines.step3_retrieval.evaluate_retrieval import main as step3_main
step3_main(["--manifest_path", manifest, "--embeddings_path",
            out + "/embeddings.npz", "--output_dir", out + "/step3",
            "--test_size", "0.5", "--device", "cpu"])
from emr2a_tpu_torch.retrieval.database_cli import main as db_main
db_main(["build", "--embeddings_path", out + "/embeddings.npz",
         "--manifest_path", manifest, "--db", out + "/db.npz", "--dtype",
         "int8", "--cpu"])
db_main(["query", "--db", out + "/db.npz", "--queries_path",
         out + "/embeddings.npz", "--k", "2", "--dtype", "int8", "--cpu",
         "--output", out + "/hits.jsonl"])
from emr2a_tpu_torch.analysis.run_cv_experiments import main as cv_main
os.chdir(out)
cv_main(["--manifest_path", manifest, "--output_dir", out + "/cv",
         "--image_encoder", "fake", "--text_encoder", "fake",
         "--experiment_id", "nj", "--cv_folds", "2", "--pca_dim", "4",
         "--device", "cpu", "--vlm_review", "--vlm_model_path", "fake"])
from emr2a_tpu_torch.pipelines.step4_vlm_review.run import main as step4_main
step4_main(["--exp_dir", out + "/cv/exp_nj", "--manifest_path", manifest,
            "--output_dir", out + "/step4", "--model_path", "fake",
            "--device", "cpu", "--max_samples", "3"])
from emr2a_tpu_torch.tools.layer_breakdown import main as lb_main
lb_main(["--device", "cpu", "--what", "tune", "--merge_batch", "--batch", "1",
         "--iters", "1"])
import dataclasses
import numpy as np
from emr2a_tpu_torch.encoders import CLIPEncoder, DINOEncoder, Qwen3VLEncoder, ViTEncoder
from emr2a_tpu_torch.encoders.qwen3_vl_encoder import make_image_processor
from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.models.clip import CLIPConfig
from emr2a_tpu_torch.models.dinov3 import DINOv3Config
from emr2a_tpu_torch.models.text import CLIPTextConfig
from emr2a_tpu_torch.models.vit import CLIP_VIT_B16_VISION, TIMM_VIT_B16

class Tok:
    def __call__(self, texts, max_length=16, return_tensors="np", **kw):
        one = isinstance(texts, str)
        ids = np.full((1 if one else len(texts), max_length), 99, np.int64)
        ids[:, :3] = [98, 7, 99]
        return {"input_ids": ids[:, :5] if one else ids, "attention_mask": np.ones_like(ids)}

img = [np.full((40, 40, 3), 90, np.uint8)]
small = dict(patch_size=32, hidden_size=64, num_layers=1, num_heads=2, mlp_dim=128)
text = CLIPTextConfig(vocab_size=100, max_length=16, hidden_size=64, num_layers=1,
                      num_heads=2, mlp_dim=128, eos_token_id=99)
shapes = []
for fast in (False, "int8"):
    shapes.append(ViTEncoder(config=dataclasses.replace(TIMM_VIT_B16, **small), device="cpu",
                             fast=fast).encode_batch_images(img)[0].shape)
    shapes.append(DINOEncoder(config=DINOv3Config(hidden_size=64, num_layers=1, num_heads=2,
                                                  mlp_dim=128),
                              device="cpu", fast=fast).encode_batch_images(img)[0].shape)
    clip = CLIPEncoder.random_init(CLIPConfig(
        vision=dataclasses.replace(CLIP_VIT_B16_VISION, **small), text=text, projection_dim=32),
        tokenizer=Tok(), device="cpu", fast=fast)
    shapes += [clip.encode_batch_images(img)[0].shape, clip.encode_batch_texts(["a"])[0].shape]
qcfg = pq.Qwen3VLConfig(
    vision=pq.QwenVisionConfig(depth=2, hidden_size=32, intermediate_size=64, num_heads=2,
                               patch_size=4, out_hidden_size=48, num_position_embeddings=64,
                               deepstack_visual_indexes=(0,)),
    text=pq.QwenTextConfig(vocab_size=200, hidden_size=48, num_layers=1, num_heads=4,
                           num_kv_heads=2, head_dim=12, intermediate_size=96,
                           mrope_section=(2, 2, 2)))
qwen = Qwen3VLEncoder(config=qcfg, params=pq.random_state(qcfg, device="cpu"), device="cpu",
                      tokenizer=Tok(), image_processor=make_image_processor(
                          qcfg.vision, min_pixels=16, max_pixels=4096))
shapes += [qwen.encode_batch_images(img)[0].shape, qwen.encode_batch_texts(["a"])[0].shape]
print("ENCODERS", shapes)
from emr2a_tpu_torch.models.serving import ContinuousBatcher
srv = ContinuousBatcher(pq.Qwen3VLModel.from_params(qcfg, pq.random_state(qcfg, device="cpu")),
                        n_slots=2, prompt_bucket=8, max_new_tokens=4, eos_token_id=-1, chunk=2)
rows = srv.serve([{"input_ids": np.arange(2, 2 + n)[None]} for n in (3, 7, 5)]
                 + [{"input_ids": np.arange(3, 9)[None], "temperature": 0.8, "seed": 1}])
assert [r.shape for r in rows] == [(4,)] * 4, rows
model = srv.model
from emr2a_tpu_torch.models.speculative import SpeculativeGenerator
spec = SpeculativeGenerator(model, model, spec_k=2, eos_token_id=-1)
greedy = spec.generate(np.arange(2, 7)[None], max_new_tokens=5, prompt_bucket=8)
sampled = spec.generate(np.arange(2, 7)[None], max_new_tokens=5, prompt_bucket=8,
                        temperature=0.8, seed=3)
spec_rows = ContinuousBatcher(model, n_slots=2, prompt_bucket=8, max_new_tokens=4,
                              eos_token_id=-1, chunk=2, draft_model=model, spec_k=2).serve(
    [{"input_ids": np.arange(2, 2 + n)[None]} for n in (3, 7, 5)])
from emr2a_tpu_torch.judge.qwen_backend import quantize_decoder
from emr2a_tpu_torch.models.awq import awq_quantize_qwen_text_params
from emr2a_tpu_torch.models.convert import params_to_jax
awq_tree, report = awq_quantize_qwen_text_params(
    model, params_to_jax(model.state_dict()), np.arange(2, 34).reshape(2, 16),
    return_report=True)
awq_state = quantize_decoder(dict(model.state_dict()), "int4_awq", model=model, tokenizer=None)
print("SPECULATIVE", greedy.shape, sampled.shape, [r.shape for r in spec_rows],
      sorted(report), sum(k.endswith("kernel_p4") for k in awq_state))
from emr2a_tpu_torch.llms import FakeLLM, create_llm
from emr2a_tpu_torch.reasoning import ReasoningEvaluator
from emr2a_tpu_torch.judge.backends import FakeVLMBackend
diag = ReasoningEvaluator(FakeLLM()).diagnose({"sex": "F"})
stream = create_llm("qwen3", backend=FakeVLMBackend(script=["a", "b"])).generate_stream(
    ["p", "q"], n_slots=2)
print("REASONING", diag["diagnosis"], stream)
import json as _json
from emr2a_tpu_torch.judge.serve import main as serve_main
with open(out + "/requests.jsonl", "w") as f:
    f.write(_json.dumps({"id": "r1", "prompt": "x"}) + "\nnot json\n")
serve_main(["--model_path", "fake", "--device", "cpu", "--input", out + "/requests.jsonl",
            "--output", out + "/responses.jsonl"])
with open(out + "/responses.jsonl") as f:
    print("SERVED", [_json.loads(line)["ok"] for line in f])
import torch
from emr2a_tpu_torch.baselines.cnn.train_cnn_baseline import main as cnn_main
from emr2a_tpu_torch.baselines.cnn.compute_cnn_metrics import main as cnn_metrics_main
from emr2a_tpu_torch.tools.torchvision_resnet import torchvision_resnet18
torch.save(torchvision_resnet18().state_dict(), out + "/resnet18.pth")
for model_type in ("image_only", "multimodal"):
    cnn_main(["--manifest_path", manifest, "--output_dir", out + "/cnn", "--model_type",
              model_type, "--cv_folds", "2", "--epochs", "1", "--k_slices", "2",
              "--image_size", "16", "--batch_size", "2", "--device", "cpu",
              "--pretrained", "--pretrained_path", out + "/resnet18.pth"])
with open(out + "/cnn_results.json", "w") as f:     # compute_cnn_metrics' 4 classes
    _json.dump({"fold_results": [{"confusion_matrix": np.eye(4, dtype=int).tolist()}]}, f)
cnn_metrics_main(["--results_path", out + "/cnn_results.json"])
from emr2a_tpu_torch.baselines.vlm_direct.run_vlm_direct_judging import main as vlm_main
for mode in ("sequential", "continuous"):
    vlm_main(["--manifest", manifest, "--output_dir", out + "/vlm_" + mode, "--model_path",
              "fake", "--device", "cpu", "--temperatures", "0.0", "0.5", "--serving", mode])
from emr2a_tpu_torch.models.clip import CLIPConfig, CLIPImageTower, CLIPTextTower, init_tower
from emr2a_tpu_torch.training import ContrastiveTrainer
ccfg = CLIPConfig(vision=dataclasses.replace(CLIP_VIT_B16_VISION, image_size=32, **small),
                  text=text, projection_dim=16)
tgen = torch.Generator().manual_seed(0)
towers = init_tower(CLIPImageTower(ccfg), tgen), init_tower(CLIPTextTower(ccfg), tgen)
trainer = ContrastiveTrainer(*towers, learning_rate=1e-3)
tstate = trainer.init_state({"image": dict(towers[0].state_dict()),
                             "text": dict(towers[1].state_dict())})
tstate, tloss = trainer.make_train_step()(tstate, np.zeros((2, 32, 32, 3), np.float32),
                                          np.full((2, 16), 99), None)
trainer.save_state(tstate, out + "/train_state")
restored = trainer.restore_state(trainer.init_state(tstate.params), out + "/train_state")
from emr2a_tpu_torch.utils import StageTimer, trace_to
timer = StageTimer()
with trace_to(out + "/trace"), timer.stage("nj_stage"):
    torch.ones(4).sum()
from emr2a_tpu_torch.models.convert import bringup_qwen3_vl
from emr2a_tpu_torch.tools.qwen_checkpoint import write_checkpoint
from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer
bcfg = dataclasses.replace(qcfg, text=dataclasses.replace(qcfg.text, vocab_size=151936))
ckpt = write_checkpoint(out + "/qwen_ckpt", bcfg, pq.random_state(bcfg, device="cpu"))
bring = bringup_qwen3_vl(ckpt, max_new_tokens=2, tokenizer=WordTokenizer(), image_size=16,
                         device="cpu")
print("BASELINES", restored.step, bool(np.isfinite(float(tloss))), sorted(timer.summary()),
      bring["image_tap_dim"], bring["text_dim"])
loaded = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sklearn",
                           "pandas", "transformers", "safetensors",
                           "emr2a_tpu"))
print("MODULES", len(names), "LOADED", ",".join(loaded) or "-")
"""


def test_port_imports_no_jax(tmp_path):
    from PIL import Image
    records = []
    for p in range(4):
        img = tmp_path / f"s{p}.png"
        Image.fromarray(np.full((16, 16, 3), 40 * p + 10, np.uint8)).save(img)
        records.append({"patient_id": f"P{p}", "label": "AB"[p % 2],
                        "slices": [str(img)], "meta": {"age": str(30 + p)}})
    manifest = tmp_path / "manifest.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in records),
                        encoding="utf-8")
    data_root = tmp_path / "data"
    (data_root / "Case_csv").mkdir(parents=True)
    for label in ("Bacterial", "Viral", "PJP", "Normal"):
        (data_root / "Case_csv" / f"{label}.csv").write_text(
            f"name,sex\n{label}_0,M\n", encoding="utf-8")
        pdir = data_root / "CT_2D_image_core" / label / f"{label}_0"
        pdir.mkdir(parents=True)
        for s in (10, 2):
            Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(pdir / f"slice_{s}.png")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _PROGRAM, str(manifest), str(tmp_path / "out"),
         str(data_root)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    n_modules = int(last.split()[1])
    assert n_modules >= 30, last
    assert last.endswith("LOADED -"), last
    assert np.load(tmp_path / "out" / "embeddings.npz")["P1"].shape == (1, 64)
    hits = (tmp_path / "out" / "hits.jsonl").read_text().splitlines()
    assert len(hits) == 4
    assert (tmp_path / "out" / "cv" / "exp_nj" / "fold_2" / "metrics.json").exists()
    assert "SERVED [False, True]" in proc.stdout
    review = json.loads((tmp_path / "out" / "cv" / "exp_nj" / "vlm_review_summary.json")
                        .read_text())
    assert len(review["vlm_predictions"]) == 4
    assert (tmp_path / "out" / "cv" / "exp_nj" / "vlm_review" / "evidence_0").is_dir()
    details = (tmp_path / "out" / "step4" / "vlm_audit_details.jsonl").read_text()
    assert len(details.splitlines()) == 3
    assert (tmp_path / "out" / "step4" / "vlm_audit_summary.json").exists()
    step1 = (tmp_path / "out" / "step1" / "manifest.jsonl").read_text(encoding="utf-8")
    assert len(step1.splitlines()) == 4 and "slice_2.png" in step1
    step3 = json.loads((tmp_path / "out" / "step3" / "retrieval_results.json").read_text())
    assert "image_top1" in step3
    assert "merge=True" in proc.stdout
    assert ("ENCODERS [(64,), (64,), (32,), (32,), (64,), (64,), (32,), (32,), (32,), (48,)]"
            in proc.stdout), proc.stdout[-2000:]
    assert ("SPECULATIVE (1, 5) (1, 5) [(4,), (4,), (4,)] ['layer_0'] 7"
            in proc.stdout), proc.stdout[-2000:]
    assert "REASONING 正常 ['a', 'b']" in proc.stdout, proc.stdout[-2000:]
    assert "BASELINES 1 True ['nj_stage'] 32 48" in proc.stdout, proc.stdout[-2000:]
    assert "| Bacterial" in proc.stdout
    for model_type in ("image_only", "multimodal"):
        results = json.loads((tmp_path / "out" / "cnn" / f"exp_{model_type}" /
                              "results.json").read_text())
        assert len(results["fold_results"]) == 2
    for mode in ("sequential", "continuous"):
        vlm = json.loads((tmp_path / "out" / f"vlm_{mode}" / "summary.json").read_text())
        assert vlm["total_samples"] == 4 and vlm["temperatures"] == [0.0, 0.5]
    assert list((tmp_path / "out" / "trace").glob("*.pt.trace.json"))
