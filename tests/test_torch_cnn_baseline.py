"""The port's CNN baseline (``emr2a_tpu_torch/baselines/cnn``) against the
JAX package's (``emr2a_tpu/baselines/cnn``) on the same numpy-seeded
inputs, on the CPU:

- the data helpers give JAX's arrays byte for byte;
- 3 train steps of both models from JAX's initial variables (carried
  across by ``resnet_from_jax``; Adam with coupled weight decay on both
  sides). The first gradients agree to about 3e-5 relative (f32
  rounding), but Adam's first steps move each weight by about lr = 1e-4
  whatever its gradient's size, so an element whose gradient is at
  rounding level (1e-9) can step the other way, 2 lr from JAX's, and
  such flips compound at a batch of 4 (measured at step 3, multimodal:
  the loss 1.2e-3 relative, 7e-4 of the elements beyond half a step, the
  largest difference 3.5 lr). So, after the first step: the loss within
  rtol 1e-5, every parameter within 2.5 lr and at most 1e-4 of the
  elements beyond 1e-6; after the third: the losses within rtol 5e-3,
  every parameter within 5 lr, at most 5e-3 of the elements beyond half
  a step; the running statistics within atol 1e-5 after the first and
  5e-3 after the third. A gradient that differed beyond rounding would
  move far more elements by a step;
- the fold metrics equal sklearn's (JAX's ``evaluate_fold``) exactly;
- ``main`` end to end (32², K = 2, 2 folds, 1 epoch, both models,
  ``--pretrained`` on a torchvision-layout checkpoint) writes JAX's
  ``results.json`` keys and folds (the same test patients per class),
  and a missing ``--pretrained_path`` raises ``SystemExit`` as in JAX;
- ``compute_cnn_metrics``' report string equals JAX's.

JAX's train step compiles once per model type (about 13 s each): the
steps are kept in ``_JAX_STEPS`` and handed to JAX's ``main`` too.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emr2a_tpu.baselines.cnn import compute_cnn_metrics as jax_metrics
from emr2a_tpu.baselines.cnn import train_cnn_baseline as jax_cnn
from emr2a_tpu.models.resnet import ImageOnlyModel as JaxImageOnly
from emr2a_tpu.models.resnet import MultimodalModel as JaxMultimodal
from emr2a_tpu_torch.baselines.cnn import compute_cnn_metrics as metrics
from emr2a_tpu_torch.baselines.cnn import train_cnn_baseline as cnn
from emr2a_tpu_torch.data.manifest import save_manifest
from emr2a_tpu_torch.models.convert import resnet_from_jax
from emr2a_tpu_torch.tools.torchvision_resnet import torchvision_resnet18

LR, WD, BATCH, K, SIZE, CLASSES = 1e-4, 1e-5, 4, 2, 32, 2
_JAX_STEPS = {}


def _jax_steps(use_clinical: bool):
    """JAX's (train_step, eval_step) for a model type, built once."""
    if use_clinical not in _JAX_STEPS:
        model = (JaxMultimodal if use_clinical else JaxImageOnly)(num_classes=CLASSES)
        opt = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))
        _JAX_STEPS[use_clinical] = (model, opt, jax_cnn.make_steps(model, opt, use_clinical))
    return _JAX_STEPS[use_clinical]


def _cohort(tmp_path, rng, n=8):
    from PIL import Image
    records = []
    for i in range(n):
        pdir = tmp_path / "imgs" / f"p{i}"
        pdir.mkdir(parents=True)
        slices = []
        for s in range(3):
            p = pdir / f"s{s}.png"
            Image.fromarray((rng.rand(40, 48, 3) * 255).astype(np.uint8)).save(p)
            slices.append(str(p))
        records.append({"patient_id": f"p{i}", "label": ["PJP", "Normal"][i % 2],
                        "slices": slices,
                        "meta": {"sex": "男女"[i % 2], "age": str(30 + 3 * i),
                                 "fever": "有" if i % 3 else "无"}})
    path = tmp_path / "manifest.jsonl"
    save_manifest(records, path)
    return records, path


def test_data_helpers_byte_equal(tmp_path, rng):
    records, _ = _cohort(tmp_path, rng)
    for n, k in ((8, 4), (2, 4), (5, 3), (1, 1)):
        assert cnn.sample_k_slices(list(range(n)), k) == jax_cnn.sample_k_slices(
            list(range(n)), k)
    for meta in ({"sex": "男", "age": "42", "fever": "有"}, {"sex": "女", "fever": "无"}, {}):
        a, b = cnn.encode_clinical(meta), jax_cnn.encode_clinical(meta)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for k, size in ((2, 32), (4, 24)):
        a = cnn.load_patient_images(records[0], k, size)
        b = jax_cnn.load_patient_images(records[0], k, size)
        assert a.dtype == b.dtype == np.float32 and a.shape == (k, size, size, 3)
        assert a.tobytes() == b.tobytes()
    rows = np.stack([cnn.encode_clinical(r["meta"]) for r in records])
    scalers = cnn.ClinicalScaler().fit(rows), jax_cnn.ClinicalScaler().fit(rows)
    label_to_idx = {"Normal": 0, "PJP": 1}
    ours, theirs = (mod.build_dataset(records[:5], K, label_to_idx, sc, image_size=SIZE)
                    for mod, sc in zip((cnn, jax_cnn), scalers))
    assert ours["patient_ids"] == theirs["patient_ids"]
    for key in ("images", "clinical", "labels"):
        assert ours[key].dtype == theirs[key].dtype, key
        assert ours[key].tobytes() == theirs[key].tobytes(), key


@pytest.mark.parametrize("model_type", ["image_only", "multimodal"])
def test_three_train_steps_match_jax(model_type, rng):
    use_clinical = model_type == "multimodal"
    jmodel, jopt, (j_train, _) = _jax_steps(use_clinical)
    shapes = [jnp.zeros((1, K, SIZE, SIZE, 3))] + ([jnp.zeros((1, 3))] if use_clinical else [])
    variables = jax.tree_util.tree_map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(0), *shapes, train=False)))
    model = cnn.build_model(model_type, CLASSES, "cpu")
    model.load_state_dict(resnet_from_jax(variables))
    opt = torch.optim.Adam(model.parameters(), lr=LR, weight_decay=WD)
    train_step, _ = cnn.make_steps(model, opt, use_clinical)

    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jstate = jopt.init(jvars["params"])
    for step, (loss_rtol, step_mult, far, far_frac, stats_atol) in enumerate(
            ((1e-5, 2.5, 1e-6, 1e-4, 1e-5), (5e-3, None, None, None, None),
             (5e-3, 5, LR / 2, 5e-3, 5e-3))):
        images = rng.randn(BATCH, K, SIZE, SIZE, 3).astype(np.float32)
        clinical = rng.randn(BATCH, 3).astype(np.float32)
        labels = np.asarray([0, 1, 1, 0], np.int32)
        jvars, jstate, jloss, jacc = j_train(jvars, jstate, images, clinical, labels)
        loss, acc = train_step(images, clinical, labels)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=loss_rtol,
                                   err_msg=str(step))
        if step_mult is None:
            continue
        want = resnet_from_jax(jax.tree_util.tree_map(np.asarray, jvars))
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        diffs = []
        for name in want:
            d = (got[name] - want[name]).abs()
            if "running" in name:
                assert float(d.max()) <= stats_atol, (step, name, float(d.max()))
            else:
                assert float(d.max()) <= step_mult * LR, (step, name, float(d.max()))
                diffs.append(d.reshape(-1).numpy())
        frac = float((np.concatenate(diffs) > far).mean())
        assert frac <= far_frac, (step, frac)


@pytest.mark.parametrize("seed", range(4))
def test_fold_metrics_equal_sklearn(seed):
    from sklearn.metrics import confusion_matrix, precision_recall_fscore_support
    r = np.random.RandomState(seed)
    n = 5 + 7 * seed
    labels = r.randint(0, 4, n).tolist()
    preds = r.randint(0 if seed % 2 else 1, 3, n).tolist()     # classes missing
    assert cnn.precision_recall_fscore_macro(labels, preds) == precision_recall_fscore_support(
        labels, preds, average="macro", zero_division=0)[:3]
    cm = confusion_matrix(labels, preds, labels=list(range(4)))
    assert np.array_equal(cnn.confusion_matrix_array(labels, preds, list(range(4))), cm)

    data = {"images": np.zeros((n, 1)), "clinical": np.zeros((n, 1)),
            "labels": np.asarray(labels, np.int32)}
    scripted = iter(np.asarray(preds).reshape(-1))

    def eval_step(*args):            # JAX's takes the variables first
        batch = len(args[-1])
        return 0.25 * batch, torch.tensor([next(scripted) for _ in range(batch)])

    ours = cnn.evaluate_fold(eval_step, data, 3, 4)
    scripted = iter(np.asarray(preds).reshape(-1))
    theirs = jax_cnn.evaluate_fold(None, eval_step, data, 3, 4)
    assert ours[:5] == theirs[:5] and ours[6:] == theirs[6:]
    assert np.array_equal(ours[5], theirs[5])


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_keys(v) for v in obj]
    return type(obj).__name__


def test_main_end_to_end_against_jax(tmp_path, rng, monkeypatch):
    _, manifest = _cohort(tmp_path, rng)
    ckpt = tmp_path / "resnet18.pth"
    torch.save(torchvision_resnet18(seed=0).state_dict(), ckpt)
    monkeypatch.setattr(jax_cnn, "make_steps",
                        lambda model, optimizer, use_clinical: _jax_steps(use_clinical)[2])
    for model_type in ("image_only", "multimodal"):
        args = ["--manifest_path", str(manifest), "--model_type", model_type,
                "--pretrained", "--pretrained_path", str(ckpt), "--cv_folds", "2",
                "--epochs", "1", "--k_slices", str(K), "--image_size", str(SIZE),
                "--batch_size", str(BATCH), "--lr", str(LR), "--weight_decay", str(WD)]
        cnn.main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
        jax_cnn.main(args + ["--output_dir", str(tmp_path / "jax")])
        ours, theirs = (json.loads((tmp_path / side / f"exp_{model_type}" / "results.json")
                                   .read_text()) for side in ("port", "jax"))
        assert _keys(ours) == _keys(theirs)
        assert len(ours["fold_results"]) == 2 and ours["model_type"] == model_type
        for a, b in zip(ours["fold_results"], theirs["fold_results"]):
            # the same test patients per class in each fold (the folds' split)
            assert np.array_equal(np.sum(a["confusion_matrix"], axis=1),
                                  np.sum(b["confusion_matrix"], axis=1))
            assert np.isfinite(a["loss"]) and 0 <= a["accuracy"] <= 100
    for main in (cnn.main, jax_cnn.main):
        with pytest.raises(SystemExit, match="pretrained_path"):
            main(["--manifest_path", str(manifest), "--output_dir", str(tmp_path / "o2"),
                  "--pretrained"])


def test_compute_cnn_metrics_report_equals_jax(tmp_path, capsys, rng):
    cms = [rng.randint(0, 6, (4, 4)) for _ in range(3)]
    cms.append(np.zeros((4, 4), np.int64))
    ours = metrics.format_report(metrics.compute_per_class_metrics(cms))
    assert ours == jax_metrics.format_report(jax_metrics.compute_per_class_metrics(cms))
    path = tmp_path / "results.json"
    path.write_text(json.dumps({"fold_results": [{"confusion_matrix": c.tolist()}
                                                 for c in cms]}))
    metrics.main(["--results_path", str(path)])
    printed = capsys.readouterr().out
    jax_metrics.main(["--results_path", str(path)])
    assert printed == capsys.readouterr().out and "| Bacterial" in printed
