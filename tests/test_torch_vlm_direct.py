"""The port's VLM direct-judging baseline
(``emr2a_tpu_torch/baselines/vlm_direct``) against the JAX package's, on
the CPU with the canned-output backends:

- the VLM cases of JAX's ``tests/test_baselines.py`` (parser, end to end,
  continuous against sequential, agreement, metrics), repeated on the
  port;
- JAX's and the port's ``main``, each with its own package's
  ``FakeVLMBackend`` on the same script, sequential, continuous and with
  the fold protocol: byte-equal ``vlm_direct_judging_results.json`` and
  ``summary.json``;
- ``evaluate_predictions`` equal to JAX's (sklearn) on random labels;
- the recorded divergence: a backend whose ``generate`` or
  ``generate_stream`` raises makes the port raise (JAX logs and abstains);
  a patient with an undecodable slice, or with every slice missing,
  abstains in both, and a missing slice is skipped in both.
"""

import json

import numpy as np
import pytest

from emr2a_tpu.baselines.vlm_direct import run_vlm_direct_judging as jax_vlm
from emr2a_tpu.judge.backends import FakeVLMBackend as JaxFakeBackend
from emr2a_tpu_torch.baselines.vlm_direct import run_vlm_direct_judging as vlm
from emr2a_tpu_torch.baselines.vlm_direct.run_vlm_direct_judging import (
    VLMDirectJudgingBaseline,
    calculate_agreement,
    evaluate_predictions,
)
from emr2a_tpu_torch.judge.backends import FakeVLMBackend

SCRIPT = ['{"pred_label": "PJP", "confidence": 0.9, "rationale": "x"}',
          '{"pred_label": "Normal", "confidence": 0.7, "rationale": "y"}',
          "thinking... the findings are consistent with viral infection",
          '{"pred_label": "Banana"}',
          '<think>hmm</think>{"pred_label": "Bacterial", "confidence": 7}']


def _make_cohort(tmp_path, rng, n=8):
    from PIL import Image
    from emr2a_tpu_torch.data.manifest import save_manifest
    records = []
    for i in range(n):
        pid = f"p{i}"
        pdir = tmp_path / pid
        pdir.mkdir()
        slices = []
        for s in range(4):
            p = pdir / f"{s}.png"
            Image.fromarray((rng.rand(8, 8, 3) * 255).astype(np.uint8)).save(p)
            slices.append(str(p))
        records.append({"patient_id": pid,
                        "label": ["PJP", "Bacterial", "Viral", "Normal"][i % 4],
                        "slices": slices,
                        "meta": {"sex": "男", "age": str(40 + i), "fever": "有",
                                 "symptom": "咳嗽"}})
    mpath = tmp_path / "manifest.jsonl"
    save_manifest(records, mpath)
    return mpath


def test_vlm_direct_parser():
    b = VLMDirectJudgingBaseline(backend=FakeVLMBackend())
    out = b._parse_vlm_output(
        '{"pred_label": "PJP", "confidence": 0.8, "rationale": "GGO"}')
    assert out["pred_label"] == "PJP"
    out = b._parse_vlm_output(
        "thinking... the findings are consistent with bacterial infection "
        "</think> oops no json")
    assert out["pred_label"] == "Bacterial" and out["confidence"] == 0.6
    assert b._parse_vlm_output('{"pred_label": "Banana"}') is None
    jb = jax_vlm.VLMDirectJudgingBaseline(backend=JaxFakeBackend())
    for text in SCRIPT:
        assert b._parse_vlm_output(text) == jb._parse_vlm_output(text)


def test_vlm_direct_end_to_end(tmp_path, rng):
    mpath = _make_cohort(tmp_path, rng)
    backend = FakeVLMBackend(script=SCRIPT[:2])
    out_dir = tmp_path / "out"
    vlm.main(["--manifest", str(mpath), "--output_dir", str(out_dir),
              "--temperatures", "0.0", "0.5", "--device", "cpu"], backend=backend)
    results = json.loads((out_dir / "vlm_direct_judging_results.json").read_text())
    fold = results["folds"]["all_patients"]
    assert len(fold["predictions"]["temp_0.0"]) == 8
    assert "agreement" in fold
    summary = json.loads((out_dir / "summary.json").read_text())
    assert "temp_0.0" in summary["average_metrics"]
    assert "agreement" in summary["average_metrics"]
    assert all(c["n_images"] == 4 for c in backend.calls)


def test_vlm_direct_continuous_matches_sequential(tmp_path, rng):
    mpath = _make_cohort(tmp_path, rng)
    outs, backends = {}, {}
    for mode in ("sequential", "continuous"):
        backend = FakeVLMBackend(script=list(SCRIPT[:3]))
        out_dir = tmp_path / f"out_{mode}"
        vlm.main(["--manifest", str(mpath), "--output_dir", str(out_dir),
                  "--temperatures", "0.0", "0.7", "--serving", mode, "--n_slots", "4",
                  "--device", "cpu"], backend=backend)
        outs[mode] = json.loads((out_dir / "vlm_direct_judging_results.json").read_text())
        backends[mode] = backend
    seq = outs["sequential"]["folds"]["all_patients"]
    con = outs["continuous"]["folds"]["all_patients"]
    for temp_key in ("temp_0.0", "temp_0.7"):
        assert seq["predictions"][temp_key] == con["predictions"][temp_key]
        assert seq["metrics"][temp_key] == con["metrics"][temp_key]
    assert seq["agreement"] == con["agreement"]
    stream = backends["continuous"].stream_calls
    assert len(stream) == 1
    assert stream[0]["n"] == 16 and stream[0]["n_slots"] == 4
    assert stream[0]["temperatures"] == [0.0] * 8 + [0.7] * 8
    assert not getattr(backends["sequential"], "stream_calls", [])


def test_agreement_metric():
    run1 = [{"patient_id": "a", "true_label": "PJP", "pred_label": "PJP"},
            {"patient_id": "b", "true_label": "Viral", "pred_label": "Viral"}]
    run2 = [{"patient_id": "a", "true_label": "PJP", "pred_label": "PJP"},
            {"patient_id": "b", "true_label": "Viral", "pred_label": "Normal"}]
    out = calculate_agreement([run1, run2])
    assert out["overall_agreement"] == pytest.approx(0.75)
    assert out == jax_vlm.calculate_agreement([run1, run2])


@pytest.mark.parametrize("seed", range(5))
def test_evaluate_predictions_equals_jax(seed):
    r = np.random.RandomState(seed)
    labels = jax_vlm.VALID_LABELS
    n = 3 + 5 * seed
    preds = [{"true_label": labels[r.randint(4)],
              "pred_label": labels[r.randint(1 + seed % 4)] if r.rand() > 0.1 else None}
             for _ in range(n)]
    assert evaluate_predictions(preds) == jax_vlm.evaluate_predictions(preds)
    m = evaluate_predictions([{"pred_label": "PJP", "true_label": "PJP"},
                              {"pred_label": "Viral", "true_label": "Normal"}])
    assert m["accuracy"] == 0.5 and m["num_samples"] == 2
    assert set(m["per_class"]) == {"PJP", "Bacterial", "Viral", "Normal"}
    assert evaluate_predictions([]) == {} == jax_vlm.evaluate_predictions([])


def _write_fold_dir(tmp_path, test_ids):
    exp = tmp_path / "exp"
    for fold in (1, 2):
        (exp / f"fold_{fold}").mkdir(parents=True)
        (exp / f"fold_{fold}" / "metrics.json").write_text(json.dumps(
            {"test_patient_ids": test_ids[fold - 1]}))
    return exp


@pytest.mark.parametrize("mode", ["sequential", "continuous", "fold"])
def test_artifacts_byte_equal_to_jax(tmp_path, rng, mode):
    mpath = _make_cohort(tmp_path, rng)
    args = ["--manifest", str(mpath), "--temperatures", "0.0", "0.7", "--n_slots", "3",
            "--random_seed", "7"]
    if mode == "fold":
        exp = _write_fold_dir(tmp_path, [["p1", "p3", "p4", "p6"], ["p0", "p2"]])
        args += ["--fold", "0", "--experiment_dir", str(exp), "--n_samples_per_fold", "3"]
    else:
        args += ["--serving", mode, "--n_samples_per_fold", "6"]
    vlm.main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"],
             backend=FakeVLMBackend(script=list(SCRIPT)))
    jax_vlm.main(args + ["--output_dir", str(tmp_path / "jax")],
                 backend=JaxFakeBackend(script=list(SCRIPT)))
    for name in ("vlm_direct_judging_results.json", "summary.json"):
        ours = (tmp_path / "port" / name).read_bytes()
        assert ours == (tmp_path / "jax" / name).read_bytes(), name
    results = json.loads((tmp_path / "port" / "vlm_direct_judging_results.json").read_text())
    fold = next(iter(results["folds"].values()))
    assert len(fold["sampled_patient_ids"]) == (3 if mode == "fold" else 6)
    assert fold["metrics"]["temp_0.0"]      # some predictions parsed


class _Raising(FakeVLMBackend):
    def generate(self, *args, **kw):
        raise RuntimeError("kernel launch failed")

    def generate_stream(self, *args, **kw):
        raise RuntimeError("kernel launch failed")


@pytest.mark.parametrize("mode", ["sequential", "continuous"])
def test_failed_generation_raises(tmp_path, rng, mode):
    mpath = _make_cohort(tmp_path, rng, n=2)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        vlm.main(["--manifest", str(mpath), "--output_dir", str(tmp_path / "o"),
                  "--serving", mode, "--device", "cpu"], backend=_Raising())


def test_patient_without_readable_slice_abstains(tmp_path, rng):
    mpath = _make_cohort(tmp_path, rng, n=4)
    records = [json.loads(line) for line in mpath.read_text().splitlines()]
    records[0]["slices"][0] = str(tmp_path / "missing.png")   # one of four missing
    (tmp_path / records[1]["slices"][0]).write_bytes(b"not a png")  # one undecodable
    for path in records[2]["slices"]:
        (tmp_path / path).write_bytes(b"not a png")    # all undecodable
    records[3]["slices"] = [str(tmp_path / "missing.png")]
    backend = FakeVLMBackend(script=SCRIPT[:1])
    base = VLMDirectJudgingBaseline(backend=backend)
    jax_base = jax_vlm.VLMDirectJudgingBaseline(backend=JaxFakeBackend(script=SCRIPT[:1]))
    assert len(base.build_request(records[0])["images"]) == 3
    assert len(jax_base.build_request(records[0])["images"]) == 3
    assert all(base.build_request(r) is None for r in records[1:])
    for r in records[1:]:
        assert base.predict(r) is None and jax_base.predict(r) is None
    grid = base.predict_grid(records, [0.0], n_slots=2)
    jax_grid = jax_base.predict_grid(records, [0.0], n_slots=2)
    assert [p["patient_id"] for p in grid[0.0]] == ["p0"]
    assert [p["patient_id"] for p in jax_grid[0.0]] == ["p0"]
    assert backend.stream_calls[-1]["n"] == 1
