"""The port's CV evaluator and CV experiment runner against
``emr2a_tpu.eval.cv`` / ``emr2a_tpu.analysis.run_cv_experiments``, sklearn
and the reference fold algorithm, on the CPU.

Folds, labels, neighbour ids, confusion matrices and metrics must be
identical; scores within 1e-4 of JAX's: the port computes the fold math in
f64, the JAX package in f32, whose SVD of a small fold (19 x 64 here) with
close singular values moves a score by 1e-5 and more.
"""

import csv
import json
import logging
import sys
from collections import Counter

import numpy as np
import pytest
import torch
from sklearn.decomposition import PCA
from sklearn.model_selection import StratifiedKFold
from sklearn.preprocessing import StandardScaler

from emr2a_tpu.analysis import run_cv_experiments as jax_runner
from emr2a_tpu.eval.cv import CVRetrievalEvaluator as JaxEvaluator
from emr2a_tpu_torch.analysis import run_cv_experiments as port_runner
from emr2a_tpu_torch.data.manifest import save_manifest
from emr2a_tpu_torch.eval.cv import CVRetrievalEvaluator, stratified_kfold

torch.set_num_threads(1)

SCORES_ATOL = 1e-4


# -- the sklearn-free splitter ----------------------------------------------

def _label_sets():
    r = np.random.RandomState(3)
    return {
        "balanced4": [["A", "B", "C", "D"][i % 4] for i in range(40)],
        "imbalanced": list(r.permutation(["a"] * 13 + ["b"] * 7 + ["c"] * 5 + ["d"] * 20)),
        "zh": [["细菌性肺炎", "病毒性肺炎", "PJP肺炎", "正常"][i % 4] for i in range(33)],
        "binary": [["x", "y"][int(v)] for v in r.rand(50) < 0.3],
    }


@pytest.mark.parametrize("name", ["balanced4", "imbalanced", "zh", "binary"])
@pytest.mark.parametrize("seed", [0, 42, 7])
@pytest.mark.parametrize("n_splits", [3, 5])
def test_stratified_kfold_equals_sklearn(name, seed, n_splits):
    labels = _label_sets()[name]
    skf = StratifiedKFold(n_splits=n_splits, shuffle=True, random_state=seed)
    got = stratified_kfold(labels, n_splits, seed)
    want = list(skf.split(np.zeros(len(labels)), labels))
    assert len(got) == len(want)
    for (tr, te), (wtr, wte) in zip(got, want):
        np.testing.assert_array_equal(tr, wtr)
        np.testing.assert_array_equal(te, wte)


def test_stratified_kfold_small_classes_warn_and_errors_match_sklearn():
    labels = ["a"] * 2 + ["b"] * 9
    with pytest.warns(UserWarning, match="least populated"):
        got = stratified_kfold(labels, 3, 42)
    with pytest.warns(UserWarning):
        want = list(StratifiedKFold(3, shuffle=True, random_state=42).split(
            np.zeros(11), labels))
    for (tr, te), (wtr, wte) in zip(got, want):
        np.testing.assert_array_equal(te, wte)
    with pytest.raises(ValueError, match="number of members"):
        stratified_kfold(["a"] * 2 + ["b"] * 2, 3, 42)
    with pytest.raises(ValueError, match="greater than the number of samples"):
        stratified_kfold(["a", "b"], 3, 42)


def test_evaluator_split_uses_no_sklearn(monkeypatch):
    pids = [f"p{i}" for i in range(40)]
    labs = [["A", "B"][i % 2] for i in range(40)]
    want = JaxEvaluator(seed=42).stratified_split(pids, labs)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.model_selection", None)
    assert CVRetrievalEvaluator(seed=42, device="cpu").stratified_split(pids, labs) == want


# -- one fold against JAX and against the reference algorithm ---------------

def _fold_data(rng, n=60, dim_i=32, dim_t=24):
    labs = [["A", "B", "C", "D"][i % 4] for i in range(n)]
    centers = rng.randn(4, dim_i) * 1.5
    img = np.stack([centers[i % 4] + rng.randn(dim_i) for i in range(n)])
    txt = np.stack([rng.randn(dim_t) * 0.3 + np.eye(4)[i % 4].repeat(dim_t // 4)
                    for i in range(n)])
    return [f"p{i}" for i in range(n)], labs, img.astype(np.float32), txt.astype(np.float32)


def _assert_fold_equal(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "all_top_scores":
            np.testing.assert_allclose(np.asarray(got[key]), np.asarray(value),
                                       rtol=0, atol=SCORES_ATOL)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("fusion", ["concat", "image_only", "text_only", "late"])
def test_evaluate_fold_matches_jax(rng, fusion):
    pids, labs, img, txt = _fold_data(rng)
    (tr, te), = stratified_kfold(labs, 5, 42)[:1]
    args = (img[tr], txt[tr], img[te], txt[te], [labs[i] for i in tr],
            [labs[i] for i in te], [pids[i] for i in te])
    kw = dict(fusion=fusion, w_text=0.3, train_ids=[pids[i] for i in tr])
    got = CVRetrievalEvaluator(pca_dim=16, top_k=5, device="cpu").evaluate_fold(*args, **kw)
    want = JaxEvaluator(pca_dim=16, top_k=5).evaluate_fold(*args, **kw)
    _assert_fold_equal(got, want)


def _golden_fold_metrics(train_img, train_txt, test_img, test_txt,
                         train_labels, test_labels, pca_dim, top_k):
    """The reference's fold algorithm, literally, with sklearn and numpy
    (``tests/test_reference_parity.py``)."""
    def process(train, test):
        sc = StandardScaler()
        tr, te = sc.fit_transform(train), sc.transform(test)
        n_comp = min(pca_dim, tr.shape[0] - 1, tr.shape[1])
        if n_comp > 0:
            p = PCA(n_components=n_comp)
            tr, te = p.fit_transform(tr), p.transform(te)
        tr = tr / (np.linalg.norm(tr, axis=1, keepdims=True) + 1e-8)
        te = te / (np.linalg.norm(te, axis=1, keepdims=True) + 1e-8)
        return tr, te

    tr_i, te_i = process(train_img, test_img)
    tr_t, te_t = process(train_txt, test_txt)

    def concat(a, b):
        f = np.concatenate([a, b], axis=1)
        return f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-8)

    db, queries = concat(tr_i, tr_t), concat(te_i, te_t)
    top1, vote, weighted, all_top_labels = [], 0, 0, []
    for i, q in enumerate(queries):
        sims = db @ q
        idx = np.argsort(sims)[-top_k:][::-1]
        labels = [train_labels[j] for j in idx]
        scores = [float(sims[j]) for j in idx]
        all_top_labels.append(labels)
        top1.append(1 if test_labels[i] in labels[:1] else 0)
        vote += Counter(labels).most_common(1)[0][0] == test_labels[i]
        acc = {}
        for l, s in zip(labels, scores):
            acc[l] = acc.get(l, 0.0) + s
        weighted += max(acc.items(), key=lambda x: x[1])[0] == test_labels[i]
    return {"top1": float(np.mean(top1)), "vote_acc": vote / len(test_labels),
            "weighted_vote_acc": weighted / len(test_labels),
            "all_top_labels": all_top_labels}


@pytest.mark.parametrize("pca_dim", [8, 32, 1000])
def test_cv_fold_parity_with_reference_algorithm(rng, pca_dim):
    n, dim_i, dim_t, k = 80, 48, 24, 5
    labs = [["A", "B", "C", "D"][i % 4] for i in range(n)]
    centers = rng.randn(4, dim_i) * 1.5
    img = np.stack([centers[i % 4] + rng.randn(dim_i) for i in range(n)])
    txt = rng.randn(n, dim_t)
    pids = [f"p{i}" for i in range(n)]
    ev = CVRetrievalEvaluator(cv_folds=5, pca_dim=pca_dim, top_k=k, seed=42,
                              device="cpu")
    for train_idx, test_idx in StratifiedKFold(5, shuffle=True, random_state=42).split(
            pids, labs):
        train_labels = [labs[i] for i in train_idx]
        test_labels = [labs[i] for i in test_idx]
        golden = _golden_fold_metrics(img[train_idx], txt[train_idx], img[test_idx],
                                      txt[test_idx], train_labels, test_labels,
                                      pca_dim, k)
        got = ev.evaluate_fold(img[train_idx], txt[train_idx], img[test_idx],
                               txt[test_idx], train_labels, test_labels,
                               [pids[i] for i in test_idx], fusion="concat",
                               train_ids=[pids[i] for i in train_idx])
        for key in ("top1", "vote_acc", "weighted_vote_acc"):
            assert got[key] == pytest.approx(golden[key])
        assert got["all_top_labels"] == golden["all_top_labels"]


def test_run_cv_custom_top_k_list_and_retrieve_topk(rng):
    pids, labs, img, txt = _fold_data(rng, n=40, dim_i=16, dim_t=16)
    embs = {p: {"image": img[i], "text": txt[i]} for i, p in enumerate(pids)}
    ev = CVRetrievalEvaluator(cv_folds=3, pca_dim=8, top_k=10, seed=42, device="cpu")
    out = ev.run_cv(pids, labs, embs, fusion="image_only", top_k_list=[1, 10])
    assert {k for k in out["summary"] if k.startswith("top")} == {"top1", "top10"}
    for fold in out["fold_results"]:
        assert "top10" in fold and "top3" not in fold
    db = img / np.linalg.norm(img, axis=1, keepdims=True)
    got = ev.retrieve_topk(db[3], db, labs, 4, db_ids=pids)
    want = JaxEvaluator().retrieve_topk(db[3], db, labs, 4, db_ids=pids)
    assert got[0] == want[0] and got[2] == want[2] and got[2][0] == "p3"
    np.testing.assert_allclose(got[1], want[1], atol=SCORES_ATOL)


# -- the CV runner with the fake encoders, against the JAX runner ------------

@pytest.fixture()
def dataset(tmp_path, rng):
    from PIL import Image
    records = []
    for label in ["Bacterial", "Viral", "PJP", "Normal"]:
        for i in range(6):
            pid = f"{label}_{i}"
            pdir = tmp_path / "imgs" / pid
            pdir.mkdir(parents=True)
            slices = []
            for s in range(3):
                p = pdir / f"s{s}.png"
                Image.fromarray((rng.rand(16, 16, 3) * 255).astype(np.uint8)).save(p)
                slices.append(str(p))
            records.append({"patient_id": pid, "label": label, "slices": slices,
                            "meta": {"sex": "男", "age": str(30 + i), "fever": "有",
                                     "symptom": "咳嗽"}})
    mpath = tmp_path / "manifest.jsonl"
    save_manifest(records, mpath)
    return mpath


def _run_both(tmp_path, monkeypatch, mpath, extra):
    """Run the JAX runner and the port's (--device cpu), each in its own
    working directory (the embeddings cache is relative), with the same
    global numpy seed (the text shuffle draws from it)."""
    outs = {}
    for name, runner, device in (("jax", jax_runner, "cpu"),
                                 ("port", port_runner, "cpu")):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        np.random.seed(0)
        runner.main(["--manifest_path", str(mpath), "--output_dir", str(cwd / "out"),
                     "--image_encoder", "fake", "--text_encoder", "fake",
                     "--pca_dim", "8", "--top_k", "3", "--device", device, *extra])
        outs[name] = cwd / "out"
    return outs["port"], outs["jax"]


def _assert_experiment_equal(got_exp, want_exp):
    folds = sorted(p.name for p in want_exp.glob("fold_*"))
    assert folds and sorted(p.name for p in got_exp.glob("fold_*")) == folds
    for fold in folds:
        got = json.loads((got_exp / fold / "metrics.json").read_text(encoding="utf-8"))
        want = json.loads((want_exp / fold / "metrics.json").read_text(encoding="utf-8"))
        _assert_fold_equal(got, want)
    read = lambda p: list(csv.reader(p.open(encoding="utf-8")))
    assert read(got_exp / "summary.csv") == read(want_exp / "summary.csv")
    gc = json.loads((got_exp / "config.json").read_text(encoding="utf-8"))
    wc = json.loads((want_exp / "config.json").read_text(encoding="utf-8"))
    assert {k: v for k, v in gc.items() if k != "device"} == \
        {k: v for k, v in wc.items() if k != "device"}


def test_single_experiment_and_cache_reload_match_jax(dataset, tmp_path, monkeypatch):
    got, want = _run_both(tmp_path, monkeypatch, dataset, ["--experiment_id", "t1"])
    _assert_experiment_equal(got / "exp_t1", want / "exp_t1")
    assert (got / "exp_t1" / "confusion_matrices.png").exists()
    cache = tmp_path / "port" / "outputs" / "features" / "combined_embeddings.npz"
    data = np.load(cache, allow_pickle=True)
    assert {"patient_ids", "image_matrix", "text_matrix"} <= set(data.files)
    # a second run from the cache gives the same artifacts
    monkeypatch.chdir(tmp_path / "port")
    port_runner.main(["--manifest_path", str(dataset), "--output_dir", str(got),
                      "--image_encoder", "fake", "--text_encoder", "fake",
                      "--experiment_id", "t2", "--pca_dim", "8", "--top_k", "3",
                      "--device", "cpu", "--skip_encoding",
                      "--embeddings_path", str(cache)])
    for fold in range(1, 6):
        a = json.loads((got / "exp_t1" / f"fold_{fold}" / "metrics.json").read_text())
        b = json.loads((got / "exp_t2" / f"fold_{fold}" / "metrics.json").read_text())
        assert a == b


def test_text_shuffle_matches_jax(dataset, tmp_path, monkeypatch):
    got, want = _run_both(tmp_path, monkeypatch, dataset,
                          ["--experiment_id", "shuf", "--text_shuffle"])
    for exp in ("exp_shuf_original", "exp_shuf_shuffled"):
        _assert_experiment_equal(got / exp, want / exp)
    summary = json.loads((got / "shuf_text_shuffle_summary.json").read_text())
    assert {"original", "shuffled"} <= set(summary)


@pytest.mark.parametrize("scan,values,exps,fusion", [
    ("--topk_scan", ["--topk_list", "1", "3"], ["tk_topk1", "tk_topk3"], "concat"),
    ("--pca_scan", ["--pca_list", "4", "8"], ["tk_pca4", "tk_pca8"], "concat"),
    ("--late_fusion_scan", ["--w_text_list", "0.0", "1.0"], ["tk_w0.00", "tk_w1.00"],
     "late"),
])
def test_scans_match_jax(dataset, tmp_path, monkeypatch, scan, values, exps, fusion):
    got, want = _run_both(tmp_path, monkeypatch, dataset,
                          ["--experiment_id", "tk", "--fusion", fusion, scan, *values])
    for exp in exps:
        _assert_experiment_equal(got / f"exp_{exp}", want / f"exp_{exp}")
    suffix = {"--topk_scan": "topk_scan", "--pca_scan": "pca_scan",
              "--late_fusion_scan": "late_fusion"}[scan]
    summary = json.loads((got / f"tk_{suffix}_summary.json").read_text())
    assert set(exps) <= set(summary)


def test_missing_matplotlib_skips_only_the_png(dataset, tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    with caplog.at_level(logging.WARNING):
        port_runner.main(["--manifest_path", str(dataset), "--output_dir",
                          str(tmp_path / "out"), "--image_encoder", "fake",
                          "--text_encoder", "fake", "--experiment_id", "np",
                          "--pca_dim", "8", "--device", "cpu"])
    exp = tmp_path / "out" / "exp_np"
    assert (exp / "summary.csv").exists() and (exp / "fold_5" / "metrics.json").exists()
    assert not (exp / "confusion_matrices.png").exists()
    warned = [r.message for r in caplog.records if "matplotlib" in r.message]
    assert len(warned) == 1 and "confusion_matrices.png" in warned[0]


def test_vlm_review_and_unported_encoders_raise(dataset, tmp_path, monkeypatch):
    """``--vlm_review`` runs (``judge/review.py`` is ported; its output is
    held against JAX's below). Every encoder family is ported: the default
    ``--text_encoder qwen3_vl_8b`` without a model path raises JAX's
    ``ValueError`` in both drivers (JAX's passes no path, so every
    checkpoint-only encoder raises there), and a ``dino`` image encoder (a
    random tower, small in both packages) encodes the cohort."""
    import dataclasses

    import emr2a_tpu.encoders.dino_encoder as jax_dino
    import emr2a_tpu_torch.encoders.dino_encoder as port_dino
    monkeypatch.chdir(tmp_path)
    base = ["--manifest_path", str(dataset), "--output_dir", str(tmp_path / "out"),
            "--image_encoder", "fake", "--text_encoder", "fake",
            "--experiment_id", "vr", "--device", "cpu"]
    port_runner.main(base + ["--vlm_review", "--vlm_model_path", "fake"])
    review = json.loads((tmp_path / "out" / "exp_vr" / "vlm_review_summary.json").read_text())
    assert len(review["vlm_predictions"]) == 24
    errors = []
    for runner in (jax_runner, port_runner):
        with pytest.raises(ValueError) as e:
            runner.load_or_encode_embeddings(
                [], runner.BaseConfig(), "fake", "qwen3_vl_8b", "cpu", 4,
                fusion="text_only")
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "Qwen3VLEncoder needs model_path or (config, params)"
    from emr2a_tpu_torch.data.manifest import load_manifest
    manifest = load_manifest(dataset)[:4]
    dims = []
    for runner, mod in ((jax_runner, jax_dino), (port_runner, port_dino)):
        monkeypatch.setattr(mod, "DINOV3_VITL16", dataclasses.replace(
            mod.DINOV3_VITL16, hidden_size=64, num_layers=1, num_heads=2, mlp_dim=128))
        out = runner.load_or_encode_embeddings(
            manifest, runner.BaseConfig(), "dino", "fake", "cpu", 4, fusion="image_only")
        assert sorted(out) == sorted(r["patient_id"] for r in manifest)
        dims.append({v["image"].shape for v in out.values()})
    assert dims[0] == dims[1] == {(64,)}


REVIEW_SCRIPT = ["PJP,0.85,covered", "Viral,0.6,uncovered",
                 "Diagnosis: Normal\nConfidence: 70\nCoverage: partial",
                 '{"diagnosis": "Bacterial", "confidence": 0.9, "coverage": "covered"}',
                 "not parseable at all", '{"diagnosis": "Flu"}', "uncertain, 0.3",
                 "Diagnosis: Viral\nConfidence: 1.2.3"]


@pytest.mark.parametrize("script", [None, REVIEW_SCRIPT])
def test_vlm_review_section_matches_jax(dataset, tmp_path, monkeypatch, script):
    """``--vlm_review --vlm_model_path fake``: the port's ``vlm_review``
    section and its evidence montages equal the JAX runner's, with the fake
    backend's default answer (no diagnosis: every review abstains) and with
    a script of every output format (both packages' ``load_backend`` give
    the same scripted fake)."""
    import emr2a_tpu.judge.review as jax_review
    from emr2a_tpu.judge.backends import FakeVLMBackend as JaxFake
    from PIL import Image

    import emr2a_tpu_torch.judge.review as port_review
    from emr2a_tpu_torch.judge.backends import FakeVLMBackend as PortFake
    if script is not None:
        monkeypatch.setattr(jax_review, "load_backend",
                            lambda *a, **kw: JaxFake(script=list(script)))
        monkeypatch.setattr(port_review, "load_backend",
                            lambda *a, **kw: PortFake(script=list(script)))
    got, want = _run_both(tmp_path, monkeypatch, dataset,
                          ["--experiment_id", "vr", "--vlm_review", "--vlm_model_path", "fake"])
    _assert_experiment_equal(got / "exp_vr", want / "exp_vr")
    review = lambda root: json.loads(
        (root / "exp_vr" / "vlm_review_summary.json").read_text(encoding="utf-8"))
    assert review(got) == review(want)
    if script is None:
        assert set(review(got)["vlm_predictions"]) == {None}
    else:
        assert {"PJP", "Viral", "Normal", "Bacterial", "uncertain", None} == \
            set(review(got)["vlm_predictions"])
    files = lambda root: sorted(str(p.relative_to(root)) for p in
                                (root / "exp_vr" / "vlm_review").rglob("*.png"))
    assert files(got) == files(want) and len(files(got)) > 24
    for name in files(got):
        assert np.array_equal(np.asarray(Image.open(got / name)),
                              np.asarray(Image.open(want / name))), name
