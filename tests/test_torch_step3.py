"""Step3 of the port on the CPU against the JAX package: the numpy
``train_test_split`` against sklearn's, ``RetrievalEvaluator`` against
JAX's on seeded embeddings (labels, top-k lists and every metric equal, for
each fusion type), and the step3 CLI's ``retrieval_results.json`` against
the JAX CLI's."""

import json

import numpy as np
import pytest
from sklearn.model_selection import train_test_split as sk_train_test_split

from emr2a_tpu.pipelines.step3_retrieval import evaluate_retrieval as jax_step3
from emr2a_tpu.retrieval import RetrievalEvaluator as JaxEvaluator
from emr2a_tpu_torch.eval.cv import train_test_split
from emr2a_tpu_torch.pipelines.step3_retrieval import evaluate_retrieval as step3
from emr2a_tpu_torch.retrieval import RetrievalEvaluator


def _label_sets():
    rng = np.random.RandomState(11)
    sets = [["A", "B"] * 5, ["A"] * 7 + ["B"] * 3 + ["C"] * 2,
            list("AABBBCCCCDDDDD"), ["x", "y", "z"] * 9 + ["x"]]
    for n_classes in (2, 3, 4, 6):
        for n in (12, 25, 40, 97):
            base = np.arange(n_classes).repeat(2)          # every class twice
            extra = rng.randint(0, n_classes, n - len(base))
            labels = np.concatenate([base, extra])
            rng.shuffle(labels)
            sets.append([f"L{v}" for v in labels])
    return sets


@pytest.mark.parametrize("test_size", [0.2, 0.25, 0.33, 0.5, 0.1, 0.3])
@pytest.mark.parametrize("seed", [0, 42])
def test_train_test_split_equals_sklearn(test_size, seed):
    for labels in _label_sets():
        ids = [f"P{i}" for i in range(len(labels))]
        try:
            want = sk_train_test_split(ids, labels, test_size=test_size,
                                       random_state=seed, stratify=labels)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:30]):
                train_test_split(ids, labels, test_size=test_size,
                                 random_state=seed, stratify=labels)
            continue
        got = train_test_split(ids, labels, test_size=test_size,
                               random_state=seed, stratify=labels)
        assert got == want
        assert all(isinstance(part, list) for part in got)


def test_train_test_split_errors_and_arrays_equal_sklearn():
    labels = ["A"] * 6 + ["B"]
    with pytest.raises(ValueError, match="only 1 member"):
        train_test_split(list(range(7)), labels, test_size=0.3,
                         random_state=0, stratify=labels)
    for bad in (0.0, 1.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="test_size"):
            train_test_split(list(range(7)), test_size=bad, random_state=0,
                             stratify=labels)
    with pytest.raises(ValueError, match="train set will be empty"):
        sk_train_test_split(list(range(7)), test_size=0.95, random_state=0,
                            stratify=labels)
    with pytest.raises(ValueError, match="train set will be empty"):
        train_test_split(list(range(7)), test_size=0.95, random_state=0,
                         stratify=labels)
    with pytest.raises(ValueError, match="greater or equal to the number of classes"):
        train_test_split(list(range(12)), test_size=0.1, random_state=0,
                         stratify=["A", "B", "C"] * 4)
    ids = [f"P{i}" for i in range(15)]
    y = [i % 3 for i in range(15)]
    feats = [float(i) / 7 for i in range(15)]
    for kw in ({"test_size": 0.2, "random_state": 3},
               {"test_size": 0.5, "random_state": 1},
               {"test_size": 0.4, "random_state": 0}):
        got = train_test_split(ids, y, feats, stratify=y, **kw)
        want = sk_train_test_split(ids, y, feats, stratify=y, **kw)
        assert len(got) == len(want) == 6
        assert got == want


def _cohort(rng, n=60, dim=24):
    labels = [["Bacterial", "Viral", "PJP", "Normal"][i % 4] for i in range(n)]
    centers = rng.randn(2, 4, dim)
    img = np.stack([centers[0, i % 4] + 2.5 * rng.randn(dim) for i in range(n)])
    txt = np.stack([centers[1, i % 4] + 3.0 * rng.randn(dim) for i in range(n)])
    return labels, img.astype(np.float32), txt.astype(np.float32)


@pytest.mark.parametrize("fusion,score_mode,with_text,with_image", [
    ("late", "none", True, True), ("late", "zscore", True, True),
    ("late", "minmax", True, True), ("early", "none", True, True),
    ("none", "none", False, True), ("none", "none", True, False)])
def test_evaluator_equals_jax(rng, fusion, score_mode, with_text, with_image):
    labels, img, txt = _cohort(rng)
    ours = RetrievalEvaluator(device="cpu")
    theirs = JaxEvaluator()
    tr, te = ours.stratified_split(labels)
    assert (tr, te) == theirs.stratified_split(labels)
    tl, el = [labels[i] for i in tr], [labels[i] for i in te]
    pick = lambda a, idx: a[idx] if a is not None else None
    t, i = (txt if with_text else None), (img if with_image else None)
    args = (pick(t, tr), pick(t, te), pick(i, tr), pick(i, te), tl, el)
    kw = dict(text_weight=0.3, fusion_type=fusion, score_mode=score_mode,
              top_k_list=[1, 3, 5, 10])
    got = ours.evaluate_retrieval(*args, **kw)
    want = theirs.evaluate_retrieval(*args, **kw)
    assert got == want
    if fusion == "late":
        assert len(got["all_top_labels_top5"]) == len(te)


def test_evaluator_helpers_equal_jax(rng):
    labels, img, _ = _cohort(rng, n=40)
    ours, theirs = RetrievalEvaluator(device="cpu", use_pca=True, pca_dim=8), \
        JaxEvaluator(use_pca=True, pca_dim=8)
    for a, b in zip(ours.process_embeddings(img[:30], img[30:]),
                    theirs.process_embeddings(img[:30], img[30:])):
        np.testing.assert_allclose(a, b, atol=2e-5)
    scores = img[30:] @ img[:30].T
    assert ours.get_all_top_labels(scores, labels[:30], labels[30:]) == \
        theirs.get_all_top_labels(scores, labels[:30], labels[30:])


def test_step3_cli_equals_jax(tmp_path, rng):
    labels, img, _ = _cohort(rng, n=48, dim=16)
    ids = [f"P{i:03d}" for i in range(len(labels))]
    manifest = tmp_path / "manifest.jsonl"
    manifest.write_text("".join(json.dumps({"patient_id": p, "label": l}) + "\n"
                                for p, l in zip(ids, labels)), encoding="utf-8")
    np.savez(tmp_path / "embeddings.npz", **{
        p: np.stack([v + 0.3 * rng.randn(16), v + 0.3 * rng.randn(16)]).astype(np.float32)
        for p, v in zip(ids, img)})
    args = ["--manifest_path", str(manifest), "--embeddings_path",
            str(tmp_path / "embeddings.npz"), "--top_k", "7"]
    step3.main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    jax_step3.main(args + ["--output_dir", str(tmp_path / "jax")])
    got = (tmp_path / "port" / "retrieval_results.json").read_text(encoding="utf-8")
    want = (tmp_path / "jax" / "retrieval_results.json").read_text(encoding="utf-8")
    assert got == want
    assert set(json.loads(got)) == {"image_top1", "image_top3", "image_top5",
                                    "image_top7", "image_weighted"}
