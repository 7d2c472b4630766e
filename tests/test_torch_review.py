"""The port's G2 goalkeeper review (``judge/review.py``) against the JAX
package's ``emr2a_tpu.judge.review`` on the same cohort and the same scripted
fake backend: the same review dict, the same evidence files under
``evidence_{idx}/`` (pixel for pixel), the same evidence text and the same
parse of every output format. And the port's divergence: ``query_vlm``
abstains only on no backend, a missing or an unreadable montage, or an
unparseable output, while any other error (a failed kernel launch) propagates
where JAX's catches it."""

import numpy as np
import pytest
from PIL import Image

from emr2a_tpu.judge.backends import FakeVLMBackend as JaxFake
from emr2a_tpu.judge.review import VLMReviewModule as JaxReview
from emr2a_tpu_torch.judge import VLMReviewModule
from emr2a_tpu_torch.judge.backends import FakeVLMBackend

SCRIPT = ["PJP,0.85,covered", "Viral，0.6，uncovered", "not parseable at all §§§",
          "Diagnosis: Normal\nConfidence: 70\nCoverage: partial",
          '```json\n{"diagnosis": "Bacterial", "confidence": "0.9"}\n```',
          '{"diagnosis": "Flu", "confidence": 0.4}\nDiagnosis: PJP',
          "uncertain, 0.2", "Diagnosis: Viral\nConfidence: 1.2.3", ""]


@pytest.fixture()
def cohort(tmp_path):
    rng = np.random.RandomState(0)
    manifest = []
    for i, label in enumerate(["PJP", "Viral", "Normal", "Bacterial"] * 2):
        pdir = tmp_path / "imgs" / f"p{i:02d}"
        pdir.mkdir(parents=True)
        slices = []
        for s in range(3 + i % 3):
            path = pdir / f"s{s}.png"
            Image.fromarray((rng.rand(24, 20 + 4 * (s % 2), 3) * 255).astype(np.uint8)).save(path)
            slices.append(str(path))
        meta = {"sex": "F", "age": str(40 + i)} if i % 2 else {"fever": "yes", "symptom": "cough"}
        manifest.append({"patient_id": f"p{i:02d}", "label": label, "slices": slices,
                         "meta": meta})
    return manifest


def _review(module, cohort, out):
    n = len(SCRIPT)
    patients = [cohort[i % len(cohort)] for i in range(n)]
    neighbors = [[(f"p{(i + j) % 8:02d}", cohort[(i + j) % 8]["label"], 0.9 - 0.1 * j)
                  for j in range(1, 7)] + [("missing", "PJP", 0.1)] for i in range(n)]
    return module.g2_goalkeeper_review(
        retrieval_predictions=[p["label"] for p in patients],
        retrieval_similarities=[[s for _, _, s in nb] for nb in neighbors],
        retrieval_labels=[[lab for _, lab, _ in nb] for nb in neighbors],
        query_patients=patients, top_neighbors_list=neighbors, manifest=cohort,
        output_dir=out)


def test_review_equals_jax_dict_and_evidence(cohort, tmp_path):
    port_backend, jax_backend = FakeVLMBackend(script=SCRIPT), JaxFake(script=SCRIPT)
    got = _review(VLMReviewModule(backend=port_backend), cohort, tmp_path / "port")
    want = _review(JaxReview(backend=jax_backend), cohort, tmp_path / "jax")
    assert got == want
    assert got["vlm_predictions"][:2] == ["PJP", "Viral"]
    assert [c["prompt"] for c in port_backend.calls] == [c["prompt"] for c in jax_backend.calls]
    assert [c["system"] for c in port_backend.calls] == [c["system"] for c in jax_backend.calls]
    files = lambda root: sorted(str(p.relative_to(root)) for p in root.rglob("*.png"))
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert "evidence_0/query_p00_montage.png" in files(tmp_path / "port")
    for name in files(tmp_path / "port"):
        assert np.array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                              np.asarray(Image.open(tmp_path / "jax" / name))), name


def test_evidence_package_and_parse_equal_jax(cohort, tmp_path):
    port, jax = VLMReviewModule(backend=FakeVLMBackend()), JaxReview(backend=JaxFake())
    neighbors = [("p01", "Viral", 0.93), ("nobody", "PJP", 0.5), ("p02", "Normal", 0.81)]
    for q in (cohort[0], cohort[1]):
        got = port.construct_evidence_package(q, neighbors, cohort, tmp_path / "a")
        want = jax.construct_evidence_package(q, neighbors, cohort, tmp_path / "b")
        assert got["query_text"] == want["query_text"]
        assert [n["id"] for n in got["neighbors"]] == ["p01", "p02"]
        assert {k: v for k, v in got.items() if k not in ("query_montage_path", "neighbors")} \
            == {k: v for k, v in want.items() if k not in ("query_montage_path", "neighbors")}
    for text in SCRIPT + ["Diagnosis: uncertain", "PJP,150", '{"diagnosis": "Normal"}',
                          "  Bacterial , 0.7 , covered extra"]:
        assert port._parse_vlm_output(text) == jax._parse_vlm_output(text), text


def test_query_vlm_abstains_only_on_its_reasons(cohort, tmp_path):
    """No backend, a missing or an unreadable montage, or an unparseable
    output abstain (None); a backend error propagates."""
    module = VLMReviewModule(backend=FakeVLMBackend(script=["PJP,0.9"]))
    ev = module.construct_evidence_package(cohort[0], [], cohort, tmp_path)
    assert module.query_vlm(ev)["pred"] == "PJP"
    assert module.query_vlm({**ev, "query_montage_path": str(tmp_path / "none.png")}) is None
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    assert module.query_vlm({**ev, "query_montage_path": str(bad)}) is None
    assert VLMReviewModule(backend=FakeVLMBackend(script=["§"])).query_vlm(ev) is None
    assert VLMReviewModule(model_path=None, device="cpu").query_vlm(ev) is None

    def broken(images, prompt):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")
    with pytest.raises(RuntimeError, match="CUDA"):
        VLMReviewModule(backend=FakeVLMBackend(fn=broken)).query_vlm(ev)
    assert JaxReview(backend=JaxFake(fn=broken)).query_vlm(ev) is None   # JAX abstains
    assert VLMReviewModule(backend=FakeVLMBackend()).device == "cuda"
