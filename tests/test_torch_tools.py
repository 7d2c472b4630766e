"""The synthetic CT cohort behind ``chip_smoke.py`` and the step2 profiler:
a manifest step2 reads, in 4 classes, with RGB PNGs that decode to the same
pixels as the grey ones; and the profiler's names for the kernels it
times."""

import numpy as np
import pytest
import torch

from emr2a_tpu.data.images import load_image_rgb
from emr2a_tpu_torch.pipelines.step2_embeddings import build_embeddings as step2
from emr2a_tpu_torch.tools.cohort import LABELS, write_cohort

torch.set_num_threads(1)


def test_write_cohort_grey_and_rgb(tmp_path):
    grey = write_cohort(tmp_path / "grey", n_patients=4, n_slices=2)
    rgb = write_cohort(tmp_path / "rgb", n_patients=4, n_slices=2, rgb=True)
    records = step2.load_manifest(grey)
    assert [r["label"] for r in records] == list(LABELS)
    paths = step2.load_images(records, grey.parent)
    assert sorted(paths) == ["P000", "P001", "P002", "P003"]
    assert all(len(p) == 2 for p in paths.values())
    rgb_paths = step2.load_images(step2.load_manifest(rgb), rgb.parent)
    a = load_image_rgb(paths["P001"][1])
    b = load_image_rgb(rgb_paths["P001"][1])
    assert a.shape == (512, 512, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    # patients differ in texture
    assert not np.array_equal(a, load_image_rgb(paths["P002"][1]))


@pytest.mark.parametrize("key,label", [
    ("void emr2a::attention_core_kernel<float>(__nv_bfloat16 const*)",
     "attention core, f32 out (K4)"),
    ("void emr2a::attention_core_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
     "attention core (K3)"),
    ("void emr2a::gemm_bf16_kernel<256, 1>(CUtensorMap_st, emr2a::GemmParams)",
     "fc1 GEMM + gelu (K1)"),
    ("void emr2a::gemm_bf16_kernel<256, 3>(CUtensorMap_st, emr2a::GemmParams)",
     "fc1 GEMM + gelu (K1)"),
    ("void emr2a::gemm_bf16_kernel<128, 0>(CUtensorMap_st, emr2a::GemmParams)",
     "Q/K/V GEMM (K3)"),
    ("void emr2a::gemm_bf16_kernel<128, 2>(CUtensorMap_st, emr2a::GemmParams)",
     "fc2 and out-proj GEMM + residual (K1, K3)"),
    ("void emr2a::layer_norm_rows_kernel(__nv_bfloat16 const*)", "LN row pass (K1, K3)"),
    ("void emr2a::gemm_s8_wgmma_kernel<false, 2, 128, 0, 3>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, emr2a::WgmmaParams)",
     "Q/K/V s8 GEMM (K4)"),
    ("void emr2a::gemm_s8_wgmma_kernel<false, 2, 80, 2, 1>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, emr2a::WgmmaParams)",
     "fc2 and out-proj s8 GEMM + residual (K2, K4)"),
    ("void emr2a::gemm_s8_wgmma_kernel<false, 2, 128, 3, 1>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, emr2a::WgmmaParams)",
     "fc1 s8 GEMM + gelu (K2)"),
    ("void emr2a::gemm_s8_wgmma_kernel<false, 2, 64, 0, 1>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, emr2a::WgmmaParams)",
     "K5 wgmma GEMM"),
    ("void emr2a::quantize_rows_kernel<__nv_bfloat16, true>(emr2a::QuantParams)",
     "LN + row quantize (K2, K4)"),
])
def test_profiler_names_every_kernel(key, label):
    from emr2a_tpu_torch.tools.profile_tower import kernel_label
    got, ops = kernel_label(key, T=6400, B=32, S=200)
    assert got == label
    if "Q/K/V" in label:
        assert ops == 2 * 6400 * 768 * 3 * 768
    assert kernel_label("elementwise_kernel", 1, 1, 1) == ("elementwise_kernel", None)


@pytest.mark.parametrize("key,group", [
    ("void emr2a::gemm_s8_wgmma_kernel<false, 2, 128, 0, 1>(CUtensorMap_st)", "K5 wgmma GEMM"),
    ("void emr2a::gemm_s8_wgmma_kernel<true, 1, 192, 0, 1>(CUtensorMap_st)", "K7 wgmma GEMM"),
])
def test_judge_profile_names_the_quantized_gemms(key, group):
    from emr2a_tpu_torch.tools.profile_judge import group_of
    assert group_of(key) == group


def test_step1_on_the_cohort_tree_gives_its_manifest(tmp_path):
    """The raw tree (Case_csv + CT_2D_image_core) through the port's step1
    gives the cohort manifest's patients, labels and slices in natural
    order (slice_2 before slice_10), and the JAX package's step1 bytes."""
    import json

    from emr2a_tpu.pipelines.step1_manifest import build_manifest as jax_step1
    from emr2a_tpu_torch.pipelines.step1_manifest import build_manifest as step1

    root = tmp_path / "cohort"
    manifest = write_cohort(root, n_patients=8, n_slices=11)
    want = [json.loads(l) for l in manifest.read_text(encoding="utf-8").splitlines()]
    args = ["--data_root", str(root), "--relative_paths", "false"]
    step1.main(args + ["--out_dir", str(tmp_path / "port")])
    jax_step1.main(args + ["--out_dir", str(tmp_path / "jax")])
    got_text = (tmp_path / "port" / "manifest.jsonl").read_text(encoding="utf-8")
    assert got_text == (tmp_path / "jax" / "manifest.jsonl").read_text(encoding="utf-8")
    got = {r["patient_id"]: r for r in map(json.loads, got_text.splitlines())}
    assert sorted(got) == [r["patient_id"] for r in want]
    for r in want:
        assert got[r["patient_id"]]["label"] == r["label"]
        assert got[r["patient_id"]]["slices"] == r["slices"]
        assert got[r["patient_id"]]["match_by"] == "name"
    assert [s.rsplit("/", 1)[-1] for s in got["P000"]["slices"]][1:3] == \
        ["slice_1.png", "slice_2.png"]
    assert set(got["P001"]["meta"]) == {"sex", "age", "fever", "symptom"}
    assert not (tmp_path / "port" / "missing_in_fs.csv").exists()
    assert not (tmp_path / "port" / "missing_in_csv.csv").exists()
