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
    ("void emr2a::gemm_bf16_kernel<1, true>(emr2a::GemmParams)",
     "fc1 GEMM + LN + gelu (K1)"),
    ("void emr2a::gemm_s8_kernel<0>(emr2a::GemmS8Params)", "Q/K/V s8 GEMM (K4)"),
    ("void emr2a::gemm_s8_kernel<2>(emr2a::GemmS8Params)",
     "fc2 and out-proj s8 GEMM + residual (K2, K4)"),
    ("void emr2a::quantize_rows_kernel<__nv_bfloat16, true>(emr2a::QuantParams)",
     "LN + row quantize (K2, K4)"),
])
def test_profiler_names_every_kernel(key, label):
    from emr2a_tpu_torch.tools.profile_tower import kernel_label
    got, ops = kernel_label(key, T=6400, B=32, S=200)
    assert got == label
    if "s8 GEMM (K4)" in label:
        assert ops == 2 * 6400 * 768 * 3 * 768
    assert kernel_label("elementwise_kernel", 1, 1, 1) == ("elementwise_kernel", None)
