"""The port's own data helpers against ``emr2a_tpu.data``: the same decoded
arrays, resize plans, resized arrays, shape groups and manifest records
(exact equality), and the same errors."""

import json

import numpy as np
import pytest

from emr2a_tpu.data import images as jax_images
from emr2a_tpu.data import manifest as jax_manifest
from emr2a_tpu_torch.data import images as port_images
from emr2a_tpu_torch.data import manifest as port_manifest


def test_decode_matches(rng, tmp_path):
    from PIL import Image
    paths = []
    for i, (h, w, mode) in enumerate([(20, 30, "RGB"), (512, 512, "L"), (7, 9, "RGB")]):
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        img = Image.fromarray(arr if mode == "RGB" else arr[..., 0])
        paths.append(tmp_path / f"s{i}.png")
        img.save(paths[-1])
    paths.append(tmp_path / "missing.png")
    (tmp_path / "broken.png").write_bytes(b"not a png")
    paths.append(tmp_path / "broken.png")
    got = port_images.load_images_rgb(paths)
    want = jax_images.load_images_rgb(paths)
    assert [g is None for g in got] == [w is None for w in want] == [False] * 3 + [True] * 2
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == np.uint8 and g.shape[-1] == 3
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("h,w,size,shortest_edge,method", [
    (512, 512, 224, True, "bicubic"), (300, 200, 224, True, "bilinear"),
    (100, 160, 224, True, "bicubic"), (224, 300, 224, True, "bicubic"),
    (50, 80, 64, False, "bilinear"),
])
def test_resize_plan_and_resize_match(rng, h, w, size, shortest_edge, method):
    assert port_images.plan_resize(h, w, size, shortest_edge) == \
        jax_images.plan_resize(h, w, size, shortest_edge)
    arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        port_images.resize_to(arr, size, shortest_edge, method),
        jax_images.resize_to(arr, size, shortest_edge, method))


def test_group_by_shape_matches(rng):
    imgs = [np.zeros((4, 5, 3)), None, np.zeros((6, 5, 3)), np.zeros((4, 5, 3)), None]
    assert port_images.group_by_shape(imgs) == jax_images.group_by_shape(imgs)


def test_manifest_roundtrip_and_errors_match(tmp_path):
    records = [{"patient_id": "P1", "label": "细菌性肺炎", "slices": ["a.png"]},
               {"patient_id": "P2", "label": "正常", "meta": {"age": "40"}}]
    port_manifest.save_manifest(records, tmp_path / "a" / "m.jsonl")
    jax_manifest.save_manifest(records, tmp_path / "b" / "m.jsonl")
    assert (tmp_path / "a" / "m.jsonl").read_bytes() == (tmp_path / "b" / "m.jsonl").read_bytes()
    assert port_manifest.load_manifest(tmp_path / "a" / "m.jsonl") == records
    (tmp_path / "list.json").write_text(json.dumps(records), encoding="utf-8")
    assert port_manifest.load_manifest(tmp_path / "list.json") == \
        jax_manifest.load_manifest(tmp_path / "list.json") == records

    bad = {"missing.jsonl": None, "bad.jsonl": '{"a": 1}\n{oops\n',
           "notobj.jsonl": '[1, 2]\n', "root.json": '{"a": 1}',
           "items.json": '[{"a": 1}, 3]'}
    for name, text in bad.items():
        if text is not None:
            (tmp_path / name).write_text(text, encoding="utf-8")
        errors = []
        for mod in (port_manifest, jax_manifest):
            with pytest.raises((ValueError, FileNotFoundError)) as e:
                mod.load_manifest(tmp_path / name)
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1], name
