"""The converted-params cache (``models/checkpoint.load_or_convert``) on
a tiny random Qwen3-VL checkpoint written by ``tools/qwen_checkpoint``.

JAX's semantics (``emr2a_tpu/models/checkpoint.py``): a cached load equals
the cold load tensor for tensor (and the JAX package's conversion of the
same files); a weight file changed in size or mtime is converted again,
even where its mtime moved back; a corrupt cache is converted again and
rewritten; ``cache_params=False`` writes nothing; a directory that cannot
be written still loads. The port's own rules: bf16 and f32 loads keep
apart caches; the entry points (``QwenVLBackend`` with its draft,
``Qwen3VLEncoder``, ``bringup_qwen3_vl`` and ``--no-cache``) take the
flag."""

import logging
import os

import numpy as np
import pytest
import torch

from emr2a_tpu.models.checkpoint import load_qwen3_vl as jax_load
from emr2a_tpu_torch.models import checkpoint, convert
from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.models.convert import params_from_jax
from emr2a_tpu_torch.tools.qwen_checkpoint import write_checkpoint
from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

CONFIG = pq.Qwen3VLConfig(
    vision=pq.QwenVisionConfig(depth=2, hidden_size=32, intermediate_size=64, num_heads=2,
                               patch_size=4, out_hidden_size=32,
                               num_position_embeddings=64, deepstack_visual_indexes=(0,)),
    text=pq.QwenTextConfig(hidden_size=32, num_layers=2, num_heads=4,
                           num_kv_heads=2, head_dim=8, intermediate_size=64,
                           mrope_section=(2, 1, 1)))


def _checkpoint(path, seed=3):
    return write_checkpoint(path, CONFIG, pq.random_state(CONFIG, seed=seed, device="cpu"))


@pytest.fixture()
def ckpt(tmp_path):
    return _checkpoint(tmp_path / "ckpt")


@pytest.fixture()
def conversions(monkeypatch):
    """Counts the reads of the checkpoint's weights (each conversion
    reads them once)."""
    count = [0]
    read = checkpoint.load_state_dict

    def counting(path):
        count[0] += 1
        return read(path)

    monkeypatch.setattr(checkpoint, "load_state_dict", counting)
    return count


def _caches(path):
    return sorted(p.name for p in path.iterdir() if p.name.startswith("emr2a_torch."))


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cached_load_equals_cold_load_and_jax(ckpt, conversions, dtype):
    cold = checkpoint.load_qwen3_vl(ckpt, dtype=dtype, cache_params=False)[1]
    assert conversions[0] == 1 and _caches(ckpt) == []
    first = checkpoint.load_qwen3_vl(ckpt, dtype=dtype)[1]
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    assert conversions[0] == 2 and _caches(ckpt) == [f"emr2a_torch.convert_qwen3_vl.{name}"]
    config, cached = checkpoint.load_qwen3_vl(ckpt, dtype=dtype)
    assert conversions[0] == 2 and config.text.num_layers == 2
    _same(first, cold)
    _same(cached, cold)
    _, tree = jax_load(ckpt, cache_params=False)
    _same({k: v.to(dtype) for k, v in params_from_jax(tree).items()}, cached)


def test_bf16_and_f32_keep_apart_caches(ckpt, conversions):
    bf16 = checkpoint.load_qwen3_vl(ckpt)[1]
    f32 = checkpoint.load_qwen3_vl(ckpt, dtype=torch.float32)[1]
    assert conversions[0] == 2 and len(_caches(ckpt)) == 2
    _same(checkpoint.load_qwen3_vl(ckpt)[1], bf16)
    _same(checkpoint.load_qwen3_vl(ckpt, dtype=torch.float32)[1], f32)
    assert conversions[0] == 2


@pytest.mark.parametrize("change", ["size", "mtime", "swapped"])
def test_touched_weights_reconvert(tmp_path, conversions, change):
    """A weight file grown by 8 bytes (its mtime put back), touched to an
    older mtime, or replaced by other weights of the same size whose mtime
    predates the cache (as tar or rsync keep it) is converted again, and
    the load gives the files' weights."""
    path = _checkpoint(tmp_path / "ckpt")
    weights = path / "model.safetensors"
    checkpoint.load_qwen3_vl(path)
    stat = weights.stat()
    if change == "size":
        with weights.open("ab") as f:
            f.write(b"\0" * 8)
        os.utime(weights, (stat.st_atime, stat.st_mtime))
    elif change == "mtime":
        os.utime(weights, (stat.st_atime - 3600, stat.st_mtime - 3600))
    else:
        _checkpoint(tmp_path / "other", seed=4)     # its mtime predates the cache
        os.replace(tmp_path / "other" / "model.safetensors", weights)
        os.utime(weights, (stat.st_atime - 7200, stat.st_mtime - 7200))
    assert checkpoint._cache_stale(path, path / _caches(path)[0])
    got = checkpoint.load_qwen3_vl(path)[1]
    assert conversions[0] == 2
    _same(got, checkpoint.load_qwen3_vl(path, cache_params=False)[1])
    checkpoint.load_qwen3_vl(path)
    assert conversions[0] == 3          # the rewritten cache is fresh again


def test_corrupt_cache_reconverts_and_rewrites(ckpt, conversions, caplog):
    cold = checkpoint.load_qwen3_vl(ckpt)[1]
    (ckpt / _caches(ckpt)[0] / checkpoint.STATE_FILE).write_bytes(b"not a state dict")
    with caplog.at_level(logging.WARNING, logger="emr2a_tpu_torch.models.checkpoint"):
        again = checkpoint.load_qwen3_vl(ckpt)[1]
    assert conversions[0] == 2 and "unreadable" in caplog.text
    _same(again, cold)
    _same(checkpoint.load_qwen3_vl(ckpt)[1], cold)
    assert conversions[0] == 2


def test_cache_params_false_writes_nothing(ckpt):
    before = sorted(p.name for p in ckpt.iterdir())
    checkpoint.load_qwen3_vl(ckpt, cache_params=False)
    assert sorted(p.name for p in ckpt.iterdir()) == before


def test_read_only_directory_still_loads(ckpt, conversions, monkeypatch, caplog):
    """Where the directory cannot be written (chmod; as root, which writes
    through it, the store raises as a read-only file system would) the
    load converts, logs a warning and leaves no cache."""
    cold = checkpoint.load_qwen3_vl(ckpt, cache_params=False)[1]
    os.chmod(ckpt, 0o555)
    try:
        if os.access(ckpt, os.W_OK):
            def read_only(*a, **kw):
                raise PermissionError(30, "Read-only file system")
            monkeypatch.setattr(checkpoint, "_store", read_only)
        with caplog.at_level(logging.WARNING, logger="emr2a_tpu_torch.models.checkpoint"):
            got = checkpoint.load_qwen3_vl(ckpt)[1]
    finally:
        os.chmod(ckpt, 0o755)
    assert conversions[0] == 2 and "not written" in caplog.text
    _same(got, cold)
    assert not any((ckpt / c / checkpoint.STAMP_FILE).exists() for c in _caches(ckpt))


def test_failed_cache_write_still_loads(ckpt, conversions, monkeypatch, caplog):
    """``torch.save`` reports a file it cannot open or finish (a full disk)
    as ``RuntimeError``: the load still returns the converted state, logs
    a warning and leaves no stamp, and the next load converts again."""
    cold = checkpoint.load_qwen3_vl(ckpt, cache_params=False)[1]
    save = torch.save

    def full_disk(obj, f, *a, **kw):
        open(f, "wb").write(b"PK")
        raise RuntimeError("[enforce fail at inline_container.cc:778] . PytorchStreamWriter "
                           "failed writing file data/0: file write failed")

    monkeypatch.setattr(torch, "save", full_disk)
    with caplog.at_level(logging.WARNING, logger="emr2a_tpu_torch.models.checkpoint"):
        got = checkpoint.load_qwen3_vl(ckpt)[1]
    assert conversions[0] == 2 and "not written" in caplog.text
    _same(got, cold)
    assert not any((ckpt / c / checkpoint.STAMP_FILE).exists() for c in _caches(ckpt))
    assert not any(p.name.endswith(".tmp") for c in _caches(ckpt) for p in (ckpt / c).iterdir())
    monkeypatch.setattr(torch, "save", save)
    _same(checkpoint.load_qwen3_vl(ckpt)[1], cold)
    assert conversions[0] == 3
    assert all((ckpt / c / checkpoint.STAMP_FILE).exists() for c in _caches(ckpt))


def test_entry_points_take_cache_params(tmp_path, monkeypatch):
    """``QwenVLBackend`` (target and draft) and ``Qwen3VLEncoder`` load
    through the cache where asked and write nothing where not;
    ``bringup_qwen3_vl``'s CLI passes ``--no-cache`` on."""
    from emr2a_tpu_torch.encoders.qwen3_vl_encoder import Qwen3VLEncoder, make_image_processor
    from emr2a_tpu_torch.judge.qwen_backend import QwenVLBackend

    target, draft = _checkpoint(tmp_path / "target"), _checkpoint(tmp_path / "draft", seed=5)
    QwenVLBackend(str(target), device="cpu", tokenizer=WordTokenizer(),
                  draft_model_path=str(draft), cache_params=False)
    Qwen3VLEncoder(model_path=str(target), device="cpu", tokenizer=WordTokenizer(),
                   image_processor=make_image_processor(CONFIG.vision), cache_params=False)
    assert _caches(target) == _caches(draft) == []
    backend = QwenVLBackend(str(target), device="cpu", tokenizer=WordTokenizer(),
                            draft_model_path=str(draft))
    assert len(_caches(target)) == len(_caches(draft)) == 1
    enc = Qwen3VLEncoder(model_path=str(target), device="cpu", tokenizer=WordTokenizer(),
                         image_processor=make_image_processor(CONFIG.vision))
    _same(enc.model.state_dict(), pq.Qwen3VLModel.from_params(
        CONFIG, checkpoint.load_qwen3_vl(target, cache_params=False)[1]).state_dict())
    assert backend.spec_generator is not None
    seen = []
    monkeypatch.setattr(convert, "bringup_qwen3_vl",
                        lambda path, **kw: seen.append(kw["cache_params"]) or {})
    convert._main(["--qwen3-vl", str(target), "--no-cache"])
    convert._main(["--qwen3-vl", str(target)])
    assert seen == [False, True]


def test_bringup_twice_cold_then_cached(ckpt, conversions):
    """The bring-up's second run reads the cache and generates the same
    text (greedy, the same weights)."""
    kw = dict(max_new_tokens=4, tokenizer=WordTokenizer(), image_size=32, device="cpu")
    cold = convert.bringup_qwen3_vl(ckpt, **kw)
    cached = convert.bringup_qwen3_vl(ckpt, **kw)
    assert conversions[0] == 1
    assert cold["generated"] == cached["generated"] and cold["text_dim"] == cached["text_dim"]
    assert np.isfinite(cached["load_convert_s"])
