"""The port's Qwen3-VL bring-up (``models/convert.bringup_qwen3_vl`` and
its ``--qwen3-vl`` CLI) against the JAX package's, on the CPU: a tiny
Qwen3-VL checkpoint directory written by ``tools/qwen_checkpoint`` (HF
names, bf16 as loaded), the stub word tokenizer injected in both. The
summaries have the same keys and dimensions, the embeddings are finite,
text is generated, and the stub tokenizer's honest round-trip answer is
reported (not raised: it is not the checkpoint's own)."""

import numpy as np
import pytest

from emr2a_tpu.models.convert import bringup_qwen3_vl as jax_bringup
from emr2a_tpu_torch.models import convert
from emr2a_tpu_torch.models import qwen3_vl as pq
from emr2a_tpu_torch.tools.qwen_checkpoint import write_checkpoint
from emr2a_tpu_torch.tools.stub_tokenizer import WordTokenizer

CONFIG = pq.Qwen3VLConfig(
    vision=pq.QwenVisionConfig(depth=3, hidden_size=32, intermediate_size=64, num_heads=2,
                               patch_size=4, out_hidden_size=32,
                               num_position_embeddings=64, deepstack_visual_indexes=(1,)),
    text=pq.QwenTextConfig(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                           head_dim=8, intermediate_size=64, mrope_section=(2, 1, 1)))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("qwen") / "ckpt"
    return write_checkpoint(path, CONFIG, pq.random_state(CONFIG, seed=3, device="cpu"))


def test_bringup_matches_jax_summary(checkpoint):
    ours = convert.bringup_qwen3_vl(checkpoint, max_new_tokens=4, tokenizer=WordTokenizer(),
                                    image_size=32, device="cpu")
    theirs = jax_bringup(checkpoint, max_new_tokens=4, tokenizer=WordTokenizer(),
                         image_size=32, cache_params=False)
    assert sorted(ours) == sorted(theirs)
    assert ours["model_path"] == theirs["model_path"] == str(checkpoint)
    assert ours["image_tap_dim"] == theirs["image_tap_dim"] == 32
    assert ours["text_dim"] == theirs["text_dim"] == 32
    assert isinstance(ours["generated"], str) and ours["generated"].strip()
    assert ours["tokenizer_roundtrip_ok"] == theirs["tokenizer_roundtrip_ok"]
    for key in ("load_convert_s", "image_tap_s", "text_s", "generate_s"):
        assert np.isfinite(ours[key]) and ours[key] >= 0


def test_bringup_cli(checkpoint, monkeypatch, capsys):
    import json

    from emr2a_tpu_torch.judge import qwen_backend

    init = qwen_backend.QwenVLBackend.__init__

    def with_stub(self, *args, **kw):      # no tokenizer files in the directory
        init(self, *args, **{**kw, "tokenizer": WordTokenizer()})

    monkeypatch.setattr(qwen_backend.QwenVLBackend, "__init__", with_stub)
    with pytest.raises(AssertionError, match="round-trip"):
        # the stub is not reversible, and here it poses as the checkpoint's own
        convert._main(["--qwen3-vl", str(checkpoint), "--max-new-tokens", "2",
                       "--image-size", "32", "--device", "cpu"])
    with pytest.raises(SystemExit):
        convert._main([])
    monkeypatch.setattr(convert, "bringup_qwen3_vl",
                        lambda path, **kw: {"model_path": path, **kw})
    convert._main(["--qwen3-vl", "d", "--max-new-tokens", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"model_path": "d", "max_new_tokens": 3, "image_size": 128,
                   "device": "cuda"}
