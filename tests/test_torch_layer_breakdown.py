"""The port's layer-breakdown entry point (``tools/layer_breakdown.py``,
port of ``scripts/exp_layer_breakdown.py``) on the CPU at batch 2, one
iteration: each mode runs, prints the script's ms/iter line and routes its
blocks as the script does (K3m for ``tune --merge_batch``, K3 for
``tune``, K4 and K2 for ``int8block``). On the CPU the wrappers take their
plain versions and count no launch; the routing is seen by recording the
calls of the ops the tool imports."""

import pytest
import torch

from emr2a_tpu_torch.ops import attention_block, mlp
from emr2a_tpu_torch.tools import layer_breakdown


def _record(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append((name, {k: v for k, v in kw.items() if k in (
            "merge_batch", "block_b", "head_group", "act_dtype", "tile",
            "activation", "valid_len")}))
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, wrapped)


@pytest.fixture()
def calls(monkeypatch):
    calls = []
    for module, names in ((attention_block, ("fused_ln_attention",
                                             "fused_ln_attention_int8")),
                          (mlp, ("fused_ln_mlp", "fused_ln_mlp_int8"))):
        for name in names:
            _record(monkeypatch, module, name, calls)
    return calls


@pytest.mark.parametrize("merge", [False, True])
def test_tune_routes_k3_or_k3m_with_k1(calls, capsys, merge):
    argv = ["--device", "cpu", "--what", "tune", "--batch", "2", "--iters", "1",
            "--block_b", "3", "--head_group", "4", "--tile", "128", "--act_bf16"]
    results = layer_breakdown.main(argv + (["--merge_batch"] if merge else []))
    (tag, res), = results.items()
    assert tag == f"block bb=3 hg=4 tile=128 merge={merge} act=gelu/bf16"
    assert res["calls"] == 1 + layer_breakdown.REPEATS and res["ms"] > 0
    assert f"{tag:42s}" in capsys.readouterr().out
    names = [c[0] for c in calls]
    assert names == ["fused_ln_attention", "fused_ln_mlp"] * res["calls"]
    attn_kw, mlp_kw = calls[0][1], calls[1][1]
    assert attn_kw == {"merge_batch": merge, "block_b": 3, "head_group": 4,
                       "valid_len": 197}
    assert mlp_kw == {"act_dtype": torch.bfloat16, "tile": 128,
                      "activation": "gelu"}
    assert attention_block.MERGED_LAUNCHES == attention_block.LAUNCHES == 0


def test_int8block_routes_k4_and_k2(calls):
    results = layer_breakdown.main(["--device", "cpu", "--what", "int8block",
                                    "--act_bf16", "--batch", "2", "--iters", "1"])
    (tag, res), = results.items()
    assert tag == "int8 block bb=4 hg=6 tile=256 act=bf16"
    assert [c[0] for c in calls] == ["fused_ln_attention_int8",
                                     "fused_ln_mlp_int8"] * res["calls"]
    assert calls[0][1] == {"block_b": 4, "head_group": 6, "valid_len": 197}
    assert calls[1][1]["act_dtype"] == torch.bfloat16


def test_tune_int8_takes_the_int8_block(calls):
    results = layer_breakdown.main(["--device", "cpu", "--what", "tune", "--int8",
                                    "--batch", "1", "--iters", "1"])
    assert list(results) == ["int8 block bb=4 hg=6 tile=256"]
    assert calls[0][0] == "fused_ln_attention_int8"


def test_other_modes_run(calls, capsys):
    results = layer_breakdown.main(
        ["--device", "cpu", "--what", "attn,mlp,stem,rest", "--batch", "1",
         "--iters", "1"])
    assert list(results) == ["fused_ln_attention/layer",
                             "fused_ln_mlp/layer (T=197)",
                             "stem+pool (0-layer tower, batch 1)",
                             "preprocess only (batch 1)", "preprocess only"]
    assert ("fused_ln_attention", {"head_group": 6, "block_b": 4}) in calls
    out = capsys.readouterr().out
    assert "ms/iter" in out and "device: cpu" in out


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        layer_breakdown.main(["--what", "tune", "--batch", "1"])
