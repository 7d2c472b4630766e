"""The port's JSONL judge service (``emr2a_tpu_torch.judge.serve``) against
the JAX package's (``emr2a_tpu.judge.serve``), the JAX suite's two cases run
through both CLIs, each with its own ``FakeVLMBackend``: the response files
are equal line for line (the wave's wall time ``wave_s`` aside) and so are
the backends' recorded ``stream_calls``."""

import json
import threading
import time

import numpy as np
from PIL import Image

from emr2a_tpu.judge.backends import FakeVLMBackend as JaxFakeBackend
from emr2a_tpu.judge.serve import main as jax_main
from emr2a_tpu.judge.serve import run as jax_run
from emr2a_tpu_torch.judge.backends import FakeVLMBackend
from emr2a_tpu_torch.judge.serve import build_parser, main, run


def responses(path):
    lines = [json.loads(line) for line in path.read_text(encoding="utf-8").splitlines()]
    for line in lines:
        assert isinstance(line.pop("wave_s"), float)
    return lines


def test_serve_one_shot_equals_jax(tmp_path):
    """An invalid line, a request without a prompt and one whose image is
    missing get error lines; the two loadable requests stream as one wave
    with their per-request temperatures."""
    img = tmp_path / "a.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(img)
    rows = [json.dumps({"id": "a", "prompt": "p1", "images": [str(img)]}),
            "not json at all {",
            json.dumps({"id": "b", "prompt": "p2", "temperature": 0.7, "seed": 3}),
            json.dumps({"id": "c", "images": [str(img)]}),
            json.dumps({"id": "d", "prompt": "p3", "images": [str(tmp_path / "nope.png")]})]
    inp = tmp_path / "in.jsonl"
    inp.write_text("\n".join(rows) + "\n")
    out = {}
    for name, cli, backend in (("jax", jax_main, JaxFakeBackend(script=["OUT1", "OUT2"])),
                               ("port", main, FakeVLMBackend(script=["OUT1", "OUT2"]))):
        out[name] = (tmp_path / f"{name}.jsonl", backend)
        cli(["--model_path", "fake", "--input", str(inp), "--output", str(out[name][0])],
            backend=backend)
    got, want = responses(out["port"][0]), responses(out["jax"][0])
    assert got == want and len(got) == 5
    by_id = {line["id"]: line for line in got}
    assert by_id["a"]["output"] == "OUT1" and by_id["b"]["output"] == "OUT2"
    assert "prompt" in by_id["c"]["error"] and "not found" in by_id["d"]["error"]
    assert out["port"][1].stream_calls == out["jax"][1].stream_calls == [
        {"n": 2, "n_slots": 8, "temperatures": [0.0, 0.7]}]
    assert build_parser().parse_args(["--model_path", "m", "--input", "i",
                                      "--output", "o"]).device == "cuda"


def test_serve_follow_waves_equal_jax(tmp_path):
    """--follow tails the input: a wave appended after the first was served
    is served on its own, and a shutdown line ends the loop."""
    out = {}
    for name, serve, backend in (("jax", jax_run, JaxFakeBackend(script=["A", "B"])),
                                 ("port", run, FakeVLMBackend(script=["A", "B"]))):
        inp, res = tmp_path / f"{name}_in.jsonl", tmp_path / f"{name}_out.jsonl"
        inp.write_text(json.dumps({"id": "w1", "prompt": "x"}) + "\n")

        def later(inp=inp, res=res):
            deadline = time.time() + 60
            while time.time() < deadline and not (res.exists() and "w1" in res.read_text()):
                time.sleep(0.05)
            with inp.open("a", encoding="utf-8") as f:
                f.write(json.dumps({"id": "w2", "prompt": "y"}) + "\n")
                f.write(json.dumps({"cmd": "shutdown"}) + "\n")

        writer = threading.Thread(target=later)
        writer.start()
        assert serve(inp, res, backend, follow=True, poll=0.05) == 2
        writer.join()
        out[name] = (responses(res), backend.stream_calls)
    assert out["port"] == out["jax"]
    assert [line["output"] for line in out["port"][0]] == ["A", "B"]
    assert len(out["port"][1]) == 2
