"""The port's sharded database over several OS processes (gloo on the CPU)
against the JAX package, as tests/test_multiprocess_dcn.py runs JAX's.

JAX's two-process worker case (16 x 8, ``n_total`` 14, k 5, the masked
capacity tail) runs in the port's ``tools/db_processes.py --case jax``
against numpy: indices exact, values within rtol 1e-5. Then two and four
processes of ``tools/db_processes.py --case cases``, one CPU device
each, run every case of its ``CASES`` (k above the shard size, a short last
shard, an empty one, ``add_cases`` within and past capacity with save and
load, ``search``) in f32, bf16 and int8; each answer is held against the
JAX package's ``ShardedEmbeddingDatabase`` on a CPU mesh of as many
devices (the tolerances of tests/test_torch_sharded_database.py: f32 and
int8 indices exact and values within 1e-6, bf16 the top-1 neighbour and
values within 1e-2), bit for bit against the port's one-device database,
and every rank's answer against rank 0's. The mesh's own rules across
processes run in the workers and, with the process queries patched, here.
Every subprocess has a 120 s limit.
"""

import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emr2a_tpu.parallel import mesh as jax_mesh
from emr2a_tpu.retrieval import database as jax_db
from emr2a_tpu_torch.parallel import Mesh, mesh as port_mesh
from emr2a_tpu_torch.parallel.launch import WorkerFailed, launch
from emr2a_tpu_torch.retrieval import database as port_db
from emr2a_tpu_torch.tools.db_processes import CASES

REPO = Path(__file__).resolve().parent.parent
WORKER = ["-m", "emr2a_tpu_torch.tools.db_processes"]

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
ENV.pop("XLA_FLAGS", None)


def test_jax_worker_case_matches_numpy():
    """JAX's worker shapes on two port processes: each hands over its slab
    alone (shard_topk, pack, all-gather, merge), then the same through
    ``ShardedEmbeddingDatabase``; both against numpy inside the workers."""
    out = launch([*WORKER, "--case", "jax"], 2, timeout=120, env=ENV, cwd=str(REPO))
    for pid in range(2):
        assert f"p{pid}: sharded retrieval over processes OK" in out, out
    assert "backend gloo, 2 processes" in out


def test_a_failed_rank_fails_the_launch(tmp_path):
    """A rank that dies fails the launch with its output, and the rank left
    waiting is stopped, not waited for."""
    script = tmp_path / "rank.py"
    script.write_text("import os, sys, time\nprint('rank up', flush=True)\n"
                      "sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(WorkerFailed, match=r"(?s)rank up.*exitcode\s*:\s*3") as e:
        launch([str(script)], 2, timeout=60, env=ENV)
    assert "torchrun exited with code" in str(e.value)
    assert time.monotonic() - t0 < 50


def test_the_launch_timeout_stops_every_rank(tmp_path):
    """Ranks that outlive ``timeout`` fail the launch and are stopped."""
    script = tmp_path / "rank.py"
    script.write_text(f"import os, time\nopen(os.path.join({str(tmp_path)!r}, "
                      "'pid' + os.environ['RANK']), 'w').write(str(os.getpid()))\n"
                      "time.sleep(300)\n")
    with pytest.raises(WorkerFailed, match="did not end within 20 s"):
        launch([str(script)], 2, timeout=20, env=ENV)
    for rank in range(2):
        pid = int((tmp_path / f"pid{rank}").read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.fixture(scope="module", params=[2, 4], ids=["2proc", "4proc"])
def ranks(request, tmp_path_factory):
    """Every rank's answers for ``request.param`` processes."""
    out = tmp_path_factory.mktemp(f"procs{request.param}")
    text = launch([*WORKER, "--case", "cases", "--dir", str(out)], request.param,
                  timeout=120, env=ENV, cwd=str(REPO))
    for r in range(request.param):
        assert f"rank {r}: done" in text and f"rank {r}: mesh checks OK" in text, text
    return request.param, [dict(np.load(out / f"rank{r}.npz")) for r in range(request.param)]


def _jax_mesh(n):
    return jax_mesh.create_mesh((n, 1), devices=jax.devices()[:n])


def _same(jres, got, dtype):
    jv, ji = np.asarray(jres[0], np.float32), np.asarray(jres[1])
    tv, ti = got
    assert ti.dtype == np.int32 and tv.dtype == np.float32
    if dtype == "bf16":
        np.testing.assert_array_equal(ti[:, 0], ji[:, 0])
        np.testing.assert_allclose(tv, jv, atol=1e-2)
    else:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)


def _bitwise(got, want):
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].numpy().view(np.int32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_processes_match_jax(ranks, case, dtype):
    n, answers = ranks
    res = answers[0]
    for other in answers[1:]:                   # every rank holds the same answer
        for key in (k for k in res if k.startswith(f"{case}/{dtype}/")):
            np.testing.assert_array_equal(other[key], res[key])
    key = f"{case}/{dtype}"
    emb, queries = res[f"{key}/emb"], res[f"{key}/queries"]
    rows, _, _, ks, capacity = CASES[case]
    jdt, tdt = DTYPES[dtype]
    meta = {}
    if case in ("search", "add_past_capacity"):
        meta = dict(labels=[f"L{i % 4}" for i in range(rows)], ids=[f"p{i:03d}" for i in range(rows)])
    jdb = jax_db.ShardedEmbeddingDatabase(emb, mesh=_jax_mesh(n), dtype=jdt, capacity=capacity,
                                          **meta)
    one = port_db.ShardedEmbeddingDatabase(emb, device="cpu", dtype=tdt, capacity=capacity,
                                           **meta)
    for k in ks:
        got = res[f"{key}/k{k}/vals"], res[f"{key}/k{k}/idx"]
        assert got[1].min() >= 0
        _same(jdb.topk(queries, k), got, dtype)
        _bitwise(got, one.topk(queries, k))
    if case == "add_past_capacity":
        for step in (0, 1):
            extra = res[f"{key}/extra{step}"]
            labels, ids = ["LX"] * len(extra), [f"x{step}_{i}" for i in range(len(extra))]
            jdb.add_cases(extra, labels=labels, ids=ids)
            one.add_cases(extra, labels=labels, ids=ids)
            got = res[f"{key}/add{step}/vals"], res[f"{key}/add{step}/idx"]
            _same(jdb.topk(queries, 5), got, dtype)
            _bitwise(got, one.topk(queries, 5))
        assert int(res[f"{key}/capacity"]) == jdb.capacity == 40
        _bitwise((res[f"{key}/loaded/vals"], res[f"{key}/loaded/idx"]), one.topk(queries, 5))
    if case == "search":
        want = jdb.search(queries, k=3)
        got = [[s.split("|") for s in q] for q in res[f"{key}/search"]]
        if dtype == "bf16":
            assert [q[0] for q in got] == [[str(w[0]["index"]), w[0]["label"], w[0]["patient_id"]]
                                           for w in want]
        else:
            assert got == [[[str(h["index"]), h["label"], h["patient_id"]] for h in w]
                           for w in want]
        np.testing.assert_allclose(res[f"{key}/search_scores"],
                                   [[h["score"] for h in w] for w in want],
                                   atol=1e-2 if dtype == "bf16" else 1e-6)


@pytest.fixture()
def three_processes(monkeypatch):
    """This process as rank 0 of 3, without a process group."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 3)
    assert (port_mesh.process_index(), port_mesh.process_count()) == (0, 3)


def test_cuda0_of_two_processes_are_distinct(three_processes):
    """(process, cuda:0) is a device's identity: two other processes' cuda:0
    make a mesh (neither is this process's, so neither must be visible
    here), one process's cuda:0 twice does not, and a process outside the
    group is refused."""
    mesh = Mesh(np.array(["cuda:0", "cuda:0"], dtype=object), ("data",), processes=[1, 2])
    assert not mesh.is_local and mesh.processes.tolist() == [1, 2]
    assert "process 1: cuda:0" in repr(mesh) and "process 2: cuda:0" in repr(mesh)
    with pytest.raises(ValueError, match="may appear once"):
        Mesh(np.array(["cuda:0", "cuda:0"], dtype=object), ("data",), processes=[2, 2])
    with pytest.raises(ValueError, match="outside the 3 process"):
        Mesh(np.array(["cuda:0"], dtype=object), ("data",), processes=[3])
    with pytest.raises(ValueError, match="processes has shape"):
        Mesh(np.array(["cpu", "cpu"], dtype=object), ("data",), processes=[0])


def test_spanning_mesh_refuses_other_processes_data(three_processes):
    """Every helper that would place or read a device's data raises for a
    device of another process; the database takes only its own shards."""
    from emr2a_tpu_torch.parallel import (
        check_mesh, create_mesh, data_devices, local_shards, replicated, shard_batch,
        shard_owners)

    mesh = create_mesh((3, 1), devices=["cpu"] * 3, processes=[0, 1, 2])
    assert shard_owners(mesh) == [(p, torch.device("cpu")) for p in range(3)]
    assert local_shards(mesh) == [0]
    for fn in (lambda: data_devices(mesh), lambda: shard_batch(torch.zeros(3, 2), mesh),
               lambda: replicated(torch.zeros(2), mesh), lambda: check_mesh(mesh)):
        with pytest.raises(ValueError, match=r"process 1: cpu.*belong to others"):
            fn()
    uneven = create_mesh((3, 1), devices=["cpu"] * 3, processes=[0, 0, 1])
    with pytest.raises(ValueError, match="the same number of shards in each"):
        port_db.ShardedEmbeddingDatabase(np.ones((6, 4), np.float32), mesh=uneven)
