"""The port's decode pool against the JAX package's on damaged files: each
of ``--files`` files is one of ``tests/test_torch_native_loader.py``'s
PNG and JPEG cases with one to four random edits (a flipped bit, a random
byte, a cut, an inserted ``FF xx`` marker, a run of random bytes), decoded
by both pools at 24 x 31 and 37 x 45. Prints one JSON line with the count
of files whose rows or ``ok`` masks differ; each such file is kept under
``--out``. Needs the JAX package's pool (libpng, libjpeg) built.

Run from the repository's root (about a minute for 10,000 files):

    JAX_PLATFORMS=cpu python -m tests.pool_mutation_witness --files 10000 --seed 1 --out DIR
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from emr2a_tpu.data import native_loader as jax_loader
from emr2a_tpu_torch.data import native_loader as loader
from tests import test_torch_native_loader as cases

SIZES = ((24, 31), (37, 45))


def mutate(data: bytearray, rng) -> bytearray:
    for _ in range(rng.randint(1, 5)):
        kind, pos = rng.randint(5), rng.randint(len(data))
        if kind == 0:
            data[pos] ^= 1 << rng.randint(8)
        elif kind == 1:
            data[pos] = rng.randint(256)
        elif kind == 2:
            data = data[:max(4, pos)]
        elif kind == 3:
            data[pos:pos] = bytes([0xFF, rng.randint(256)])
        else:
            data[pos:pos + rng.randint(1, 16)] = bytes(rng.randint(0, 256, rng.randint(1, 16))
                                                       .astype(np.uint8))
    return data


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--files", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not jax_loader.native_available():
        raise SystemExit("the JAX package's decode pool cannot build here")
    root = Path(args.out)
    bases = []
    for name, make in sorted({**cases.PNG_CASES, **cases.JPEG_CASES}.items()):
        (root / name).mkdir(parents=True, exist_ok=True)
        bases.append(make(root / name).read_bytes())
    rng = np.random.RandomState(args.seed)
    differ = []
    for i in range(args.files):
        data = bytes(mutate(bytearray(bases[rng.randint(len(bases))]), rng))
        path = root / "mutated.bin"
        path.write_bytes(data)
        for size in SIZES:
            want, want_ok = jax_loader.decode_batch([path], *size, n_threads=1)
            got, got_ok = loader.decode_batch([path], *size, n_threads=1)
            if got_ok.tolist() != want_ok.tolist() or not np.array_equal(got, want):
                keep = root / f"differs_{i}.bin"
                keep.write_bytes(data)
                differ.append(str(keep))
                break
    result = {"files": args.files, "seed": args.seed, "bases": len(bases),
              "differ": len(differ), "kept": differ[:20]}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
