"""Step2 end to end on a synthetic CT cohort: manifest -> embeddings.npz.

The port's counterpart of ``scripts/exp_step2_e2e.py``: the whole of step2,
host decode included, on 512x512 grey PNG slices (``tools/cohort.py``,
``--patients`` x ``--slices``), with BioMedCLIP at full width and random
weights (throughput does not depend on them): ``--precision bf16`` runs the
image tower's blocks on K1 and K3, ``int8`` on K2 and K4. The encoder's
``assume_square_sources`` is set (CT slices are square), so step2's
``encode_images`` decodes on the C++ pool (``data/native_loader.py``).
As in the JAX script, ``max_batch`` is ``--batch_size``: each step2 call
is one pool chunk, and no decode overlaps the device. (``measure`` with a
batch_size above the encoder's ``max_batch`` gives calls of several
chunks, each decoded while the card runs the one before.) ``--no_pool``
leaves the flag unset, so the shortest-edge spec decodes per image on the
host (cv2) and the two runs
differ only in the decoder. The JAX script has no ``--no_pool``: it is a
measuring switch of this tool. ``--text`` also embeds one clinical text per
patient on the PubMedBERT-256 tower (a crc32 word tokenizer, as the JAX
script's). ``--keep DIR`` writes the cohort there, or reuses the one there.

Prints one JSON line: ``end_to_end_slices_per_s`` (encode + save) and
``embed_slices_per_s`` (encode), with the counts and seconds behind them.

    python -m emr2a_tpu_torch.tools.step2_e2e --precision bf16 [--no_pool]
    python -m emr2a_tpu_torch.tools.step2_e2e --device cpu --patients 1 --slices 4
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np


class ToyBertTokenizer:
    """A weight-free stand-in with the HF call signature: crc32 word ids
    padded to ``max_length`` (a real tokenizer changes the ids, not the
    tower's throughput)."""

    def __call__(self, texts, padding="max_length", max_length=256,
                 truncation=True, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            toks = [101] + [zlib.crc32(w.encode()) % 30000 + 103
                            for w in t.split()][:max_length - 2] + [102]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _sync(device: str) -> None:
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def measure(encoder, image_paths: dict, out_dir: Path, batch_size: int,
            pool: bool = True) -> dict:
    """step2's ``encode_images`` + ``save_embeddings`` over ``image_paths``
    (patient -> slice paths) with ``encoder``, after one warm-up batch; the
    decode pool on (``assume_square_sources``) or off. The encoder's flag is
    restored afterwards."""
    from emr2a_tpu_torch.data import native_loader
    from emr2a_tpu_torch.pipelines.step2_embeddings.build_embeddings import (
        encode_images,
        save_embeddings,
    )

    old = encoder.assume_square_sources
    encoder.assume_square_sources = pool
    try:
        first = next(iter(image_paths.values()))
        encoder.encode_images(first[:batch_size])
        n_slices = sum(len(v) for v in image_paths.values())
        _sync(encoder.device)
        batches = native_loader.POOL_BATCHES
        t0 = time.perf_counter()
        embs = encode_images(encoder, image_paths, batch_size)
        _sync(encoder.device)
        t_embed = time.perf_counter() - t0
        pool_batches = native_loader.POOL_BATCHES - batches
        t0 = time.perf_counter()
        save_embeddings(embs, Path(out_dir))
        t_save = time.perf_counter() - t0
    finally:
        encoder.assume_square_sources = old
    done = sum(v.shape[0] for v in embs.values())
    return {"slices": n_slices, "encoded": done, "pool": pool,
            "pool_batches": pool_batches, "batch_size": batch_size,
            "embed_s": t_embed, "save_s": t_save,
            "end_to_end_slices_per_s": done / (t_embed + t_save),
            "embed_slices_per_s": done / t_embed}


def measure_text(encoder, manifest: list) -> dict:
    """One clinical text per patient through the text tower, timed after a
    warm-up call."""
    texts = [f"patient {r['patient_id']} chest CT ground glass opacity "
             f"bilateral infiltrate severity {p % 5}" for p, r in enumerate(manifest)]
    encoder.encode_batch_texts(texts)
    _sync(encoder.device)
    t0 = time.perf_counter()
    embs = encoder.encode_batch_texts(texts)
    _sync(encoder.device)
    t_text = time.perf_counter() - t0
    ok = sum(1 for t in embs if t is not None)
    return {"texts": ok, "text_s": t_text, "texts_per_s": ok / t_text}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--patients", type=int, default=8)
    ap.add_argument("--slices", type=int, default=192)
    ap.add_argument("--batch_size", type=int, default=96)
    ap.add_argument("--precision", default="int8", choices=["int8", "bf16"])
    ap.add_argument("--text", action="store_true",
                    help="also embed one clinical text per patient")
    ap.add_argument("--keep", default=None,
                    help="write the cohort here, or reuse the one here")
    ap.add_argument("--no_pool", action="store_true",
                    help="decode per image on the host instead of the C++ pool")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    from emr2a_tpu_torch.data.manifest import load_manifest
    from emr2a_tpu_torch.encoders.biomedclip_encoder import BioMedCLIPEncoder
    from emr2a_tpu_torch.tools.cohort import write_cohort

    args = build_parser().parse_args(argv)
    root = Path(args.keep) if args.keep else Path(tempfile.mkdtemp(prefix="step2e2e_"))
    mpath = root / "manifest.jsonl"
    if not mpath.exists():
        t0 = time.perf_counter()
        root.mkdir(parents=True, exist_ok=True)
        mpath = write_cohort(root, n_patients=args.patients, n_slices=args.slices)
        print(f"cohort: {args.patients}x{args.slices} 512^2 PNGs in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    manifest = load_manifest(mpath)
    encoder = BioMedCLIPEncoder.random_init(
        fast="int8" if args.precision == "int8" else True, device=args.device,
        max_batch=args.batch_size, tokenizer=ToyBertTokenizer() if args.text else None)
    image_paths = {r["patient_id"]: r["slices"] for r in manifest}
    result = {"precision": args.precision,
              **measure(encoder, image_paths, root / "out", args.batch_size,
                        pool=not args.no_pool)}
    if args.text:
        result.update(measure_text(encoder, manifest))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
