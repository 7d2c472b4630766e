"""Step 2 -- embedding generation on the GPU.

Port of ``emr2a_tpu/pipelines/step2_embeddings/build_embeddings.py`` with
the same CLI and artifacts: ``embeddings.npz`` keyed by patient_id with one
slice-embedding matrix per patient, and ``embeddings_meta.json``
{num_patients, patients, embedding_dim}. Failed patients are logged and
skipped. Every ``--encoder_type`` builds through ``encoders.create_encoder``
as in JAX: ``vit`` (timm ViT-B/16) and ``dino`` (DINOv3 ViT-L/16) take
random weights without ``--model_path``; ``clip``, ``biomedclip`` and the
Qwen types need one. Differences: ``--device`` defaults to ``cuda``;
``--fast`` is the bf16 tower, whose blocks run the hand-written CUDA kernels
(K1, K3) where the reference's rule admits them (ViT, BioMedCLIP, CLIP
ViT-B; DINOv3 is the dtype cut), and ``--fast int8`` the W8A8 tower (K2, K4;
DINOv3's projections on K5); the Qwen types refuse ``--fast``, as in JAX;
``--data_parallel`` encodes over ``parallel.default_mesh()`` (every visible
card on the ``data`` axis: each batch split across the cards, the tower
replicated on each) and logs its size, or, with ``--device cpu``, over a
one-device CPU mesh; the Qwen types refuse it, as in JAX, and the fake
encoder ignores it. The JAX compile-cache flag is gone (eager PyTorch has
no compile step to cache).

    python -m emr2a_tpu_torch.pipelines.step2_embeddings.run \\
        --encoder_type vit --fast int8 --device cuda
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict, List

import numpy as np

from emr2a_tpu_torch.data.manifest import load_manifest
from emr2a_tpu_torch.encoders import create_encoder

logger = logging.getLogger(__name__)

ENCODER_CHOICES = ["vit", "qwen3_vl", "qwen3_vl_8b", "qwen3_vl_2b",
                   "biomedclip", "clip", "dino", "fake"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Build embeddings database from manifest")
    parser.add_argument("--manifest_path", default="outputs/manifest.jsonl")
    parser.add_argument("--encoder_type", default="vit",
                        choices=ENCODER_CHOICES)
    parser.add_argument("--model_path", default=None)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--output_dir", default="outputs/features")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard image batches over all devices "
                             "(mesh data axis)")
    parser.add_argument("--fast", nargs="?", const="bf16", default=None,
                        choices=["bf16", "int8"],
                        help="'--fast' = bf16 tower on the fused CUDA "
                             "kernels (vit, biomedclip, clip; dino: bf16); "
                             "'--fast int8' = W8A8 "
                             "tower on the int8 kernels")
    return parser


def load_images(manifest: List[Dict], image_root: Path) -> Dict[str, List[Path]]:
    return {rec["patient_id"]: [Path(s) for s in rec.get("slices", [])]
            for rec in manifest
            if rec.get("patient_id") and rec.get("slices")}


def encode_images(encoder, image_paths: Dict[str, List[Path]],
                  batch_size: int) -> Dict[str, np.ndarray]:
    embeddings = {}
    for patient_id, paths in image_paths.items():
        try:
            chunks = []
            for i in range(0, len(paths), batch_size):
                emb = encoder.encode_images(paths[i:i + batch_size])
                if emb.size:
                    chunks.append(emb)
            if chunks:
                embeddings[patient_id] = np.concatenate(chunks, axis=0)
        except Exception:
            # one patient's failure must not stop the cohort
            logger.exception("Failed to encode images for patient %s",
                             patient_id)
    return embeddings


def save_embeddings(embeddings: Dict[str, np.ndarray], output_dir: Path) -> None:
    output_dir.mkdir(parents=True, exist_ok=True)
    npz_path = output_dir / "embeddings.npz"
    np.savez_compressed(npz_path, **embeddings)
    logger.info("Saved embeddings to %s", npz_path)

    meta = {
        "num_patients": len(embeddings),
        "patients": list(embeddings.keys()),
        "embedding_dim": (next(iter(embeddings.values())).shape[-1]
                          if embeddings else 0),
    }
    with (output_dir / "embeddings_meta.json").open("w", encoding="utf-8") as f:
        json.dump(meta, f, ensure_ascii=False, indent=2)
    logger.info("Saved metadata to %s", output_dir / "embeddings_meta.json")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)

    logger.info("Loading manifest from %s", args.manifest_path)
    manifest = load_manifest(args.manifest_path)
    logger.info("Loaded %d records from manifest", len(manifest))

    encoder_kwargs = {}
    if args.data_parallel:
        from emr2a_tpu_torch.parallel.mesh import create_mesh, default_mesh
        encoder_kwargs["mesh"] = (create_mesh((1, 1), devices=["cpu"])
                                  if args.device == "cpu" else default_mesh())
        logger.info("Data-parallel encoding over %d devices",
                    encoder_kwargs["mesh"].size)
    if args.fast:
        encoder_kwargs["fast"] = "int8" if args.fast == "int8" else True
    encoder = create_encoder(
        encoder_type=args.encoder_type, device=args.device,
        model_path=args.model_path, **encoder_kwargs)

    # manifests hold absolute slice paths (step1 --relative_paths false)
    image_paths = load_images(manifest, Path("."))
    logger.info("Found images for %d patients", len(image_paths))

    embeddings = encode_images(encoder, image_paths, args.batch_size)
    logger.info("Generated embeddings for %d patients", len(embeddings))

    save_embeddings(embeddings, Path(args.output_dir))


if __name__ == "__main__":
    main()
