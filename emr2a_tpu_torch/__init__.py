"""emr2a_tpu_torch -- the PyTorch and CUDA port of ``emr2a_tpu``.

The JAX package beside it is the reference this port is tested against.
This package imports PyTorch and never JAX, nor any module of the JAX
package. It carries the main path's step2 and retrieval halves:
BioMedCLIP's two towers (the ViT-B/16 image tower, whose fused
LN+attention and LN+MLP blocks run on kernels written by hand for Hopper
in bf16 (``fast=True``) and W8A8 (``fast="int8"``), and the PubMedBERT text
tower, whose int8 projections run the streaming W8A8 kernel) and the step2
embedding CLI; the one-GPU case database, whose scan runs the fused cosine
top-k kernel, with its CLI; and the cross-validated retrieval runner. The
kernels live in ``csrc/`` and are built with ``nvcc`` for sm_90a at first
use.

    pipelines/step2_embeddings   CLI: manifest -> embeddings.npz
    analysis/run_cv_experiments  CLI: embeddings -> fold metrics.json
    retrieval/database[_cli]     CLI: the case database (build/add/query)
        eval/                    CV evaluator, metrics, votes
        encoders/                batched encode engine, BioMedCLIP, fake
            models/              ViT, BERT, BioMedCLIP towers, converters,
                                 W8A8 quantizer
                ops/             kernels' wrappers, quantize, preprocessing,
                                 top-k, similarity, whitening, fusion
                    csrc/        CUDA C++ kernels
        data/, config.py         manifest and image helpers, paths and seed
"""

__version__ = "0.1.0"
