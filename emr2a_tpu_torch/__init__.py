"""emr2a_tpu_torch -- the PyTorch and CUDA port of ``emr2a_tpu``.

The JAX package beside it is the reference this port is tested against.
This package imports PyTorch and never JAX, nor any module of the JAX
package. It carries the main path's step2 and retrieval halves:
BioMedCLIP's two towers (the ViT-B/16 image tower, whose fused
LN+attention and LN+MLP blocks run on kernels written by hand for Hopper
in bf16 (``fast=True``) and W8A8 (``fast="int8"``), and the PubMedBERT text
tower, whose int8 projections run the streaming W8A8 kernel) and the step2
embedding CLI; the one-GPU case database, whose scan runs the fused cosine
top-k kernel, with its CLI; the cross-validated retrieval runner; and
step4, the Qwen3-VL judge that audits the retrieval's predictions, whose
vision attention runs the per-frame attention kernel and whose decoder
projections run the W8A8 or the W4A8 kernel. The kernels live in ``csrc/``
and are built with ``nvcc`` for sm_90a at first use.

    pipelines/step2_embeddings   CLI: manifest -> embeddings.npz
    analysis/run_cv_experiments  CLI: embeddings -> fold metrics.json
    retrieval/database[_cli]     CLI: the case database (build/add/query)
    pipelines/step4_vlm_review   CLI: fold metrics.json -> vlm_audit_*
        judge/                   audit module, Qwen backend, parsers, prompts
        eval/                    CV evaluator, metrics, votes, audit metrics
        encoders/                batched encode engine, BioMedCLIP, fake,
                                 the Qwen image processor
            models/              ViT, BERT, BioMedCLIP towers, Qwen3-VL,
                                 converters, checkpoints, W8A8/W4A8 quantizers
                ops/             kernels' wrappers, quantize, preprocessing,
                                 top-k, similarity, whitening, fusion
                    csrc/        CUDA C++ kernels
        data/, config.py         manifest and image helpers, paths and seed
        tools/                   profilers, the synthetic cohort, a stub
                                 tokenizer, a torchvision-layout ResNet-18
    baselines/cnn                CLI: the ResNet-18 classifier under k-fold
    baselines/vlm_direct         CLI: the judge's diagnosis without retrieval
    training/                    contrastive fine-tuning of the towers
    utils/                       stage timer, throughput meter, traces
"""

__version__ = "0.1.0"
