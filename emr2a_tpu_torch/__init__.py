"""emr2a_tpu_torch -- the PyTorch and CUDA port of ``emr2a_tpu``.

The JAX package beside it is the reference this port is tested against.
This package imports PyTorch and never JAX. It carries the step2 path and
BioMedCLIP's two towers: the ViT-B/16 image tower, whose fused
LN+attention and LN+MLP blocks run on kernels written by hand for Hopper
in bf16 (``fast=True``) and W8A8 (``fast="int8"``), and the PubMedBERT
text tower, whose int8 projections run the streaming W8A8 kernel (all in
``csrc/``, built with ``nvcc`` for sm_90a at first use); and the step2
embedding CLI.

    pipelines/step2_embeddings   CLI: manifest -> embeddings.npz
        encoders/                batched encode engine, BioMedCLIP, fake
            models/              ViT, BERT, BioMedCLIP towers, converters,
                                 W8A8 quantizer
                ops/             kernels' wrappers, quantize, preprocessing,
                                 top-k
                    csrc/        CUDA C++ kernels
"""

__version__ = "0.1.0"
