"""Qwen3-VL checkpoint loading.

Port of ``emr2a_tpu/models/checkpoint.py:load_qwen3_vl``: ``config.json``
-> ``qwen3_vl_config_from_hf``, the safetensors or torch files ->
``convert_hf_qwen3_vl`` -> this package's state dict. The JAX package keeps
an Orbax cache of the converted params beside the checkpoint; that cache is
JAX's, and the port reads the checkpoint each time.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from emr2a_tpu_torch.models.convert import load_state_dict, params_from_jax
from emr2a_tpu_torch.models.qwen3_vl import (
    Qwen3VLConfig,
    convert_hf_qwen3_vl,
    qwen3_vl_config_from_hf,
)


def load_qwen3_vl(model_path, config: Optional[Qwen3VLConfig] = None,
                  params: Optional[Dict[str, torch.Tensor]] = None,
                  dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[Qwen3VLConfig, Dict[str, torch.Tensor]]:
    """(config, state dict) of a Qwen3-VL checkpoint directory; ``params``
    given (a state dict of this package) are returned as they are, with
    ``config``. The weights are cast to ``dtype``, the configs' dtype."""
    if params is not None:
        if config is None:
            raise ValueError("params need their config")
        return config, params
    path = Path(model_path)
    with (path / "config.json").open() as f:
        config = qwen3_vl_config_from_hf(json.load(f), dtype=dtype)
    tree = convert_hf_qwen3_vl(load_state_dict(path), config.vision.depth,
                               config.text.num_layers)
    state = {k: v.to(dtype) for k, v in params_from_jax(tree).items()}
    return config, state
