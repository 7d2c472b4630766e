"""Qwen3-VL checkpoint loading, through a cache of the converted weights.

Port of ``emr2a_tpu/models/checkpoint.py`` (``load_qwen3_vl``,
``load_or_convert``, ``_weights_fingerprint``, ``_cache_stale``):
``config.json`` -> ``qwen3_vl_config_from_hf``, the safetensors or torch
files -> ``convert_hf_qwen3_vl`` -> this package's state dict, in the
configs' dtype. A second load of the 8B judge skips reading and converting
the checkpoint: it reads the converted state dict that the first load left
beside the checkpoint.

The cache is the port's own format (JAX keeps an Orbax checkpoint of its
flax params): the directory ``{cache_name}.{converter}.{dtype}`` beside the
weights holds ``state.pt``, one ``torch.save`` of the converted state
dict, read back with ``torch.load(mmap=True, weights_only=True)``, and
``weights_stamp.json``, JAX's stamp: the name, size and whole-second mtime
of every ``*.safetensors``, ``*.bin`` and ``*.pt`` file, written after the
state. The dtype in the name keeps a bf16 and an f32 load apart. A stamp
that no longer matches the files (swapped weights, even with an older
mtime), or a cache that cannot be read, is converted again and rewritten.
Each file is written under a temporary name and renamed into place, so a
reader, or a state dict still mapped from the old file, never sees a
partial one. A directory that cannot be written still loads, by
conversion, with a logged warning (JAX passes silently).
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from emr2a_tpu_torch.models.convert import load_state_dict, params_from_jax
from emr2a_tpu_torch.models.qwen3_vl import (
    Qwen3VLConfig,
    convert_hf_qwen3_vl,
    qwen3_vl_config_from_hf,
)

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"
STAMP_FILE = "weights_stamp.json"


def _weights_fingerprint(ckpt_dir: Path) -> str:
    weights = sorted(list(ckpt_dir.glob("*.safetensors"))
                     + list(ckpt_dir.glob("*.bin"))
                     + list(ckpt_dir.glob("*.pt")))
    return json.dumps([(w.name, w.stat().st_size, int(w.stat().st_mtime))
                       for w in weights])


def _cache_stale(ckpt_dir: Path, cache_dir: Path) -> bool:
    """True unless the stamp written at conversion matches the weight files
    now (name, size, mtime)."""
    try:
        return (cache_dir / STAMP_FILE).read_text() != _weights_fingerprint(ckpt_dir)
    except OSError:
        return True


def _write(path: Path, write: Callable[[Path], None]) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _store(cache_dir: Path, state: Dict[str, torch.Tensor], stamp: str) -> None:
    """Write ``state``, then the stamp of the weights it came from."""
    cache_dir.mkdir(exist_ok=True)
    (cache_dir / STAMP_FILE).unlink(missing_ok=True)
    _write(cache_dir / STATE_FILE, lambda p: torch.save(state, p))
    _write(cache_dir / STAMP_FILE, lambda p: p.write_text(stamp))


def load_or_convert(model_path, convert_fn: Callable[[dict], Dict[str, torch.Tensor]],
                    dtype: torch.dtype, cache_name: str = "emr2a_torch"
                    ) -> Dict[str, torch.Tensor]:
    """``convert_fn(load_state_dict(model_path))``, a state dict in
    ``dtype``, through the cache beside the checkpoint (module docstring):
    read from it where it is fresh, else converted and written to it."""
    path = Path(model_path)
    fn_name = getattr(convert_fn, "__name__", "convert")
    cache_dir = path / f"{cache_name}.{fn_name}.{str(dtype).replace('torch.', '')}"
    if cache_dir.exists() and not _cache_stale(path, cache_dir):
        try:
            return torch.load(cache_dir / STATE_FILE, map_location="cpu", mmap=True,
                              weights_only=True)
        except Exception as e:
            logger.warning("converted-params cache %s unreadable (%s): converting again",
                           cache_dir, e)
    state = convert_fn(load_state_dict(path))
    try:
        _store(cache_dir, state, _weights_fingerprint(path))
    except (OSError, RuntimeError) as e:     # torch.save reports its file's faults as RuntimeError
        logger.warning("converted-params cache not written beside %s (%s): the next "
                       "load converts again", path, e)
    return state


def load_qwen3_vl(model_path, config: Optional[Qwen3VLConfig] = None,
                  params: Optional[Dict[str, torch.Tensor]] = None,
                  dtype: torch.dtype = torch.bfloat16, cache_params: bool = True
                  ) -> Tuple[Qwen3VLConfig, Dict[str, torch.Tensor]]:
    """(config, state dict) of a Qwen3-VL checkpoint directory; ``params``
    given (a state dict of this package) are returned as they are, with
    ``config``. The weights are cast to ``dtype``, the configs' dtype;
    ``cache_params`` reads and writes the converted-params cache."""
    if params is not None:
        if config is None:
            raise ValueError("params need their config")
        return config, params
    path = Path(model_path)
    with (path / "config.json").open() as f:
        config = qwen3_vl_config_from_hf(json.load(f), dtype=dtype)

    def convert_qwen3_vl(sd):
        tree = convert_hf_qwen3_vl(sd, config.vision.depth, config.text.num_layers)
        return {k: v.to(dtype) for k, v in params_from_jax(tree).items()}

    if cache_params:
        return config, load_or_convert(path, convert_qwen3_vl, dtype)
    return config, convert_qwen3_vl(load_state_dict(path))
