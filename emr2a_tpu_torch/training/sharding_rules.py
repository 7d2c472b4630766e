"""Parameter sharding rules: Megatron tensor parallelism over the mesh's
``model`` axis.

Port of ``emr2a_tpu/training/sharding_rules.py``, with JAX's rule kept as
it is. Every projection gets a spec by its role:

- column-parallel (out features sharded): q/k/v projections, MLP fc1 /
  up / gate -> ``(None, "model")``, and their biases -> ``("model",)``;
- row-parallel (in features sharded): attention out_proj / o_proj, MLP
  fc2 / down -> ``("model", None)``;
- everything else (embeddings, norms, the biases of row-parallel layers,
  and any leaf that is not a 2-D ``kernel``) is replicated: ``()``.

A spec is a tuple with one mesh axis name or None per dimension (JAX: a
``PartitionSpec``; ``()`` is ``P()``). Only a 2-D leaf named ``kernel`` is
sharded, so quantized projections (``kernel_q`` / ``kernel_scale``,
``kernel_p4`` / ``kernel_scale4``) and the fused ``qkv_proj`` /
``gate_up_proj`` layout stay whole on every card, as in JAX; a
column-parallel ``bias`` is sharded even where its kernel is quantized.
``parallel.shard_params`` places a state dict by these specs; the models
put the all-reduce after each row-parallel product themselves (XLA inserts
it in JAX).
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple, Union

from emr2a_tpu_torch.parallel.mesh import MODEL_AXIS

_COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "fc1", "up_proj",
                    "gate_proj", "query", "key", "value")
_ROW_PARALLEL = ("out_proj", "o_proj", "fc2", "down_proj")

Spec = Tuple[Union[str, None], ...]


def spec_for_param(path: Union[str, Sequence[str]], value) -> Spec:
    """The spec of one leaf, from its state-dict key (``"a.b.kernel"``) or
    its path of names, and its shape."""
    names = path.split(".") if isinstance(path, str) else [str(p) for p in path]
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    if leaf == "kernel" and value.ndim == 2:
        if parent in _COLUMN_PARALLEL:
            return (None, MODEL_AXIS)
        if parent in _ROW_PARALLEL:
            return (MODEL_AXIS, None)
    if leaf == "bias" and parent in _COLUMN_PARALLEL:
        return (MODEL_AXIS,)
    return ()


def param_shardings(params: Mapping) -> dict:
    """The spec of every leaf of a state dict, or of a dict of them (the
    trainer's ``{"image": ..., "text": ...}``), in the same structure (JAX:
    a tree of ``NamedSharding``s over a mesh; the specs do not depend on
    it, so none is taken)."""
    return {k: param_shardings(v) if isinstance(v, Mapping) else spec_for_param(k, v)
            for k, v in params.items()}
