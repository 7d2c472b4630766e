"""Contrastive fine-tuning for the dual-tower encoders, on one device.

Port of ``emr2a_tpu/training/clip_trainer.py``: the symmetric InfoNCE
loss (``clip_contrastive_loss``), a ``TrainState`` of params, optimizer
state and step, and ``ContrastiveTrainer`` with ``init_state``,
``make_train_step``, ``save_state`` and ``restore_state``.

- The towers are ``nn.Module``s (an image tower ``(pixels) -> feats`` and a
  text tower ``(ids, mask) -> feats``, e.g. ``models/clip``'s), where JAX
  takes apply functions; the params are ``{"image": state dict, "text":
  state dict}`` (``models/convert.params_from_jax`` carries JAX's trees
  across), applied with ``torch.func.functional_call``.
- The optimizer is ``torch.optim.AdamW(lr, weight_decay, eps=1e-8)``,
  which is ``optax.adamw``'s update (decay on every parameter, with the
  learning rate). Its state is the ``TrainState.opt_state``; the train
  step updates params and moments in place (JAX donates the state).
- ``remat=True`` wraps each tower's apply in ``torch.utils.checkpoint``
  (JAX: ``jax.checkpoint``).
- ``init_state`` copies the caller's tensors (JAX jits a copy for the
  same reason: the step updates the state in place).
- ``save_state`` / ``restore_state`` are ``torch.save`` / ``torch.load`` of
  params, the optimizer's moments and the step, in place of Orbax; resume
  is exact.
- One device only: a ``mesh`` raises ``NotImplementedError``; the data and
  tensor parallelism of JAX's trainer and ``training/sharding_rules.py``
  are not ported yet (ROADMAP.md, Queue 1, item 7).
- Guard: on a CUDA tensor the port's fused kernels (K1 to K5) return
  outputs without an autograd graph, so a tower whose blocks route to them
  would train without those weights' gradients and nothing would say so.
  JAX refuses the same thing (its grad through a Pallas call raises), so
  ``init_state`` raises when either tower has a block with ``fused_attn``
  or ``fused_mlp`` set, or a quantized ``Int8Dense`` / ``Int4Dense``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from emr2a_tpu_torch.models.layers import Int4Dense, Int8Dense, TransformerBlock

_NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1, item 7)"
_TOWERS = ("image", "text")


def clip_contrastive_loss(img_feats: torch.Tensor, txt_feats: torch.Tensor,
                          temperature: float = 0.07) -> torch.Tensor:
    """Symmetric InfoNCE over the batch."""
    zi = img_feats / (torch.linalg.norm(img_feats, dim=-1, keepdim=True) + 1e-8)
    zt = txt_feats / (torch.linalg.norm(txt_feats, dim=-1, keepdim=True) + 1e-8)
    logits = (zi @ zt.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


class TrainState(NamedTuple):
    params: Dict[str, Dict[str, torch.Tensor]]
    opt_state: Any          # the torch.optim.AdamW over ``params``' leaves
    step: int


def _fused(tower: nn.Module) -> list:
    """The modules of ``tower`` whose forward would run a kernel without a
    backward: fused blocks and quantized projections."""
    return [name for name, m in tower.named_modules()
            if isinstance(m, (Int8Dense, Int4Dense))
            or (isinstance(m, TransformerBlock) and (m.fused_attn or m.fused_mlp))]


class ContrastiveTrainer:
    """An eager train step for an (image tower, text tower) pair."""

    def __init__(self, image_tower: nn.Module, text_tower: nn.Module,
                 mesh=None, learning_rate: float = 1e-5,
                 weight_decay: float = 0.01, temperature: float = 0.07,
                 remat: bool = False):
        if mesh is not None:
            raise NotImplementedError(f"a mesh (data or tensor parallelism) is {_NOT_PORTED}")
        self.towers = {"image": image_tower, "text": text_tower}
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.temperature = temperature
        self.remat = remat

    def _optimizer(self, params) -> torch.optim.AdamW:
        leaves = [params[t][k] for t in _TOWERS for k in sorted(params[t])]
        return torch.optim.AdamW(leaves, lr=self.learning_rate,
                                 weight_decay=self.weight_decay, eps=1e-8)

    def init_state(self, params) -> TrainState:
        """A state owning copies of ``params`` ({"image": ..., "text": ...},
        tensors or numpy arrays, on the device they are given on) and fresh
        AdamW moments; refuses towers with fused blocks or quantized
        projections (see the module docstring)."""
        for name, tower in self.towers.items():
            bad = _fused(tower)
            if bad:
                raise ValueError(
                    f"the {name} tower routes {bad[:3]} to fused or quantized kernels, "
                    "which have no backward; train the unfused float tower")
        state = {t: {k: torch.as_tensor(v).detach().clone().requires_grad_()
                     for k, v in params[t].items()} for t in _TOWERS}
        return TrainState(params=state, opt_state=self._optimizer(state), step=0)

    def _apply(self, tower: str, params, *args) -> torch.Tensor:
        module = self.towers[tower]

        def fn(p, *a):
            return torch.func.functional_call(module, p, a)

        if self.remat:
            return torch.utils.checkpoint.checkpoint(fn, params[tower], *args,
                                                     use_reentrant=False)
        return fn(params[tower], *args)

    def make_train_step(self):
        """``train_step(state, pixels, ids, mask) -> (state, loss)``: one
        AdamW step on the loss's gradient; inputs move to the params'
        device; the loss is returned detached, on the device."""

        def train_step(state: TrainState, pixels, ids, mask):
            device = next(iter(state.params["image"].values())).device

            def put(x):
                return None if x is None else torch.as_tensor(x).to(device)

            opt = state.opt_state
            opt.zero_grad(set_to_none=True)
            zi = self._apply("image", state.params, put(pixels))
            zt = self._apply("text", state.params, put(ids), put(mask))
            loss = clip_contrastive_loss(zi, zt, self.temperature)
            loss.backward()
            opt.step()
            return TrainState(state.params, opt, state.step + 1), loss.detach()

        return train_step

    # -- checkpoint/resume (params, optimizer moments, step) --

    def save_state(self, state: TrainState, directory) -> None:
        """Persist params + optimizer moments + step as one file,
        ``directory/train_state.pt``."""
        path = Path(directory)
        path.mkdir(parents=True, exist_ok=True)
        torch.save({"params": {t: {k: v.detach().cpu() for k, v in p.items()}
                               for t, p in state.params.items()},
                    "opt_state": state.opt_state.state_dict(),
                    "step": int(state.step)}, path / "train_state.pt")

    def restore_state(self, template: TrainState, directory) -> TrainState:
        """The saved state on ``template``'s devices and dtypes (build it
        with ``init_state``); resume is exact, AdamW's moments and step
        included."""
        blob = torch.load(Path(directory) / "train_state.pt", map_location="cpu",
                          weights_only=True)
        params = {t: {k: blob["params"][t][k].to(v.device, v.dtype).requires_grad_()
                      for k, v in template.params[t].items()} for t in _TOWERS}
        opt = self._optimizer(params)
        opt.load_state_dict(blob["opt_state"])
        return TrainState(params=params, opt_state=opt, step=blob["step"])
