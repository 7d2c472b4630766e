"""Contrastive fine-tuning for the dual-tower encoders, on one device or
over a mesh's data and model axes.

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
  is exact. The file holds whole tensors, so a state saved on one mesh (or
  one device) resumes on any other.
- ``mesh`` (a ``parallel.Mesh``; anything else raises ``TypeError``): data
  x model, as JAX's. The batch is split on ``data`` into one equal chunk a
  data replica (the batch must divide). Each replica (a row of the mesh)
  holds the towers' leaves placed by ``training/sharding_rules``: a sharded
  leaf in equal chunks over the replica's model cards, a replicated one on
  its first card, where the replicated part of the forward runs (JAX runs
  it on every card of the model axis; the values are the same). Every
  ``MultiHeadAttention`` and ``Mlp`` becomes a ``ShardedAttention`` /
  ``ShardedMlp`` over the model cards, whose row-parallel partial products
  are summed after ``out_proj`` / ``fc2`` in card order. The embeddings
  are gathered onto the first card, where the contrastive loss is taken
  over the whole batch, as JAX's global loss is; autograd carries every
  cross-card copy. Each leaf's gradients are then summed over the data
  replicas in replica order (in f32), so every replica's AdamW, whose
  moments lie beside its leaves, takes the same step. ``TrainState.params``
  is then a list, one per replica, of ``{tower: {name: tensor}}`` in the
  sharded towers' names, and ``opt_state`` a list of their AdamWs;
  ``whole_params`` gives the whole tensors. ``mesh=None`` is one replica of
  one card (the params' device) on the same code, its state unwrapped: a
  dict of params and one AdamW.
- Why the row-parallel sum lands on the replica's first card here, where
  the served Qwen3-VL (``models/qwen3_vl.row_parallel``) all-reduces onto
  every card: both use the same ``shard=(c, n)`` modules, placement
  (``parallel.shard_tensor`` by ``spec_for_param``) and card-order f32 sum
  (``parallel.reduce_to``, which ``all_reduce`` runs once a card). But the
  towers' own forward (``models/vit``, ``models/text``, ``models/clip``)
  runs here unchanged through ``functional_call``, only its attention and
  MLP modules swapped for sharded ones, so the embeddings, norms,
  residuals and pooling run once, on the first card, and the sum is needed
  only there. Qwen3-VL's layers are steps over a list of shards, with the
  hidden state on every card, so that no card waits for a broadcast before
  its next column-parallel product at each of a decode's 36 layers; the
  trainer, one large batch a step, gains nothing from it.
- Guard: on a CUDA tensor the port's fused kernels (K1 to K5) return
  outputs without an autograd graph, so a tower whose blocks route to them
  would train without those weights' gradients and nothing would say so.
  JAX refuses the same thing (its grad through a Pallas call raises), so
  ``init_state`` raises when either tower has a block with ``fused_attn``
  or ``fused_mlp`` set, or a quantized ``Int8Dense`` / ``Int4Dense``.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emr2a_tpu_torch.models.layers import (
    Int4Dense,
    Int8Dense,
    MultiHeadAttention,
    Mlp,
    ShardedAttention,
    ShardedMlp,
    TransformerBlock,
)
from emr2a_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from emr2a_tpu_torch.parallel.tensor import (
    check_mesh,
    reduce_to,
    shard_dim,
    shard_tensor,
    unshard_param,
)
from emr2a_tpu_torch.training.sharding_rules import spec_for_param

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
    params: Any             # {tower: {name: tensor}}; under a mesh, one a replica
    opt_state: Any          # the torch.optim.AdamW over ``params``' leaves (a list)
    step: int


def _fused(tower: nn.Module) -> list:
    """The modules of ``tower`` whose forward would run a kernel without a
    backward: fused blocks and quantized projections."""
    return [name for name, m in tower.named_modules()
            if isinstance(m, (Int8Dense, Int4Dense))
            or (isinstance(m, TransformerBlock) and (m.fused_attn or m.fused_mlp))]


def _sharded_tower(tower: nn.Module, n: int):
    """``tower``'s structure (on the meta device) with every
    ``MultiHeadAttention`` / ``Mlp`` replaced by its ``ShardedAttention`` /
    ``ShardedMlp`` over n cards, and the paths of the replaced modules."""
    tower = copy.deepcopy(tower).to("meta")
    paths = []
    for name, m in list(tower.named_modules()):
        if isinstance(m, MultiHeadAttention):
            kw = dict(dtype=m.q_proj.kernel.dtype, device="meta")
            hidden = m.q_proj.kernel.shape[0]
            new = ShardedAttention([MultiHeadAttention(
                hidden, m.num_heads, m.q_proj.bias is not None, m.out_proj.bias is not None,
                shard=(c, n), **kw) for c in range(n)])
        elif isinstance(m, Mlp):
            kw = dict(dtype=m.fc1.kernel.dtype, device="meta")
            new = ShardedMlp([Mlp(*m.fc1.kernel.shape, m.activation, shard=(c, n), **kw)
                              for c in range(n)])
        else:
            continue
        parent, _, leaf = name.rpartition(".")
        setattr(tower.get_submodule(parent), leaf, new)
        paths.append(name)
    return tower, paths


class _Placement:
    """Where one tower's leaves lie on a replica's model cards: each whole
    leaf's name in the sharded tower on each card (``_sharded_tower``), by
    its ``spec_for_param``."""

    def __init__(self, keys, specs: Dict[str, tuple], paths, n: int):
        self.specs = specs
        self.names: Dict[str, List[str]] = {}
        for key in keys:
            owner = next((p for p in paths if key.startswith(p + ".")), None)
            sharded = shard_dim(specs[key]) is not None
            if owner is None:
                if sharded and n > 1:
                    raise ValueError(f"{key} is sharded by the rules but lies outside a "
                                     "MultiHeadAttention or Mlp")
                self.names[key] = [key]
            else:
                rest = key[len(owner) + 1:]
                self.names[key] = [f"{owner}.shards.{c}.{rest}"
                                   for c in range(n if sharded else 1)]

    def place(self, key: str, value: torch.Tensor, devices) -> Dict[str, torch.Tensor]:
        """``value`` (the whole leaf ``key``) cut and placed: {name: chunk}."""
        names = self.names[key]
        chunks = (shard_tensor(value, self.specs[key], devices) if len(names) > 1
                  else [value.to(devices[0])])
        return dict(zip(names, chunks))

    def whole(self, key: str, placed: Dict[str, torch.Tensor], device="cpu") -> torch.Tensor:
        return unshard_param([placed[n] for n in self.names[key]], self.specs[key], device)


class ContrastiveTrainer:
    """An eager train step for an (image tower, text tower) pair, on one
    device or over a mesh (see the module docstring). One device is a mesh
    of one replica of one card, the params' own device, so both run the
    same code; the state of a ``mesh=None`` trainer unwraps that replica
    (``TrainState.params`` a dict, ``opt_state`` one AdamW)."""

    def __init__(self, image_tower: nn.Module, text_tower: nn.Module,
                 mesh=None, learning_rate: float = 1e-5,
                 weight_decay: float = 0.01, temperature: float = 0.07,
                 remat: bool = False):
        self.towers = {"image": image_tower, "text": text_tower}
        self.mesh = mesh
        self.replicas = None        # one device: the params' own, set by init_state
        n = 1
        if mesh is not None:
            check_mesh(mesh)
            axes = mesh.axis_names
            grid = np.moveaxis(mesh.devices, [axes.index(DATA_AXIS), axes.index(MODEL_AXIS)],
                               [0, 1])
            # each data replica's model cards, in card order
            self.replicas = [list(row) for row in grid]
            n = len(self.replicas[0])
        self.sharded = {t: _sharded_tower(m, n) if n > 1 else (m, [])
                        for t, m in self.towers.items()}
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.temperature = temperature
        self.remat = remat

    def _optimizer(self, leaves) -> torch.optim.AdamW:
        return torch.optim.AdamW(leaves, lr=self.learning_rate,
                                 weight_decay=self.weight_decay, eps=1e-8)

    def _state(self, params: list, opts: list, step: int) -> TrainState:
        """The public state of the replicas' params and AdamWs."""
        if self.mesh is None:
            return TrainState(params=params[0], opt_state=opts[0], step=step)
        return TrainState(params=params, opt_state=opts, step=step)

    def _replicas(self, state: TrainState) -> tuple:
        """``state``'s params and AdamWs, one a replica."""
        if self.mesh is None:
            return [state.params], [state.opt_state]
        return state.params, state.opt_state

    def _leaves(self, placed) -> list:
        """A replica's leaves in the one-device order (tower, whole name,
        card)."""
        return [placed[t][n] for t in _TOWERS for k in sorted(self._placed[t].names)
                for n in self._placed[t].names[k]]

    def _place(self, params) -> list:
        """``params`` (whole tensors) copied onto every replica."""
        return [{t: {n: v.clone().requires_grad_()
                     for k in sorted(params[t])
                     for n, v in self._placed[t].place(
                         k, torch.as_tensor(params[t][k]).detach(), devices).items()}
                 for t in _TOWERS} for devices in self.replicas]

    def init_state(self, params) -> TrainState:
        """A state owning copies of ``params`` ({"image": ..., "text": ...},
        tensors or numpy arrays, on the device they are given on; under a
        mesh, placed on every replica) and fresh AdamW moments; refuses
        towers with fused blocks or quantized projections (see the module
        docstring)."""
        for name, tower in self.towers.items():
            bad = _fused(tower)
            if bad:
                raise ValueError(
                    f"the {name} tower routes {bad[:3]} to fused or quantized kernels, "
                    "which have no backward; train the unfused float tower")
        if self.mesh is None:
            leaf = next((v for t in _TOWERS for v in params[t].values()), None)
            self.replicas = [[torch.as_tensor(leaf).device if leaf is not None
                              else torch.device("cpu")]]
        n = len(self.replicas[0])
        self._placed = {t: _Placement(params[t], {k: spec_for_param(k, v)
                                                  for k, v in params[t].items()},
                                      self.sharded[t][1], n) for t in _TOWERS}
        placed = self._place(params)
        return self._state(placed, [self._optimizer(self._leaves(p)) for p in placed], 0)

    def whole_params(self, state: TrainState, device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
        """The state's params as whole tensors on ``device`` (under a mesh,
        gathered from the first replica)."""
        first = self._replicas(state)[0][0]
        return {t: {k: self._placed[t].whole(k, first[t], device).detach()
                    for k in self._placed[t].names} for t in _TOWERS}

    def _apply(self, tower: str, params, *args) -> torch.Tensor:
        module = self.sharded[tower][0]

        def fn(p, *a):
            return torch.func.functional_call(module, p, a)

        if self.remat:
            return torch.utils.checkpoint.checkpoint(fn, params[tower], *args,
                                                     use_reentrant=False)
        return fn(params[tower], *args)

    def make_train_step(self):
        """``train_step(state, pixels, ids, mask) -> (state, loss)``: one
        AdamW step on the loss's gradient. Each replica embeds its chunk of
        the batch (on its first card; one device: the whole batch, moved to
        the params' device), the loss is taken over the gathered embeddings,
        and each leaf's gradients are summed over the replicas in replica
        order; the loss is returned detached, on the (first) device."""

        def train_step(state: TrainState, pixels, ids, mask):
            params, opts = self._replicas(state)
            R = len(self.replicas)
            inputs = [None if x is None else torch.as_tensor(x) for x in (pixels, ids, mask)]
            B = inputs[0].shape[0]
            if B % R:
                raise ValueError(f"the batch ({B}) does not divide by the {R} data replicas")
            for opt in opts:
                opt.zero_grad(set_to_none=True)
            zis, zts = [], []
            for r, (p, devices) in enumerate(zip(params, self.replicas)):
                px, tok, m = (None if x is None else x[r * B // R:(r + 1) * B // R].to(devices[0])
                              for x in inputs)
                zis.append(self._apply("image", p, px))
                zts.append(self._apply("text", p, tok, m))
            lead = self.replicas[0][0]
            loss = clip_contrastive_loss(torch.cat([z.to(lead) for z in zis]),
                                         torch.cat([z.to(lead) for z in zts]), self.temperature)
            loss.backward()
            if R > 1:
                for group in zip(*(self._leaves(p) for p in params)):
                    if group[0].grad is None:
                        continue
                    total = reduce_to([p.grad for p in group], group[0].device)
                    for p in group:
                        p.grad = total.to(p.device)
            for opt in opts:
                opt.step()
            return self._state(params, opts, state.step + 1), loss.detach()

        return train_step

    # -- checkpoint/resume (params, optimizer moments, step) --

    def _leaf_order(self):
        """(whole leaf index, tower, name, the leaf's names on a replica)
        in the one-device order of the AdamW's leaves."""
        return [(w, t, k, self._placed[t].names[k]) for w, (t, k) in enumerate(
            (t, k) for t in _TOWERS for k in sorted(self._placed[t].names))]

    def save_state(self, state: TrainState, directory) -> None:
        """Persist params + optimizer moments + step as one file of whole
        tensors, ``directory/train_state.pt`` (under a mesh, the first
        replica's, gathered): the AdamW state in the one-device layout, one
        entry per whole leaf."""
        path = Path(directory)
        path.mkdir(parents=True, exist_ok=True)
        sd = self._replicas(state)[1][0].state_dict()
        index, moments = 0, {}
        for w, t, k, names in self._leaf_order():
            entries = [sd["state"].get(index + c) for c in range(len(names))]
            index += len(names)
            if entries[0] is None:
                continue
            spec = self._placed[t].specs[k] if len(names) > 1 else ()
            moments[w] = {"step": entries[0]["step"], **{
                m: unshard_param([e[m] for e in entries], spec, "cpu")
                for m in ("exp_avg", "exp_avg_sq")}}
        group = {k: v for k, v in sd["param_groups"][0].items() if k != "params"}
        opt_state = {"state": moments,
                     "param_groups": [{**group, "params": list(range(len(self._leaf_order())))}]}
        torch.save({"params": self.whole_params(state), "opt_state": opt_state,
                    "step": int(state.step)}, path / "train_state.pt")

    def restore_state(self, template: TrainState, directory) -> TrainState:
        """The saved state on ``template``'s devices and dtypes (build it
        with ``init_state``, on this trainer's mesh or device); resume is
        exact, AdamW's moments and step included, whatever mesh saved it."""
        blob = torch.load(Path(directory) / "train_state.pt", map_location="cpu",
                          weights_only=True)
        first = self._replicas(template)[0][0]
        whole = {t: {k: blob["params"][t][k].to(first[t][self._placed[t].names[k][0]].dtype)
                     for k in self._placed[t].names} for t in _TOWERS}
        placed = self._place(whole)
        opts = []
        for p, devices in zip(placed, self.replicas):
            opt = self._optimizer(self._leaves(p))
            sd = {"state": {}, "param_groups": copy.deepcopy(blob["opt_state"]["param_groups"])}
            index = 0
            for w, t, k, names in self._leaf_order():
                entry = blob["opt_state"]["state"].get(w)
                if entry is not None:
                    # each replica owns its moments (a placement may alias its source)
                    moments = {m: [v.clone() for v in
                                   self._placed[t].place(k, entry[m], devices).values()]
                               for m in ("exp_avg", "exp_avg_sq")}
                    for c in range(len(names)):
                        sd["state"][index + c] = {"step": entry["step"].clone(), **{
                            m: moments[m][c] for m in moments}}
                index += len(names)
            sd["param_groups"][0]["params"] = list(range(index))
            opt.load_state_dict(sd)
            opts.append(opt)
        return self._state(placed, opts, blob["step"])
