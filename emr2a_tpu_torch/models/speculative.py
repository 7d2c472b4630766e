"""Speculative decoding for the Qwen3-VL judge.

Port of ``emr2a_tpu/models/speculative.py`` with its names, arguments and
errors. A small draft model proposes ``spec_k`` tokens a cycle; the target
verifies all ``spec_k + 1`` positions in one forward. Greedy acceptance
(the longest draft prefix equal to the target's argmax, then the target's
own token) emits exactly the target's greedy stream; with ``temperature >
0`` the rejection-sampling acceptance (``qwen3_vl.spec_accept``) keeps the
stream distributed as sampling from the target alone. The target's weights
are read once a cycle instead of once a token.

How JAX's mechanisms carry over:

- Both prefills run as in JAX, each model on its own cache (the draft's
  prefill runs the draft's own vision tower, so a multimodal request runs
  K8 in both towers).
- JAX's ``lax.while_loop`` over cycles becomes one cycle
  (``SpeculativeGenerator.cycle``) over a ``SpecState`` of device tensors
  (both KV caches, the output buffer of ``max_new + k + 1``, a 0-d emitted
  count, a 0-d done flag, the row's stream key), which it advances in
  place: k + 1 draft decode steps, one (k + 1)-token verify forward of the
  target and the acceptance (``draft_and_verify``, which the continuous
  batcher's speculative chunk runs over its slots too), then the cursor's
  advance. On a CUDA tensor the
  cycle is captured once (``models/cuda_graph.StepGraph``) and replayed in
  chunks of ``chunk`` cycles; the host reads the emitted count and the done
  flag once a chunk. A failed capture raises; nothing falls back to eager
  cycles. On a CPU tensor every cycle runs eagerly. The generator keeps its
  graphs with their states by (padded prompt, max_new, k, greedy or
  sampled, KV dtype) within ``qwen3_vl._KEPT_GRAPH_BYTES`` of KV cache
  (both models' caches counted), as ``Qwen3VLGenerator`` does.
- Rejected draft positions are never exposed: every mask bounds the keys
  by the verified length, and later cycles overwrite them (JAX's
  mask-out-instead-of-rollback).

Divergences (ROADMAP.md Queue 3):

- The no-op guard. A replayed chunk runs cycles that JAX's loop never
  runs, after the row has emitted ``max_new`` tokens or eos. Such a cycle
  is a no-op: it does not advance, writes nothing to the output, and its
  KV writes go to offset ``max_len`` through ``cache_write``'s per-row
  branch, which drops them. (Its 0-d branch would clamp a write past the
  cache into [0, L - S], over the visible prefix.) The cache keeps JAX's
  slack, ``max_len = padded + max_new + k + 1``, so a live cycle never
  reaches the end.
- The sampler's keys. A sampled generation seeded ``seed`` has the stream
  key ``stream_keys(seed, 0)``; its first token is the plain generator's
  (``draw_keys(key, 0)``), and the cycle that starts at generated position
  n draws with ``spec_keys(key, n, k + 2)``: column j < k for the draft's
  draw j, column k + 1 for the acceptance, so the keys are per (request
  stream, cycle, position). JAX splits a ``jax.random`` key each step: the
  distribution is the same, the tokens are not.

Tensor parallelism: a target and a draft sharded over the same mesh's
``model`` axis (``qwen3_vl.tensor_parallel``, as JAX's backend shards both)
serve with both caches sharded on their kv heads; above one card of the
model axis the cycles run eagerly, by design (``cuda_graph.StepGraph``'s
``eager``).

B = 1 only: speculative decoding is the latency path; batches go through
``Qwen3VLGenerator`` or the continuous batcher, whose speculative chunk is
``models/serving.py``'s.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from emr2a_tpu_torch.models import qwen3_vl
from emr2a_tpu_torch.models.cuda_graph import StepGraph
from emr2a_tpu_torch.models.qwen3_vl import (
    Qwen3VLGenerator,
    Qwen3VLModel,
    cache_bytes,
    draw_keys,
    filtered_log_probs,
    sample_rows,
    spec_accept,
    spec_keys,
    stream_keys,
)


@dataclass
class SpecState:
    """One speculative generation's device state, which ``cycle`` advances
    in place (JAX: the while loop's carry). ``out`` (max_new + k + 1,) holds
    the verified tokens (out[:n_emitted]; past it, a cycle's candidates),
    ``n_emitted`` and ``done`` are 0-d; ``logits`` (k + 1, V) f32 the last
    live cycle's verify logits; ``cycles`` / ``accepted`` count the live
    cycles and their accepted drafts. ``temp`` / ``top_p`` / ``stream`` are
    None for greedy decoding."""
    t_cache: list
    d_cache: list
    out: torch.Tensor
    n_emitted: torch.Tensor
    done: torch.Tensor
    true_len: torch.Tensor
    pos_base: torch.Tensor
    logits: torch.Tensor
    cycles: torch.Tensor
    accepted: torch.Tensor
    padded_len: int
    max_len: int
    max_new: int
    temp: Optional[torch.Tensor] = None
    top_p: Optional[torch.Tensor] = None
    stream: Optional[torch.Tensor] = None


def draft_and_verify(target: Qwen3VLModel, draft: Qwen3VLModel, t_cache: list,
                     d_cache: list, cur: torch.Tensor, gen: torch.Tensor,
                     live: torch.Tensor, true_len: torch.Tensor, pos_base: torch.Tensor,
                     padded_len: int, max_len: int, k: int, sampling=None, keys=None):
    """The proposal, the verify and the acceptance of one speculative cycle
    of B rows (JAX: the body of ``SpeculativeGenerator``'s while loop and of
    ``_build_spec_chunk``'s scan). Row b's pending token ``cur[b]`` is its
    generated token ``gen[b]``: the draft feeds it and then its own k
    proposals (k + 1 steps, so that its cache also holds d_k when every
    proposal is accepted), and the target verifies [cur, d_1 .. d_k] in one
    (B, k + 1)-token forward at per-row offsets. A row whose ``live`` is
    false writes its KV at ``max_len``, which ``cache_write`` drops.
    ``sampling`` is None (greedy: the longest argmax-matching prefix, then
    the target's token) or (temp, top_p) per row, with ``keys`` (B, k + 2):
    column j < k for the draft's draw j, column k + 1 for ``spec_accept``.
    Returns the emitted candidates (B, k + 1) (the first n_acc + 1 valid),
    n_acc (B,) and the verify logits (B, k + 1, V) f32. It reads nothing
    back to the host."""
    P, L = padded_len, max_len
    B, dev = cur.shape[0], cur.device
    k_idx = torch.arange(L, device=dev)[None, None, :]
    prompt = k_idx < true_len[:, None, None]

    tok, drafts, q_lp = cur, [], []
    for i in range(k + 1):
        g = gen + i
        pos = (pos_base + g)[None, :, None].expand(3, B, 1)
        mask = torch.where(prompt | ((k_idx >= P) & (k_idx <= (P + g)[:, None, None])),
                           0.0, float("-inf")).float()
        logits, _ = draft(tok[:, None], pos, cache=d_cache,
                          cache_pos=torch.where(live, P + g, L), attn_mask=mask)
        if i == k:
            break
        last = logits[:, -1].float()
        if sampling is not None:
            q_lp.append(filtered_log_probs(last, *sampling))
            tok = sample_rows(last, keys[:, i], *sampling)
        else:
            tok = torch.argmax(last, dim=-1)
        drafts.append(tok)
    drafts = torch.stack(drafts, dim=1)                       # (B, k)

    # the logits at chunk position j give the target's token after
    # generated token gen + j
    gen_idx = gen[:, None] + torch.arange(k + 1, device=dev)[None, :]
    pos = (pos_base[:, None] + gen_idx)[None].expand(3, B, k + 1)
    mask = torch.where(prompt | ((k_idx >= P) & (k_idx <= (P + gen_idx)[:, :, None])),
                       0.0, float("-inf")).float()
    logits, _ = target(torch.cat([cur[:, None], drafts], dim=1), pos, cache=t_cache,
                       cache_pos=torch.where(live, P + gen, L), attn_mask=mask)
    logits = logits.float()
    if sampling is not None:
        temp, top_p = sampling
        V = logits.shape[-1]
        p_lp = filtered_log_probs(logits.reshape(B * (k + 1), V), temp.repeat_interleave(k + 1),
                                  top_p.repeat_interleave(k + 1)).reshape(B, k + 1, V)
        emitted, n_acc = spec_accept(drafts, torch.stack(q_lp, dim=1), p_lp, keys[:, k + 1])
    else:
        emitted = torch.argmax(logits, dim=-1)
        n_acc = torch.cumprod((drafts == emitted[:, :k]).to(torch.int64), dim=1).sum(dim=1)
    return emitted, n_acc, logits


class SpeculativeGenerator:
    """Speculative prefill + decode over two Qwen3-VL models, each holding
    its params (JAX: ``SpeculativeGenerator(target_model, target_params,
    draft_model, draft_params, ...)``). They must share the vocabulary;
    ``spec_k`` drafts are proposed a cycle, and a cycle emits 1 to ``spec_k
    + 1`` verified tokens. ``kv_dtype="int8"`` applies to both caches."""

    def __init__(self, target_model: Qwen3VLModel, draft_model: Qwen3VLModel,
                 spec_k: int = 4, eos_token_id: int = 151645, kv_dtype: str = "bf16"):
        if target_model.config.text.vocab_size != draft_model.config.text.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if getattr(target_model, "mesh", None) is not getattr(draft_model, "mesh", None):
            raise ValueError("the target and the draft must be sharded over the same mesh")
        self.tm, self.dm = target_model, draft_model
        self.spec_k = int(spec_k)
        if self.spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        self.eos_token_id = eos_token_id
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be bf16 or int8: {kv_dtype}")
        self.kv_dtype = kv_dtype
        self._target = Qwen3VLGenerator(target_model, eos_token_id=eos_token_id,
                                        kv_dtype=kv_dtype)
        self._draft = Qwen3VLGenerator(draft_model, eos_token_id=eos_token_id,
                                       kv_dtype=kv_dtype)
        self._graphs: "OrderedDict[tuple, StepGraph]" = OrderedDict()

    @property
    def device(self) -> torch.device:
        return self._target.device

    def release(self) -> None:
        """Drop the kept cycle graphs and their states."""
        self._graphs.clear()

    def start(self, input_ids: np.ndarray, pixel_patches=None,
              grid_thw: Tuple[Tuple[int, int, int], ...] = (), max_new_tokens: int = 128,
              prompt_bucket: int = 128, temperature: float = 0.0, top_p: float = 1.0,
              seed: int = 0, into: Optional[SpecState] = None) -> SpecState:
        """Both prefills and the first token (the target's argmax, or its
        draw 0 of the stream): the state ``cycle`` advances; written into
        ``into`` (a state of the same shape, which a captured graph reads)
        when given."""
        k, eos = self.spec_k, self.eos_token_id
        ids_t, pos_t, tl, patches, padded = self._target.device_inputs(
            input_ids, pixel_patches, grid_thw, prompt_bucket)
        out_len = max_new_tokens + k + 1
        max_len = padded + out_len
        grids = tuple(grid_thw)
        t_cache, logits0, pos_base = self._target._prefill(
            ids_t, pos_t, tl, patches, grids, padded, max_len,
            cache=None if into is None else into.t_cache)
        d_patches = None if patches is None else patches.to(self.dm.config.vision.dtype)
        d_cache, _, _ = self._draft._prefill(
            ids_t, pos_t, tl, d_patches, grids, padded, max_len,
            cache=None if into is None else into.d_cache)
        dev = ids_t.device
        zero = lambda dt: torch.zeros((), dtype=dt, device=dev)
        s = SpecState(
            t_cache=t_cache, d_cache=d_cache,
            out=torch.full((out_len,), eos, dtype=torch.int64, device=dev),
            n_emitted=torch.ones((), dtype=torch.int64, device=dev), done=zero(torch.bool),
            true_len=tl, pos_base=pos_base,
            logits=torch.zeros((k + 1, logits0.shape[-1]), device=dev),
            cycles=zero(torch.int64), accepted=zero(torch.int64),
            padded_len=padded, max_len=max_len, max_new=int(max_new_tokens))
        logits0 = logits0.float()
        if temperature > 0:
            s.temp = torch.full((1,), float(temperature), device=dev)
            s.top_p = torch.full((1,), float(top_p), device=dev)
            s.stream = stream_keys(torch.full((1,), int(seed)), 0).to(dev)
            first = sample_rows(logits0, draw_keys(s.stream, 0), s.temp, s.top_p)
        else:
            first = torch.argmax(logits0, dim=-1)
        s.out[:1] = first
        s.done |= first[0] == eos
        if into is None:
            return s
        for name, value in vars(s).items():
            if isinstance(value, torch.Tensor):
                getattr(into, name).copy_(value)
        return into

    def cycle(self, s: SpecState) -> None:
        """One draft-k / verify-1 cycle over ``s``, in place. A finished row
        (``n_emitted >= max_new`` or eos emitted) makes it a no-op: no
        advance, no output write, and every KV write dropped. It reads
        nothing back to the host, so a CUDA graph can capture it."""
        k, eos = self.spec_k, self.eos_token_id
        dev = s.out.device
        live = ((s.n_emitted < s.max_new) & ~s.done).view(1)
        base = (s.n_emitted - 1).view(1)             # generated slot of cur
        sampling = None if s.temp is None else (s.temp, s.top_p)
        keys = None if s.temp is None else spec_keys(s.stream, s.n_emitted, k + 2)
        targets, n_acc, logits = draft_and_verify(
            self.tm, self.dm, s.t_cache, s.d_cache, s.out.gather(0, base), base, live,
            s.true_len, s.pos_base, s.padded_len, s.max_len, k, sampling, keys)
        s.logits.copy_(torch.where(live, logits[0], s.logits))
        targets, n_acc, live = targets[0], n_acc[0], live[0]

        # emit tau_0 .. tau_m (m = n_acc): the k + 1 candidates are written
        # at the cursor (those past m are rewritten later) and the cursor
        # advances by m + 1; a finished row writes its own values back
        at = torch.where(live, s.n_emitted, 0) + torch.arange(k + 1, device=dev)
        s.out.scatter_(0, at, torch.where(live, targets, s.out.gather(0, at)))
        valid = torch.arange(k + 1, device=dev) <= n_acc
        s.done |= live & (valid & (targets == eos)).any()
        step = torch.where(live, n_acc + 1, 0)
        s.n_emitted += step
        s.cycles += live.to(torch.int64)
        s.accepted += torch.where(live, n_acc, 0)

    @torch.inference_mode()
    def generate(self, input_ids: np.ndarray, pixel_patches=None,
                 grid_thw: Tuple[Tuple[int, int, int], ...] = (),
                 max_new_tokens: int = 128, prompt_bucket: int = 128,
                 temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
                 chunk: int = 8) -> np.ndarray:
        """input_ids (1, S) -> (1, max_new_tokens) tokens, eos-padded after
        the stop. ``temperature <= 0`` is the lossless greedy path, the
        target's own greedy decode token for token; otherwise proposals are
        drawn from the draft's filtered distribution and accepted by
        rejection sampling (``spec_accept``). The host reads the emitted
        count once every ``chunk`` cycles."""
        ids = np.asarray(input_ids)
        if ids.shape[0] != 1:
            raise ValueError("speculative decoding is the B=1 latency path; use "
                             "Qwen3VLGenerator for batches")
        max_new = int(max_new_tokens)
        temperature = float(temperature)
        top_p = float(top_p) if temperature > 0 else 1.0
        key = runner = None
        if self._target.replays:
            key = (-(-ids.shape[1] // prompt_bucket) * prompt_bucket, max_new, self.spec_k,
                   temperature > 0, self.kv_dtype)
            runner = self._graphs.pop(key, None)
        s = self.start(ids, pixel_patches, grid_thw, max_new, prompt_bucket, temperature,
                       top_p, seed, into=None if runner is None else runner.state)
        if runner is None:
            forwards = tuple(dict.fromkeys((self.tm.language_model, self.dm.language_model)))
            runner = StepGraph(self.cycle, s, s.out.device, forwards=forwards,
                               eager=not self._target.replays)
        # each live cycle emits at least one token, so max_new - 1 cycles end
        # every generation
        left = max_new - 1
        while left > 0 and not bool(((s.n_emitted >= max_new) | s.done).item()):
            n = min(chunk, left)
            runner.run(n)
            left -= n
        n_final = int(s.n_emitted)
        out = s.out.cpu().numpy()
        if key is not None:
            self._graphs[key] = runner
            while self._graphs and sum(
                    cache_bytes(r.state.t_cache) + cache_bytes(r.state.d_cache)
                    for r in self._graphs.values()) > qwen3_vl._KEPT_GRAPH_BYTES:
                self._graphs.popitem(last=False)
        # eos semantics as the plain generator's: after the first eos, or
        # past the emitted count, every position reads eos
        eos = self.eos_token_id
        out = np.where(np.arange(len(out)) < n_final, out, eos)
        hits = np.nonzero(out == eos)[0]
        if len(hits):
            out[hits[0]:] = eos
        return out[:max_new][None]
