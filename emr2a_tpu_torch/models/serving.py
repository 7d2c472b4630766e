"""Continuous batching for the judge (slot-based serving): a Qwen3-VL model,
or any with its interface (``models/kimi_vl.KimiVLModel``), which gives the
prompt's rope positions and the cache's layout and bytes.

Port of ``emr2a_tpu/models/serving.py`` with its names and its scheduler:
``n_slots`` requests decode together in chunks of ``chunk`` steps; between
chunks the host refills every finished slot from the queue, so a batch of
mixed output lengths never decodes at the pace of its slowest row. Each
slot owns a KV-cache region of ``max_len = prompt_bucket + max_new_tokens
+ 2 * chunk`` (two chunks of slack: a row whose budget runs out stays
active through the chunk already dispatched, and ``cache_write`` drops
anything past ``max_len`` as a last guard).

How JAX's mechanisms carry over:

- JAX's chunk program (a ``lax.scan`` of ``chunk`` steps in one jit)
  becomes one decode step captured in a CUDA graph
  (``models/cuda_graph.StepGraph``), one per batcher (slot count,
  ``max_len``, KV dtype) and wave kind (greedy or sampling), and replayed
  ``chunk`` times a dispatch; on a CPU tensor the step runs eagerly. The
  step's state (KV cache, pending tokens, generated counts, per-slot
  sampling state, the global step counter) is updated in place, so inserts
  and replays share one set of buffers. The batcher keeps that state and
  its graphs between waves and re-zeros the state at the start of each, so
  a later wave only replays. (Divergence: JAX releases the state after
  every wave and keeps only its compiled programs; here a graph is bound to
  its buffers. A failed wave and ``release()`` drop both; a backend
  releases its other batchers before serving with one.)
- Decode KV layout: the uniform ring (``ring_decode``, default) writes
  step s of every row at ``P + s mod R`` (R = max_len - P), a 0-d device
  offset (``cache_write``'s ``index_copy_``) with row validity in the
  mask; ``ring_decode=False`` keeps per-row offsets (a (B,) scatter).
  Both emit the same tokens.
- Lookahead: the next chunk is enqueued before this chunk's tokens are
  read; tokens come back through a pinned host buffer copied without
  blocking, and the host waits on the copy's event. Each chunk's tokens
  are credited against the slot map taken when it was dispatched, as JAX
  does; every host-to-device copy in the loop is non-blocking from pinned
  memory, so the host never waits on the queued chunk by accident.
- Refill prefills batch the head-of-queue run that shares one image
  layout in exact power-of-two sub-batches (``refill_batch``: short
  suffixes only, with a KV budget); a wave whose requests share a prefix
  of at least 16 tokens before the first image prefills it once and
  splices its KV under every request.
- Per-slot sampling state: each slot keeps the stream key of its
  request's seed (``qwen3_vl.stream_keys(seed, 0)``) and draws token g of
  its stream with ``draw_keys(key, g)``, so a sampled request's stream
  depends only on its seed, prompt and the model, not on its slot or its
  co-tenants, and equals the generator's at B = 1 with that seed on equal
  logits. (Divergence: JAX splits a ``jax.random`` key per slot; the
  distribution is the same, the tokens are not.)

- The speculative chunk (``draft_model``, JAX's ``_build_spec_chunk``):
  the slot state holds the draft's cache too, the shared prefix and every
  refill prefill run for both models, and an insert writes both caches. A
  chunk step is one draft-k / verify-1 cycle of every slot
  (``_spec_cycle`` over ``speculative.draft_and_verify``, the B = 1
  generator's cycle too; a frozen slot's KV writes are dropped): k + 1
  draft steps, one (B, k + 1)-token verify at
  per-row offsets (``cache_write``'s (B,) branch; speculative slots never
  take the ring), then the acceptance per row, greedy or mixed sampled
  (``spec_accept``, with each slot's keys of the cycle that starts at its
  generated count, ``qwen3_vl.spec_keys``). ``serve`` emits
  ``emitted[..., :n_acc + 1]`` per slot and cycle, and each request's
  first token at its insert; ``max_len``'s slack is ``2 * chunk * (k +
  1)``. The runner is kept by (``"spec"``, sampling) and captured like the
  plain chunk step.

Greedy parity: each request's stream is exactly what
``Qwen3VLGenerator.generate`` (B = 1, temperature 0) emits, with or
without a draft (``tests/test_torch_serving.py``,
``tests/test_torch_spec_serving.py``).

Tensor parallelism (``mesh``, JAX's): the target and the draft are served
over the mesh's ``model`` axis (``qwen3_vl.tensor_parallel``), and the slot
cache, the wave's shared-prefix cache, its broadcast to the refill rows and
the refill caches are ``ShardedCache``s of each card's kv heads, placed so
when allocated (JAX: ``_shard_cache``); an insert copies each card's rows
into its own part, and ``cache_write``'s per-row branch, which drops a
frozen slot's writes, runs unchanged on each card. Token streams are those
of ``mesh=None``. Above one card of the model axis the chunk step runs
eagerly, by design (``cuda_graph.StepGraph``'s ``eager``); a model axis of
one card is the plain path, graphs included.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from emr2a_tpu_torch.models.cuda_graph import StepGraph
from emr2a_tpu_torch.models.qwen3_vl import (
    Qwen3VLModel,
    auto_prefill_chunk,
    cache_tensors,
    chunked_prefill,
    draw_keys,
    map_cache,
    sample_rows,
    spec_keys,
    stream_keys,
    tensor_parallel,
)
from emr2a_tpu_torch.models.speculative import draft_and_verify
from emr2a_tpu_torch.parallel.tensor import model_axis_size
from emr2a_tpu_torch.utils.profiling import annotate, count

# A wave-level common prefix shorter than this is not worth its own
# prefill (chat headers alone are a handful of tokens; the audit template
# is hundreds): the JAX package's value.
_MIN_SHARED_PREFIX = 16

# Cap on the transient KV duplicate a batched refill prefill carries
# before its insert.
_REFILL_KV_BUDGET = 1 * 2**30

# Refills batch only when the per-row suffix prefill is short enough to be
# bound by the decoder's weight stream (the JAX package's threshold,
# measured on a TPU; not re-measured on the card).
_BATCH_REFILL_MAX_SUFFIX = 384


class ContinuousBatcher:
    """Slot-based continuous serving over one Qwen3-VL model, which holds
    its params (JAX: ``ContinuousBatcher(model, params, ...)``).

    ``prompt_bucket`` is the one static prompt length every request is
    padded to (longer requests are rejected); ``chunk`` is the decode
    steps per host round trip; ``prefill_chunk`` chunks refill prefills
    (None: each prefill's own ``auto_prefill_chunk``); ``shared_prefix``
    detects and shares a wave's common prefix; ``refill_batch`` caps a
    batched refill (None: the policy in ``serve``).

    ``draft_model`` (same vocabulary, holding its params; JAX's
    ``draft_model`` / ``draft_params``) turns every slot speculative: a
    chunk step becomes a draft-k / verify-1 cycle over all slots, so a
    chunk of C cycles emits C to C * (k + 1) tokens a slot. Greedy slots
    emit exactly their plain greedy streams; sampled slots go through
    rejection sampling (``qwen3_vl.spec_accept``), so mixed waves serve
    together.

    ``mesh`` (a ``parallel.Mesh``) serves the model, and the draft, over
    its ``model`` axis (see the module docstring); a ``ShardedQwen3VLModel``
    brings its own mesh."""

    def __init__(self, model: Qwen3VLModel, n_slots: int = 8,
                 prompt_bucket: int = 1024, max_new_tokens: int = 1024,
                 eos_token_id: int = 151645, kv_dtype: str = "bf16",
                 chunk: int = 16, draft_model: Optional[Qwen3VLModel] = None,
                 spec_k: int = 4, prefill_chunk: Optional[int] = None,
                 shared_prefix: bool = True, refill_batch: Optional[int] = None,
                 mesh=None, ring_decode: bool = True):
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be bf16 or int8: {kv_dtype}")
        self.mesh = getattr(model, "mesh", None) if mesh is None else mesh
        if self.mesh is not None:
            model = tensor_parallel(model, self.mesh)
            if draft_model is not None:
                draft_model = tensor_parallel(draft_model, self.mesh)
        self.model = model
        self.config = model.config
        self.n_slots = int(n_slots)
        self.prompt_bucket = int(prompt_bucket)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = int(eos_token_id)
        self.kv_dtype = kv_dtype
        self.chunk = int(chunk)
        self.draft_model = draft_model
        self.spec_k = int(spec_k)
        if draft_model is not None:
            if draft_model.config.text.vocab_size != model.config.text.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            if self.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
        # a speculative chunk step advances a slot by up to k + 1 positions
        self.per_iter = self.spec_k + 1 if draft_model is not None else 1
        self.max_len = (self.prompt_bucket + self.max_new_tokens
                        + 2 * self.chunk * self.per_iter)
        self._auto_chunk = prefill_chunk is None
        self.prefill_chunk = prefill_chunk
        self.shared_prefix = bool(shared_prefix)
        self._refill_batch_arg = refill_batch
        self.refill_batch = 1
        # speculative slots advance by their own accepted counts, so they
        # keep per-row offsets (JAX's rule)
        self.ring_decode = bool(ring_decode) and draft_model is None
        self._prefill_fns: Dict = {}
        self._prefix_fns: Dict = {}
        self._insert_fns: Dict[int, object] = {}
        self._state = None
        # by wave kind: sampling or not, ("spec", sampling) when speculative
        self._runners: Dict = {}
        self._wave_lp = 0
        self._wave_prefix = None
        self._wave_draft_prefix = None
        # request index -> its slot's records (``model.record_rows``), kept
        # by the latest wave of a model that records
        self.records: Dict[int, torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        return self.model.language_model.final_ln.weight.device

    # -- device state -------------------------------------------------------

    def _kv_bytes_per_row(self, model=None) -> int:
        """A slot's cache bytes, as the model lays its cache out."""
        return (model or self.model).cache_bytes_per_row(self.max_len, self.kv_dtype)

    def _fills(self) -> dict:
        """Each slot-state tensor but the cache: (shape, dtype, the value a
        wave starts from)."""
        B, cfg, eos = self.n_slots, self.config.text, self.eos_token_id
        return {
            "cur": ((B,), torch.int64, eos),
            "gen": ((B,), torch.int64, 0),
            "pos_base": ((B,), torch.int64, 0),
            "tl": ((B,), torch.int64, 1),
            # per-slot sampling state (temp <= 0 rows decode greedy)
            "streams": ((B,), torch.int64, 0),
            "temp": ((B,), torch.float32, 0.0),
            "top_p": ((B,), torch.float32, 1.0),
            # the global decode-step counter that drives the ring's write slot
            "step0": ((), torch.int64, 0),
            "act": ((B,), torch.bool, False),
            **({"toks": ((B, self.chunk, self.spec_k + 1), torch.int64, eos),
                "accs": ((B, self.chunk), torch.int64, 0),
                "logits": ((B, self.spec_k + 1, cfg.vocab_size), torch.float32, 0.0)}
               if self.draft_model is not None else
               {"toks": ((B, self.chunk), torch.int64, eos),
                "logits": ((B, cfg.vocab_size), cfg.dtype, 0.0)}),
        }

    def _init_state(self) -> dict:
        dev = self.device
        state = {"cache": self.model.empty_cache(self.n_slots, self.max_len, self.kv_dtype),
                 **{name: torch.full(shape, v, dtype=dt, device=dev)
                    for name, (shape, dt, v) in self._fills().items()}}
        if self.draft_model is not None:
            state["d_cache"] = self.draft_model.empty_cache(self.n_slots, self.max_len,
                                                            self.kv_dtype)
        return state

    def _reset_state(self) -> None:
        """The kept state back to ``_init_state``'s values, in place."""
        st = self._state
        for cache in (st["cache"], st.get("d_cache", [])):
            for buf in cache_tensors(cache):
                buf.zero_()
        for name, (_, _, v) in self._fills().items():
            st[name].fill_(v)

    def release(self) -> None:
        """Drop the slot state and the graphs captured over it; the next
        wave allocates and captures them again."""
        self._state, self._runners = None, {}

    def _to_device(self, x, dtype) -> torch.Tensor:
        """A host array on the model's device; on a CUDA device through
        pinned memory without blocking (the caching host allocator keeps the
        pinned block until the copy has run)."""
        t = torch.as_tensor(np.asarray(x)).to(dtype)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- the programs ---------------------------------------------------------

    def _fit_chunk(self, seq_len: int, batch: int) -> Optional[int]:
        """Prefill chunk for a (batch, seq_len) prefill, or None for one
        shot: the auto policy, or the explicit ``prefill_chunk`` rounded down
        to a divisor of ``seq_len``; a floor below half the request (a prime
        suffix) leaves the choice to the auto policy."""
        if seq_len <= 1:
            return None
        if self._auto_chunk:
            return auto_prefill_chunk(batch, self.config.text.num_heads, seq_len,
                                      self.max_len)
        C = self.prefill_chunk
        if not C or C >= seq_len:
            return None
        requested = C
        while seq_len % C:
            C -= 1
        if C * 2 < requested:
            return auto_prefill_chunk(batch, self.config.text.num_heads, seq_len,
                                      self.max_len)
        return C

    def _shared_prefix_len(self, requests: Sequence[dict]) -> int:
        """Longest common token prefix of the wave, clipped before the first
        image token and so that every request keeps a suffix; 0 when sharing
        is off, the wave is one request or the prefix is under
        ``_MIN_SHARED_PREFIX``."""
        if not self.shared_prefix or len(requests) < 2:
            return 0
        rows = [np.asarray(r["input_ids"]).reshape(-1) for r in requests]
        lcp = min(len(r) for r in rows) - 1
        if lcp <= 0:
            return 0
        r0 = rows[0]
        for r in rows[1:]:
            neq = np.nonzero(r0[:lcp] != r[:lcp])[0]
            if neq.size:
                lcp = int(neq[0])
                if lcp <= 0:
                    return 0
        img = np.nonzero(r0[:lcp] == self.config.image_token_id)[0]
        if img.size:
            lcp = int(img[0])
        return lcp if lcp >= _MIN_SHARED_PREFIX else 0

    def _build_prefix(self, Lp: int, draft: bool = False):
        """Prefill of the Lp-token shared prefix (text only by construction)
        into a fresh one-row cache of the target (or the draft), once per
        wave."""
        model = self.draft_model if draft else self.model
        L, C = self.max_len, self._fit_chunk(Lp, 1)

        def run(input_ids, position_ids):
            dev = input_ids.device
            cache = model.empty_cache(1, L, self.kv_dtype)
            tl = torch.full((1,), Lp, dtype=torch.int64, device=dev)
            if C and Lp > C:
                _, cache = chunked_prefill(model, input_ids, position_ids, tl, None, (),
                                           Lp, L, cache, C)
            else:
                q_idx = torch.arange(Lp, device=dev)[None, :, None]
                k_idx = torch.arange(L, device=dev)[None, None, :]
                mask = torch.where((k_idx <= q_idx) & (k_idx < Lp), 0.0,
                                   float("-inf")).float()
                _, cache = model(input_ids, position_ids, cache=cache, cache_pos=0,
                                 attn_mask=mask, return_hidden=True)
            return cache

        return run

    def _build_prefill(self, grid_thw, Lp: int, Bp: int, draft: bool = False):
        """Prefill of Bp requests' suffixes [Lp, bucket) in one pass, each
        row starting from the wave's shared-prefix cache when Lp > 0.
        Returns (cache, last-position f32 logits); the draft's variant only
        the cache (its first proposal comes from feeding the target's first
        token)."""
        model = self.draft_model if draft else self.model
        P, L = self.prompt_bucket, self.max_len
        S2 = P - Lp
        C = self._fit_chunk(S2, Bp)

        def run(prefix_cache, input_ids, position_ids, true_len, pixel_patches):
            dev = input_ids.device
            if Lp:
                cache = map_cache(lambda b: b.repeat(Bp, *([1] * (b.dim() - 1))),
                                  prefix_cache)
            else:
                cache = model.empty_cache(Bp, L, self.kv_dtype)
            if C and S2 > C:
                hidden, cache = chunked_prefill(model, input_ids, position_ids, true_len,
                                                pixel_patches, grid_thw, S2, L, cache, C,
                                                start=Lp)
            else:
                q_idx = Lp + torch.arange(S2, device=dev)[None, :, None]
                k_idx = torch.arange(L, device=dev)[None, None, :]
                mask = torch.where((k_idx <= q_idx) & (k_idx < true_len[:, None, None]),
                                   0.0, float("-inf")).float()
                hidden, cache = model(input_ids, position_ids, pixel_patches=pixel_patches,
                                      grid_thw=grid_thw, cache=cache, cache_pos=Lp,
                                      attn_mask=mask, return_hidden=True)
            if draft:
                return cache
            last = hidden[torch.arange(Bp, device=dev), true_len - 1 - Lp]
            return cache, model.language_model.project(last).float()

        return run

    def _build_insert(self, Bp: int):
        """Write Bp freshly prefilled rows (and the draft's, when
        speculative) into their slots of the state, in place, and draw each
        one's first token from its prefill logits with its slot's sampling
        config (temp <= 0: the argmax). Returns the first tokens."""
        def run(cacheB, logits, pos_base, true_len, slots, streams, temp, top_p,
                d_cacheB=None):
            st = self._state
            pairs = [(st["cache"], cacheB)]
            if d_cacheB is not None:
                pairs.append((st["d_cache"], d_cacheB))
            # each card's part of a sharded cache takes the slots there
            on = {slots.device: slots}

            def put(buf, rows):
                if buf.device not in on:
                    on[buf.device] = slots.to(buf.device)
                return buf.index_copy_(0, on[buf.device], rows)

            for cache, rowsB in pairs:
                map_cache(put, cache, rowsB)
            first = sample_rows(logits, draw_keys(streams, 0), temp, top_p)
            for name, value in (("cur", first), ("pos_base", pos_base), ("tl", true_len),
                                ("streams", streams), ("temp", temp), ("top_p", top_p)):
                st[name].index_copy_(0, slots, value)
            st["gen"].index_fill_(0, slots, 0)
            return first

        return run

    def _chunk_step(self, sampling: bool, st: dict) -> None:
        """One decode step of every slot, in place (the body of JAX's chunk
        scan): feed each slot's pending token, record it in ``toks``
        (column ``step0 mod chunk``), draw the next (greedy, or per row with
        the slot's key at its generated count + 1), freeze the rows that fed
        eos and count the step. It reads nothing back to the host."""
        P, L, eos = self.prompt_bucket, self.max_len, self.eos_token_id
        B, dev = st["cur"].shape[0], st["cur"].device
        s, gen, cur, act = st["step0"], st["gen"], st["cur"], st["act"]
        pos = (st["pos_base"] + gen)[None, :, None].expand(self.model.position_axes, B, 1)
        k_idx = torch.arange(L, device=dev)[None, None, :]
        visible = k_idx < st["tl"][:, None, None]
        if self.ring_decode:
            # slot q of the ring holds the row's own token of age (s - q)
            # mod R: visible iff that age is within the row's generated count
            R = L - P
            age = torch.remainder(s - (k_idx - P), R)
            visible = visible | ((k_idx >= P) & (age <= gen[:, None, None]))
            write = P + torch.remainder(s, R)
        else:
            visible = visible | ((k_idx >= P) & (k_idx <= (P + gen)[:, None, None]))
            write = P + gen
        mask = torch.where(visible, 0.0, float("-inf")).float()
        logits, _ = self.model(cur[:, None], pos, cache=st["cache"], cache_pos=write,
                               attn_mask=mask)
        last = st["logits"]
        last.copy_(logits[:, -1])
        if sampling:
            nxt = sample_rows(last, draw_keys(st["streams"], gen + 1), st["temp"],
                              st["top_p"])
        else:
            nxt = torch.argmax(last, dim=-1)
        st["toks"].index_copy_(1, torch.remainder(s, self.chunk).view(1), cur[:, None])
        act &= cur != eos
        cur.copy_(torch.where(act, nxt, eos))
        gen.copy_(torch.where(act, gen + 1, gen))
        s += 1

    def _spec_cycle(self, sampling: bool, st: dict) -> None:
        """One draft-k / verify-1 cycle of every slot, in place (the body of
        JAX's ``_build_spec_chunk`` scan): k + 1 draft steps for every slot
        (the pending token, then its own proposals), one (B, k + 1)-token
        verify of the target at per-row offsets, the acceptance per row
        (greedy: the longest argmax-matching prefix; sampling: ``spec_accept``
        with the slot's keys of the cycle that starts at its generated count,
        ``spec_keys``), and each active slot's advance by its accepted count
        plus one. Its emissions go to ``toks[:, step0 mod chunk]`` and their
        accepted counts to ``accs``; rows whose pending token was eos stay
        frozen and a row that emits eos freezes after the cycle. It reads
        nothing back to the host."""
        eos, k = self.eos_token_id, self.spec_k
        cur, gen, act = st["cur"], st["gen"], st["act"]
        dev = cur.device
        act &= cur != eos
        sampling = (st["temp"], st["top_p"]) if sampling else None
        keys = None if sampling is None else spec_keys(st["streams"], gen, k + 2)
        emitted, n_acc, logits = draft_and_verify(
            self.model, self.draft_model, st["cache"], st["d_cache"], cur, gen, act, st["tl"],
            st["pos_base"], self.prompt_bucket, self.max_len, k, sampling, keys)
        st["logits"].copy_(logits)
        valid = torch.arange(k + 1, device=dev)[None, :] <= n_acc[:, None]
        hit = (valid & (emitted == eos)).any(dim=1)
        emitted = torch.where(act[:, None], emitted, eos)
        n_acc = torch.where(act, n_acc, 0)
        column = torch.remainder(st["step0"], self.chunk).view(1)
        st["toks"].index_copy_(1, column, emitted[:, None, :])
        st["accs"].index_copy_(1, column, n_acc[:, None])
        cur.copy_(torch.where(act, emitted.gather(1, n_acc[:, None])[:, 0], eos))
        gen.copy_(torch.where(act, gen + n_acc + 1, gen))
        act &= ~hit
        st["step0"] += 1

    # -- host scheduler -------------------------------------------------------

    def _prefill_inputs(self, req: dict):
        """Host-side suffix inputs of one request: (grid, ids and positions
        over [wave prefix, bucket), the whole sequence's true length, the
        next rope position, patches)."""
        ids = np.asarray(req["input_ids"])
        if ids.ndim == 1:
            ids = ids[None]
        if ids.shape[0] != 1:
            raise ValueError("one request = one row; batching is the batcher's job")
        seq_len = ids.shape[1]
        if seq_len > self.prompt_bucket:
            raise ValueError(f"prompt length {seq_len} exceeds the serving bucket "
                             f"{self.prompt_bucket}")
        grid_thw = self._grid_key(req)
        position_ids = self.model.position_ids(ids, grid_thw)
        pos_base = int(position_ids.max()) + 1
        if seq_len < self.prompt_bucket:
            pad = self.prompt_bucket - seq_len
            ids = np.pad(ids, [(0, 0), (0, pad)])
            position_ids = np.pad(position_ids, [(0, 0), (0, 0), (0, pad)])
        Lp = self._wave_lp
        patches = req.get("pixel_patches")
        return (grid_thw, ids[:, Lp:], position_ids[:, :, Lp:], seq_len, pos_base,
                np.asarray(patches) if patches is not None else None)

    @staticmethod
    def _grid_key(req: dict):
        return tuple(tuple(int(x) for x in g) for g in req.get("grid_thw", ()) or ())

    def _prefill_batch(self, rows: List[tuple], Bp: int, draft: bool = False):
        """One batched suffix prefill over Bp ``_prefill_inputs`` rows, of
        the target or the draft."""
        ids = self._to_device(np.concatenate([r[1] for r in rows], axis=0), torch.int64)
        pos = self._to_device(np.concatenate([r[2] for r in rows], axis=1), torch.int64)
        tl = self._to_device([r[3] for r in rows], torch.int64)
        patches = None
        if rows[0][5] is not None:
            patches = self._to_device(np.concatenate([r[5] for r in rows], axis=0),
                                      self.config.vision.dtype)
        if patches is not None and draft:
            patches = patches.to(self.draft_model.config.vision.dtype)
        grid_thw = rows[0][0] * Bp
        key = (grid_thw, self._wave_lp, Bp, draft)
        if key not in self._prefill_fns:
            self._prefill_fns[key] = self._build_prefill(grid_thw, self._wave_lp, Bp, draft)
        prefix = self._wave_draft_prefix if draft else self._wave_prefix
        return self._prefill_fns[key](prefix, ids, pos, tl, patches)

    def _prefill_shared_prefix(self, requests: Sequence[dict]) -> None:
        """Per-wave shared-prefix setup: detect the common prefix and
        prefill it once for the target (and the draft)."""
        self._wave_lp = self._shared_prefix_len(requests)
        self._wave_prefix = self._wave_draft_prefix = None
        if not self._wave_lp:
            return
        Lp = self._wave_lp
        ids = np.asarray(requests[0]["input_ids"]).reshape(1, -1)[:, :Lp]
        # image-free, so its rope positions are the same alone as inside
        # every request's whole sequence
        pos = self.model.position_ids(ids, ())
        if Lp not in self._prefix_fns:
            self._prefix_fns[Lp] = self._build_prefix(Lp)
        ids, pos = self._to_device(ids, torch.int64), self._to_device(pos, torch.int64)
        self._wave_prefix = self._prefix_fns[Lp](ids, pos)
        if self.draft_model is not None:
            if (Lp, True) not in self._prefix_fns:
                self._prefix_fns[Lp, True] = self._build_prefix(Lp, draft=True)
            self._wave_draft_prefix = self._prefix_fns[Lp, True](ids, pos)

    def _fetch(self, *tensors: torch.Tensor):
        """Start copying a chunk's outputs to the host: (host tensors, event
        to wait on, None on the CPU)."""
        if tensors[0].device.type != "cuda":
            return [t.clone() for t in tensors], None
        hosts = []
        for t in tensors:
            hosts.append(torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
            hosts[-1].copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return hosts, event

    @torch.inference_mode()
    def serve(self, requests: Sequence[dict],
              max_new_tokens: Optional[int] = None) -> List[np.ndarray]:
        """Run every request through the slot server; returns, in request
        order, each request's tokens shaped like the plain generator's row
        ((budget,) eos-padded after the stop).

        Request dicts: ``input_ids`` (1, S) or (S,); optional
        ``pixel_patches`` / ``grid_thw``; optional per-request
        ``max_new_tokens``, ``temperature`` (default 0 = greedy), ``top_p``
        and ``seed`` (default: the request's index). Slots with mixed
        temperatures serve together; greedy rows still match the plain
        generator exactly.

        Traced (``utils/profiling``), a wave is the span ``batcher.wave``
        over ``batcher.shared_prefix``, each refill sub-batch's
        ``batcher.refill`` (its ``batcher.prefill``, with the requests'
        indices, and ``batcher.insert``), each chunk's ``batcher.dispatch``,
        the host's ``batcher.wait_tokens`` on its copy and
        ``batcher.emit``; the counters are ``batcher.refills`` (sub-batches),
        ``batcher.prefill_rows``, ``batcher.dispatches`` and
        ``batcher.lookahead_dispatches``, and ``decode.steps`` (each a
        forward of every slot; k + 1 a speculative cycle),
        ``decode.row_steps`` (slots times steps), ``decode.active_row_steps``
        (those of slots holding a request at dispatch) and
        ``decode.tokens_kept`` (the tokens the requests were served).

        A model with ``record_rows`` (Kimi-VL recording its routes) has
        each request's slot records copied as the request retires, into
        ``self.records`` by request index."""
        with annotate("batcher.wave"):
            return self._serve(requests, max_new_tokens)

    def _serve(self, requests: Sequence[dict],
               max_new_tokens: Optional[int]) -> List[np.ndarray]:
        sampling = any(float(r.get("temperature") or 0.0) > 0 for r in requests)
        spec = self.draft_model is not None
        budgets = [min(int(r.get("max_new_tokens") or max_new_tokens or self.max_new_tokens),
                       self.max_new_tokens) for r in requests]
        emitted: List[List[int]] = [[] for _ in requests]
        done = [False] * len(requests)
        slot_req: List[Optional[int]] = [None] * self.n_slots
        active = np.zeros((self.n_slots,), bool)
        queue = list(range(len(requests)))
        eos = self.eos_token_id
        # a model that keeps records in its cache (``record_rows``) has the
        # retiring slot's copied, in stream order before a refill reuses it
        keep = getattr(self.model, "record_rows", None)
        self.records = {}

        def refill():
            # The head-of-queue run with one image layout prefills together,
            # in exact power-of-two sub-batches, largest first (no row is a
            # pad: prefill compute is about linear in rows).
            while queue:
                free = [s for s in range(self.n_slots) if slot_req[s] is None]
                if not free:
                    return
                g0 = self._grid_key(requests[queue[0]])
                take = [queue.pop(0)]
                cap = min(len(free), self.refill_batch)
                while queue and len(take) < cap and self._grid_key(requests[queue[0]]) == g0:
                    take.append(queue.pop(0))
                while take:
                    Bp = 1 << (len(take).bit_length() - 1)
                    sub, take = take[:Bp], take[Bp:]
                    slots, free = free[:Bp], free[Bp:]
                    with annotate("batcher.refill"):
                        first = refill_batch(sub, slots, Bp)
                    count("batcher.refills")
                    count("batcher.prefill_rows", Bp)
                    # the speculative cycle emits only verified tokens after
                    # the pending one, so each request's first token is
                    # emitted here: one read a refill sub-batch
                    firsts = first.cpu().numpy() if spec else None
                    for i, r in enumerate(sub):
                        if spec and emit_row(r, firsts[i:i + 1]):
                            free.append(slots[i])    # done at once: the slot stays free
                            continue
                        slot_req[slots[i]] = r
                        active[slots[i]] = True

        def refill_batch(sub, slots, Bp):
            # one batched prefill of the requests ``sub`` and its insert into
            # ``slots``; returns their first tokens
            rows = [self._prefill_inputs(requests[r]) for r in sub]
            with annotate("batcher.prefill", request=tuple(sub), device=self.device):
                cacheB, logits = self._prefill_batch(rows, Bp)
                d_cacheB = self._prefill_batch(rows, Bp, draft=True) if spec else None
            seeds = [int(requests[r]["seed"]) if requests[r].get("seed") is not None
                     else r for r in sub]
            if Bp not in self._insert_fns:
                self._insert_fns[Bp] = self._build_insert(Bp)
            with annotate("batcher.insert"):
                return self._insert_fns[Bp](
                    cacheB, logits,
                    self._to_device([r[4] for r in rows], torch.int64),
                    self._to_device([min(r[3], self.prompt_bucket) for r in rows],
                                    torch.int64),
                    self._to_device(slots, torch.int64),
                    self._to_device(stream_keys(torch.tensor(seeds), 0), torch.int64),
                    self._to_device([float(requests[r].get("temperature") or 0.0)
                                     for r in sub], torch.float32),
                    self._to_device([float(requests[r].get("top_p") or 1.0)
                                     for r in sub], torch.float32),
                    d_cacheB)

        def emit_row(r, tokens) -> bool:
            for t in tokens:
                emitted[r].append(int(t))
                if int(t) == eos or len(emitted[r]) >= budgets[r]:
                    done[r] = True
                    return True
            return False

        def dispatch():
            steps = self.chunk * self.per_iter
            count("batcher.dispatches")
            count("decode.steps", steps)
            count("decode.row_steps", self.n_slots * steps)
            count("decode.active_row_steps", int(active.sum()) * steps)
            with annotate("batcher.dispatch", device=self.device):
                self._state["act"].copy_(self._to_device(active, torch.bool))
                runner.run(self.chunk)
                if spec:
                    return self._fetch(self._state["toks"], self._state["accs"])
                return self._fetch(self._state["toks"])

        def lookahead_ok() -> bool:
            # Enqueue the next chunk before reading this one, hiding one
            # round trip a chunk. Main phase: not when a slot's budget runs
            # out within this chunk (its refill would wait a whole chunk);
            # tail phase (empty queue): while a slot outlives both chunks.
            rem = [budgets[r] - len(emitted[r]) for r in slot_req if r is not None]
            if not rem:
                return False
            if queue:
                return min(rem) > self.chunk * self.per_iter
            return max(rem) > 2 * self.chunk * self.per_iter

        if self._state is None:
            self._state = self._init_state()
        else:
            self._reset_state()
        try:
            with annotate("batcher.shared_prefix", device=self.device):
                self._prefill_shared_prefix(requests)
            # the refill-batch policy for this wave's suffix length: short
            # suffixes batch under the KV budget, long ones serialize
            if self._refill_batch_arg is not None:
                rb = int(self._refill_batch_arg)
            elif self.prompt_bucket - self._wave_lp <= _BATCH_REFILL_MAX_SUFFIX:
                per_row = self._kv_bytes_per_row()
                if spec:
                    per_row += self._kv_bytes_per_row(self.draft_model)
                rb = max(1, _REFILL_KV_BUDGET // per_row)
            else:
                rb = 1
            self.refill_batch = max(1, min(rb, self.n_slots))
            key = ("spec", sampling) if spec else sampling
            runner = self._runners.get(key)
            if runner is None:
                step, forwards = self._chunk_step, (self.model.language_model,)
                if spec:
                    step = self._spec_cycle
                    forwards = tuple(dict.fromkeys(
                        forwards + (self.draft_model.language_model,)))
                runner = self._runners[key] = StepGraph(
                    functools.partial(step, sampling), self._state, self.device,
                    forwards=forwards, eager=model_axis_size(self.mesh) > 1)
            refill()
            pending = None   # (chunk tokens in flight, slot map at dispatch)
            while any(r is not None for r in slot_req):
                if pending is not None:
                    (fetch, snap), pending = pending, None
                else:
                    snap = list(slot_req)
                    fetch = dispatch()
                # a finished slot stays active through a chunk already
                # dispatched, one chunk deeper: max_len's 2 * chunk slack
                if lookahead_ok():
                    count("batcher.lookahead_dispatches")
                    pending = (dispatch(), list(slot_req))
                hosts, event = fetch
                if event is not None:
                    with annotate("batcher.wait_tokens"):
                        event.synchronize()
                with annotate("batcher.emit"):
                    if spec:    # (slots, chunk, k + 1) emissions, (slots, chunk) accepted
                        toks, accs = (h.numpy() for h in hosts)
                    else:
                        toks = hosts[0].numpy()[:, :, None]
                        accs = np.zeros(toks.shape[:2], np.int64)
                    for s in range(self.n_slots):
                        r = snap[s]
                        if r is None or done[r]:
                            continue
                        for c in range(toks.shape[1]):
                            if emit_row(r, toks[s, c, :int(accs[s, c]) + 1]):
                                break
                        if done[r] and slot_req[s] == r:
                            slot_req[s] = None
                            active[s] = False
                            if keep is not None:
                                self.records[r] = keep(self._state["cache"], s)
                refill()
        except BaseException:
            # a failed wave may leave a graph or the state half written
            self.release()
            raise
        finally:
            self._wave_prefix = self._wave_draft_prefix = None
            self._wave_lp = 0

        count("decode.tokens_kept", sum(len(e) for e in emitted))
        out = []
        for r, toks_r in enumerate(emitted):
            row = np.full((budgets[r],), eos, np.int64)
            row[:len(toks_r)] = toks_r[:budgets[r]]
            hits = np.where(row == eos)[0]
            if len(hits):
                row[hits[0]:] = eos
            out.append(row)
        return out
