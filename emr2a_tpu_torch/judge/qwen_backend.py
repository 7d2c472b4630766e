"""Qwen3-VL generation backend: the production judge engine.

Port of ``emr2a_tpu/judge/qwen_backend.py``: chat-template the prompt with
one image placeholder per image, patchify each image
(``encoders/qwen3_vl_encoder.make_image_processor``), expand the
placeholders to each image's token count, then prefill + decode on
``device`` and decode the text. ``generate`` serves one request, greedy or
sampled, and ``generate_batch`` a static batch of them
(``models/qwen3_vl.Qwen3VLGenerator``, rows of mixed length through
``true_lens``); ``generate_stream`` serves them through continuous
batching (``models/serving.ContinuousBatcher``) with per-request sampling
and budgets. On the card every decode step replays a CUDA graph.

``precision``: "bf16" (the vision attention on K8), "int8" (adds every
decoder projection on K5), "int4" (adds every decoder projection on K7) or
"int4_awq" (int4 after the activation-aware scale fold of
``models/awq.py``, calibrated on 4 x 256 ids of the judge's own prompt
templates: the same kernels on folded weights). The weights are quantized
where they lie (on the card, by the quantizers' torch twins; AWQ's search
and fold run there too). ``kv_dtype="int8"`` keeps the KV cache in s8 with
scales and ``prefill_chunk`` chunks the prompt's prefill
(``models/qwen3_vl.py``).

A draft (``draft_model_path``, or ``draft_config`` / ``draft_params``),
quantized at the judge's precision, turns on speculative decoding: a
single ``generate`` goes through ``models/speculative.SpeculativeGenerator``
(``spec_k`` proposals a cycle, greedy or sampled), ``generate_stream``
through the batcher's speculative chunk, and ``generate_batch`` ignores the
draft, as JAX's does.

``tp=N`` serves tensor-parallel over N cards: the mesh is ``create_mesh((n
// N, N))`` over every visible card (``parallel.default_mesh``'s devices;
on the CPU, ``force_cpu_devices``'), N must divide n (JAX's
``ValueError``), and the target and the draft are sharded over its
``model`` axis (``models/qwen3_vl.tensor_parallel``), for the generator,
the speculative generator and every continuous batcher, with the KV
caches sharded on their kv heads. The token streams equal ``tp=1``'s in
f32 and on the CPU's tiny models; in bf16 the row-parallel sums round
differently from one card's product, so a greedy stream is equal or first
differs at a near-tie of the logits. Above one card decode runs eagerly
(no CUDA graph).

``params`` is a state dict of this package (``models/qwen3_vl.random_state``,
``params_from_jax``), with its ``config``, and the model runs where its
tensors lie; without them the checkpoint at ``model_path`` is read
(``models/checkpoint.py``) onto ``device``. A
``tokenizer`` may be passed; otherwise ``transformers`` is imported, only
then, and reads the checkpoint's tokenizer with ``local_files_only=True``.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

from emr2a_tpu_torch.models.convert import params_from_jax, params_to_jax
from emr2a_tpu_torch.models.qwen3_vl import (
    Qwen3VLGenerator,
    Qwen3VLModel,
    compute_mrope_position_ids,
    tensor_parallel,
)
from emr2a_tpu_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)


def tp_mesh(tp: int):
    """The ``(n // tp, tp)`` mesh over every visible card (the default
    mesh's devices), or None for ``tp <= 1``; ``ValueError`` where ``tp``
    does not divide n (JAX's)."""
    if not tp or int(tp) <= 1:
        return None
    from emr2a_tpu_torch.parallel import create_mesh, default_mesh
    from emr2a_tpu_torch.parallel.mesh import require_local
    require_local(default_mesh(), "tp")
    devices = list(default_mesh().devices.flat)
    n = len(devices)
    if n % int(tp):
        raise ValueError(f"tp={tp} does not divide the {n}-device slice")
    return create_mesh((n // int(tp), int(tp)), devices=devices)


def _calib_ids_from_tokenizer(tokenizer, vocab_size: int, batch: int = 4, seq: int = 256):
    """AWQ's calibration batch: the judge's own prompt templates
    (``judge/prompts``' strings over 200 characters), tokenized and cut to
    (batch, seq); random ids from ``RandomState(0)`` fill what the
    tokenizer falls short of. (JAX's ``dir()`` scan also takes its prompts
    module's docstring; the port reads the templates only.)"""
    from emr2a_tpu_torch.judge import prompts
    texts = [v for name, v in sorted(vars(prompts).items())
             if not name.startswith("_") and isinstance(v, str) and len(v) > 200]
    ids: List[int] = []
    for t in texts:
        try:
            ids.extend(tokenizer(t, add_special_tokens=False)["input_ids"])
        except Exception:
            break
    if len(ids) < batch * seq:
        rng = np.random.RandomState(0)
        ids = ids + rng.randint(2, max(3, vocab_size - 2), (batch * seq - len(ids),)).tolist()
    return np.asarray(ids[:batch * seq], np.int64).reshape(batch, seq)


def quantize_decoder(state, precision: str, model=None, tokenizer=None):
    """The decoder projections of a state dict in W8A8 / W4A8 (int4_awq:
    folded first, calibrated through ``model``, a ``Qwen3VLModel`` over
    ``state``, on ``tokenizer``'s ids), quantized where the weights lie;
    every other tensor is shared, not copied."""
    if precision == "bf16":
        return state
    if precision not in ("int8", "int4", "int4_awq"):
        raise ValueError(
            f"precision must be bf16|int8|int4|int4_awq, got {precision!r}")
    if precision == "int4":
        logger.warning(
            "precision=int4 is EXPERIMENTAL: group-128 4-bit RTN weights carry "
            "a real accuracy cost; validate audit quality on your cohort, use "
            "int4_awq (activation-aware folding, models/awq.py) to claw back "
            "most of the RTN error, or use int8")
    tree = params_to_jax(state)
    if precision == "int4_awq":
        if model is None:
            raise ValueError("int4_awq needs the model for calibration")
        from emr2a_tpu_torch.models.awq import awq_quantize_qwen_text_params
        calib = _calib_ids_from_tokenizer(tokenizer, model.config.text.vocab_size)
        tree, report = awq_quantize_qwen_text_params(model, tree, calib, return_report=True)
        taken = [e["alpha"][s] for e in report.values() for s in ("qkv", "o", "gu", "down")]
        logger.info("int4_awq: calibrated on %d tokens; alpha>0 at %d/%d sites",
                    calib.size, sum(1 for a in taken if a > 0), len(taken))
        return params_from_jax(tree)
    from emr2a_tpu_torch.models.quantize import quantize_qwen_text_params
    tree["language_model"] = quantize_qwen_text_params(
        tree["language_model"], precision=precision)
    return params_from_jax(tree)


def _quantized_model(config, params, precision: str, tokenizer) -> Qwen3VLModel:
    """The model over ``params`` at ``precision`` (int4_awq calibrates on a
    bf16 model over the same tensors, no copy)."""
    bf16 = Qwen3VLModel.from_params(config, params) if precision == "int4_awq" else None
    return Qwen3VLModel.from_params(
        config, quantize_decoder(params, precision, model=bf16, tokenizer=tokenizer))


class QwenVLBackend:

    def __init__(self, model_path: Optional[str] = None, device: str = "cuda",
                 config=None, params=None, tokenizer=None,
                 image_processor=None, prompt_bucket: int = 128,
                 precision: str = "bf16",
                 standardize_images: Optional[int] = None,
                 kv_dtype: str = "bf16",
                 draft_model_path: Optional[str] = None, draft_config=None,
                 draft_params=None, spec_k: int = 4,
                 decode_chunk: Optional[int] = 64,
                 prefill_chunk: Optional[int] = None, tp: int = 1,
                 cache_params: bool = True):
        self.mesh = tp_mesh(tp)
        self.model_path = model_path
        self.prompt_bucket = prompt_bucket
        self.standardize_images = standardize_images
        self.decode_chunk = decode_chunk
        if params is None:
            from emr2a_tpu_torch.models.checkpoint import load_qwen3_vl
            config, params = load_qwen3_vl(model_path, cache_params=cache_params)
            params = {k: v.to(device) for k, v in params.items()}
        if config is None:
            raise ValueError("params need their config")
        if tokenizer is None and model_path is not None:
            from transformers import AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(str(model_path),
                                                      local_files_only=True)
        if image_processor is None:
            from emr2a_tpu_torch.encoders.qwen3_vl_encoder import make_image_processor
            image_processor = make_image_processor(config.vision)
        self.config = config
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.model = _quantized_model(config, params, precision, tokenizer)
        if self.mesh is not None:
            self.model = tensor_parallel(self.model, self.mesh)
        eos = getattr(tokenizer, "eos_token_id", None) or 151645
        self.generator = Qwen3VLGenerator(self.model, eos_token_id=int(eos),
                                          kv_dtype=kv_dtype,
                                          prefill_chunk=prefill_chunk)
        self._batchers = {}
        self.spec_generator = None
        if draft_model_path is not None or draft_params is not None:
            from emr2a_tpu_torch.models.speculative import SpeculativeGenerator
            if draft_params is None:
                from emr2a_tpu_torch.models.checkpoint import load_qwen3_vl
                draft_config, draft_params = load_qwen3_vl(draft_model_path,
                                                           cache_params=cache_params)
                draft_params = {k: v.to(device) for k, v in draft_params.items()}
            if draft_config is None:
                raise ValueError("draft_params need their config")
            draft = _quantized_model(draft_config, draft_params, precision, tokenizer)
            if self.mesh is not None:
                draft = tensor_parallel(draft, self.mesh)
            self.spec_generator = SpeculativeGenerator(self.model, draft, spec_k=spec_k,
                                                       eos_token_id=int(eos),
                                                       kv_dtype=kv_dtype)

    # -- prompt assembly --

    def _render_chat(self, n_images: int, prompt: str,
                     system: Optional[str]) -> str:
        """Chat template with one image placeholder per image (the
        tokenizer's template where it has one)."""
        content = [{"type": "image"}] * n_images + [
            {"type": "text", "text": prompt}]
        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": content})
        if hasattr(self.tokenizer, "apply_chat_template"):
            try:
                return self.tokenizer.apply_chat_template(
                    messages, tokenize=False, add_generation_prompt=True)
            except Exception:
                pass
        sys_part = f"<|im_start|>system\n{system}<|im_end|>\n" if system else ""
        img_part = "<|vision_start|><|image_pad|><|vision_end|>" * n_images
        return (f"{sys_part}<|im_start|>user\n{img_part}{prompt}<|im_end|>\n"
                f"<|im_start|>assistant\n")

    def _expand_image_tokens(self, ids: List[int],
                             tokens_per_image: List[int]) -> List[int]:
        """Replace each single image_pad token with its per-image count."""
        out: List[int] = []
        img_i = 0
        image_token = self.config.image_token_id
        for t in ids:
            if t == image_token and img_i < len(tokens_per_image):
                out.extend([image_token] * tokens_per_image[img_i])
                img_i += 1
            else:
                out.append(t)
        return out

    def _standardized(self, img) -> np.ndarray:
        """An image as an array, resized to ``standardize_images`` square
        when set."""
        if self.standardize_images:
            n = self.standardize_images
            from PIL import Image
            if not isinstance(img, Image.Image):
                img = Image.fromarray(np.asarray(img))
            img = img.resize((n, n))
        return np.asarray(img)

    def _prepare(self, images: Sequence, prompt: str, system: Optional[str],
                 request=None):
        """One request -> (ids, patches, grids), in the span
        ``judge.prepare`` (with ``request``, the request's id) and its
        stages ``.resize``, ``.patches`` and ``.tokens``."""
        merge = self.config.vision.spatial_merge_size
        with annotate("judge.prepare", request=request):
            with annotate("judge.prepare.resize"):
                arrays = [self._standardized(img) for img in images]
            grids: List[Tuple[int, int, int]] = []
            tokens_per_image = []
            with annotate("judge.prepare.patches"):
                patches_list = []
                for arr in arrays:
                    proc = self.image_processor(images=[arr], return_tensors="np")
                    patches_list.append(proc["pixel_values"])
                    g = tuple(int(x) for x in proc["image_grid_thw"][0])
                    grids.append(g)
                    tokens_per_image.append(g[0] * g[1] * g[2] // merge ** 2)
                patches = np.concatenate(patches_list, axis=0) if patches_list else None
            with annotate("judge.prepare.tokens"):
                text = self._render_chat(len(arrays), prompt, system)
                ids = self.tokenizer(text, add_special_tokens=False)["input_ids"]
                ids = self._expand_image_tokens(list(ids), tokens_per_image)
        return ids, patches, grids

    def _decode_row(self, row: np.ndarray) -> str:
        with annotate("judge.detokenize"):
            tokens = row.tolist()
            eos = self.generator.eos_token_id
            if eos in tokens:
                tokens = tokens[:tokens.index(eos)]
            return self.tokenizer.decode(tokens, skip_special_tokens=True)

    def generate(self, images: Sequence, prompt: str,
                 system: Optional[str] = None, max_new_tokens: int = 1024,
                 temperature: float = 0.0, top_p: float = 0.9) -> str:
        """One request: greedy for ``temperature <= 0``, else sampled with
        ``top_p`` (the generator's top-k 50 and nucleus filter, seed 0);
        through the speculative generator when a draft is loaded (greedy:
        the same tokens as the plain path)."""
        ids, pixel_patches, grids = self._prepare(images, prompt, system)
        if self.spec_generator is not None:
            out_ids = self.spec_generator.generate(
                np.asarray([ids], dtype=np.int64), pixel_patches=pixel_patches,
                grid_thw=tuple(grids), max_new_tokens=max_new_tokens,
                prompt_bucket=self.prompt_bucket, temperature=temperature,
                top_p=top_p if temperature > 0 else 1.0)
            return self._decode_row(out_ids[0])
        out_ids = self.generator.generate(
            np.asarray([ids], dtype=np.int64), pixel_patches=pixel_patches,
            grid_thw=tuple(grids), max_new_tokens=max_new_tokens,
            temperature=temperature, top_p=top_p if temperature > 0 else 1.0,
            prompt_bucket=self.prompt_bucket, chunk=self.decode_chunk)
        return self._decode_row(out_ids[0])

    def generate_batch(self, requests: Sequence[dict], max_new_tokens: int = 1024,
                       temperature: float = 0.0, top_p: float = 0.9) -> List[str]:
        """N requests (dicts of ``images``, ``prompt``, optional ``system``)
        in one prefill and one decode: rows of mixed prompt length are
        right-padded to a shared bucket with per-row ``true_lens`` and
        position ids; every row's patches and grids are concatenated in row
        order. Decode streams the weights once a step for all rows, so N
        cases cost about one case's decode time. A draft is not used here,
        as in JAX."""
        if not requests:
            return []
        out_ids = self.generator.generate(
            **self.batch_inputs(requests), max_new_tokens=max_new_tokens,
            temperature=temperature, top_p=top_p if temperature > 0 else 1.0,
            prompt_bucket=self.prompt_bucket, chunk=self.decode_chunk)
        return [self._decode_row(row) for row in out_ids]

    def batch_inputs(self, requests: Sequence[dict]) -> dict:
        """``generate_batch``'s generator inputs for ``requests``: rows
        right-padded to the longest, with their true lengths and position
        ids, and every row's patches and grids in row order."""
        rows = [self._prepare(r["images"], r["prompt"], r.get("system"), i)
                for i, r in enumerate(requests)]
        merge = self.config.vision.spatial_merge_size
        true_lens = np.asarray([len(ids) for ids, _, _ in rows], dtype=np.int64)
        B, seq = len(rows), int(true_lens.max())
        input_ids = np.zeros((B, seq), dtype=np.int64)    # 0 is not the image token
        position_ids = np.zeros((3, B, seq), dtype=np.int64)
        for b, (ids, _, grids) in enumerate(rows):
            input_ids[b, :len(ids)] = ids
            position_ids[:, b, :len(ids)] = compute_mrope_position_ids(
                np.asarray([ids], dtype=np.int64), grids,
                self.config.image_token_id, merge)[:, 0]
        patches = [p for _, p, _ in rows if p is not None]
        return {"input_ids": input_ids,
                "pixel_patches": np.concatenate(patches, axis=0) if patches else None,
                "grid_thw": tuple(g for _, _, grids in rows for g in grids),
                "true_lens": true_lens, "position_ids": position_ids}

    def generate_stream(self, requests: Sequence[dict], max_new_tokens: int = 1024,
                        n_slots: int = 8, temperature: float = 0.0,
                        top_p: float = 0.9) -> List[str]:
        """N requests through continuous batching
        (``models/serving.ContinuousBatcher``): ``n_slots`` decode together
        and a finished slot takes the next queued request between chunks.
        Request dicts as ``generate_batch``'s, plus optional per-request
        ``temperature`` / ``top_p`` / ``seed`` (default: the request's
        index) over the call's, and ``max_new_tokens`` (capped by the call's,
        which sizes the KV cache). With a draft loaded every slot serves
        speculatively (the batcher's speculative chunk). One batcher is kept
        per (bucket, n_slots, max_new_tokens, speculative, mesh); only the one
        serving holds its slot state and graphs (the others are released
        first)."""
        if not requests:
            return []
        from emr2a_tpu_torch.models.serving import ContinuousBatcher
        rows = [self._prepare(r["images"], r["prompt"], r.get("system"), i)
                for i, r in enumerate(requests)]
        longest = max(len(ids) for ids, _, _ in rows)
        bucket = -(-longest // self.prompt_bucket) * self.prompt_bucket
        spec = self.spec_generator
        key = (bucket, int(n_slots), int(max_new_tokens), spec is not None,
               None if self.mesh is None else tuple(self.mesh.devices.shape))
        if key not in self._batchers:
            gen = self.generator
            self._batchers[key] = ContinuousBatcher(
                gen.model, n_slots=n_slots, prompt_bucket=bucket,
                max_new_tokens=max_new_tokens, eos_token_id=gen.eos_token_id,
                kv_dtype=gen.kv_dtype, prefill_chunk=gen.prefill_chunk,
                **({"draft_model": spec.dm, "spec_k": spec.spec_k} if spec else {}))
        reqs = []
        for i, (ids, patches, grids) in enumerate(rows):
            r = requests[i]
            t = float(r.get("temperature", temperature) or 0.0)
            req = {"input_ids": np.asarray([ids], dtype=np.int64),
                   "pixel_patches": patches, "grid_thw": tuple(grids),
                   "temperature": t,
                   "top_p": float((r.get("top_p") or top_p) if t > 0 else 1.0),
                   "seed": int(r["seed"] if r.get("seed") is not None else i)}
            if r.get("max_new_tokens"):
                req["max_new_tokens"] = min(int(r["max_new_tokens"]), max_new_tokens)
            reqs.append(req)
        for other, batcher in self._batchers.items():
            if other != key:
                batcher.release()
        out = self._batchers[key].serve(reqs, max_new_tokens=max_new_tokens)
        return [self._decode_row(row) for row in out]
