"""The batched encoding engine shared by the port's real encoders.

Port of ``emr2a_tpu/encoders/jit_encoder.py`` (the module keeps its name so
that its counterpart is easy to find; PyTorch runs eagerly, so the engine
is ``BatchedImageTextEncoder``). What it keeps:

- host canonicalisation of mixed-size images to the preprocess size, then
  grouping by shape and chunking to ``max_batch``, so each group is one
  static-shape device batch;
- uint8 batches go to the device; preprocessing, the tower and the final
  L2 normalisation run there;
- the path-based ``encode_images``: for an exact-resize spec (or any spec
  with ``assume_square_sources``), the C++ decode pool
  (``data/native_loader.py``) decodes and resizes chunks of ``max_batch``
  paths on a worker thread, double-buffered against the device: chunk i+1
  is submitted before chunk i's embeddings are read back, each chunk into a
  fresh array, failed rows dropped. Otherwise (BioMedCLIP's shortest-edge
  spec on sources not known to be square, or no C++ compiler) the per-image
  host decode of ``encoders/base.py``, then the batched path;
- the text path: tokenize to one fixed length on the host, chunk to
  ``max_batch``, then the text tower and the L2 normalisation on the
  device.

With a ``mesh`` (``parallel.Mesh``), data parallelism over its ``data``
axis, JAX's ``shard_map`` of the forward: the towers are replicated on each
of its devices (``parallel.replicated``); a batch is padded with zero rows
to a multiple of the shard count (``_bucket_for``, JAX's rounding), split
into equal chunks, one a device, every device's forward (preprocess,
tower, L2 normalisation) queued before anything is read back, and the rows
gathered to the first device in order, the padding dropped. The decode
pool's path decodes on the host once and sends each chunk's rows to the
devices the same way. A row's features do not depend on the rows beside it,
up to the order in which a matrix product sums, which a library may choose
by the row count (the CPU's f32 products do; tests/test_torch_dp_encoders.py).

What it drops: the power-of-two bucket padding of image and text batches,
which bounds JAX recompiles and is only wasted rows in eager PyTorch (under
a mesh, a batch is padded only to a multiple of the shard count). As in
the JAX package, subclasses do not take ``assume_square_sources``: a
caller sets the attribute.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from emr2a_tpu_torch.data.images import group_by_shape, resize_to
from emr2a_tpu_torch.data.native_loader import decode_batch, native_available
from emr2a_tpu_torch.encoders.base import BaseEncoder
from emr2a_tpu_torch.ops.preprocess import PreprocessSpec, preprocess_images
from emr2a_tpu_torch.ops.similarity import l2_normalize_rows
from emr2a_tpu_torch.parallel.mesh import Mesh
from emr2a_tpu_torch.parallel.sharding import data_devices, gather_batch, replicated
from emr2a_tpu_torch.utils.profiling import annotate


def fast_state(state: Mapping, fast) -> dict:
    """The encoders' ``fast`` cut of a state dict: every f32 tensor cast to
    bf16 and, with ``fast="int8"``, every tower level of the tree quantized
    W8A8 (``models/quantize.quantize_params_tree``), in the JAX package's
    order (cast, then quantize)."""
    from emr2a_tpu_torch.models.convert import params_from_jax, params_to_jax
    from emr2a_tpu_torch.models.quantize import quantize_params_tree

    state = {k: torch.as_tensor(v) for k, v in state.items()}
    state = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
             for k, v in state.items()}
    if fast != "int8":
        return state
    return params_from_jax(quantize_params_tree(params_to_jax(state)))


def fast_config(config):
    """bf16 towers; the image tower gets the fused LN+attention and LN+MLP
    kernels (BioMedCLIP's and CLIP's configs)."""
    return dataclasses.replace(
        config,
        vision=dataclasses.replace(config.vision, dtype=torch.bfloat16,
                                   fused_mlp=True, fused_attn=True),
        text=(dataclasses.replace(config.text, dtype=torch.bfloat16)
              if config.text is not None else None))


def load_hf(model_path, cls_name: str = "AutoTokenizer"):
    """A checkpoint directory's HF tokenizer (or another ``transformers``
    auto class, e.g. ``AutoImageProcessor``) from local files only, or None
    when there is none (or no ``transformers``)."""
    try:
        import transformers
        return getattr(transformers, cls_name).from_pretrained(
            str(model_path), local_files_only=True)
    except Exception:
        return None


class BatchedImageTextEncoder(BaseEncoder):
    """Wraps an image tower (``nn.Module``: preprocessed (B, H, W, 3) f32
    pixels -> (B, D) features) and optionally a text tower (``(input_ids,
    attention_mask | None) -> (B, D)``) with its ``tokenize(texts) -> (ids,
    mask | None)`` (numpy, padded to one length) into the encoder API.
    Features come back as f32 numpy rows, L2-normalised when
    ``normalize``. With a ``mesh``, the towers run data-parallel on its
    ``data`` devices (module docstring) and ``device`` is ignored."""

    def __init__(self, image_model: nn.Module,
                 text_model: Optional[nn.Module] = None,
                 tokenize: Optional[Callable] = None,
                 preprocess: PreprocessSpec = PreprocessSpec(),
                 normalize: bool = True, max_batch: int = 256,
                 device: str = "cuda", assume_square_sources: bool = False,
                 mesh: Optional[Mesh] = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be an emr2a_tpu_torch.parallel.Mesh, "
                            f"got {type(mesh).__name__}")
        self.mesh = mesh
        self._devices = [torch.device(device)] if mesh is None else data_devices(mesh)
        super().__init__(str(self._devices[0]))
        self._image_models = self._place(image_model)
        self._text_models = None if text_model is None else self._place(text_model)
        self._tokenize = tokenize
        self.preprocess = preprocess
        self.normalize = normalize
        self.max_batch = max_batch
        # CT slices are square; setting this lets shortest-edge specs use the
        # decode pool (a square shortest-edge resize is an exact square one).
        self.assume_square_sources = assume_square_sources

    def _place(self, model: nn.Module) -> list:
        """``model`` in eval mode on each data device (one module a device;
        the first is ``model`` itself)."""
        model.eval()
        if self.mesh is None:
            return [model.to(self._devices[0])]
        return replicated(model, self.mesh)

    @property
    def image_model(self) -> nn.Module:
        """The image tower on the first (or only) device."""
        return self._image_models[0]

    @property
    def text_model(self) -> Optional[nn.Module]:
        return None if self._text_models is None else self._text_models[0]

    def _bucket_for(self, n: int) -> int:
        """Rows a batch of ``n`` is padded to: ``n`` itself, or under a mesh
        the least multiple of the shard count that holds it (at least one
        row a shard)."""
        shards = len(self._devices)
        return max(-(-n // shards), 1) * shards

    def _finish(self, feats: torch.Tensor) -> torch.Tensor:
        feats = feats.float()
        if self.normalize:
            feats = l2_normalize_rows(feats)
        return feats

    @torch.inference_mode()
    def _sharded(self, forward: Callable, models: list, *arrays) -> np.ndarray:
        """``forward(model, *tensors)`` of the rows of ``arrays`` (numpy, or
        None), padded to ``_bucket_for`` rows and split across the data
        devices: every device's forward is queued before the gather to the
        first device and the one read-back."""
        n = len(arrays[0])
        rows = self._bucket_for(n)
        chunk = rows // len(self._devices)
        padded = [None if a is None else np.concatenate(
            [a, np.zeros((rows - n,) + a.shape[1:], a.dtype)]) if rows > n else a
            for a in arrays]
        outs = []
        for i, (dev, model) in enumerate(zip(self._devices, models)):
            with annotate("encode.upload"):
                part = [None if a is None else torch.from_numpy(
                    np.ascontiguousarray(a[i * chunk:(i + 1) * chunk])).to(dev)
                    for a in padded]
            with annotate("encode.tower", device=dev):
                outs.append(self._finish(forward(model, *part)))
        with annotate("encode.readback"):
            return gather_batch(outs, self._devices[0])[:n].cpu().numpy()

    def _image_forward(self, batch_u8: np.ndarray) -> np.ndarray:
        return self._sharded(
            lambda model, images: model(preprocess_images(images, self.preprocess)),
            self._image_models, batch_u8)

    def _text_forward(self, ids: np.ndarray,
                      mask: Optional[np.ndarray]) -> np.ndarray:
        return self._sharded(
            lambda model, ids_t, mask_t: model(ids_t, mask_t), self._text_models,
            ids.astype(np.int64), None if mask is None else mask.astype(np.int64))

    def encode_batch_images(self, images: List[Optional[np.ndarray]]
                            ) -> List[Optional[np.ndarray]]:
        """Traced (``utils/profiling``), a call is the span ``encode.batch``
        over ``encode.resize`` (the host's canonicalisation), and each
        device batch's ``encode.stack``, ``encode.upload``, ``encode.tower``
        (with the device's time) and ``encode.readback``."""
        out: List[Optional[np.ndarray]] = [None] * len(images)
        spec = self.preprocess
        with annotate("encode.batch"):
            with annotate("encode.resize"):
                canon: List[Optional[np.ndarray]] = [
                    None if img is None else resize_to(
                        img, spec.resize_size, shortest_edge=spec.shortest_edge,
                        method=spec.method)
                    for img in images]
            for idxs in group_by_shape(canon).values():
                for start in range(0, len(idxs), self.max_batch):
                    chunk = idxs[start:start + self.max_batch]
                    with annotate("encode.stack"):
                        batch = np.stack([canon[i] for i in chunk])
                    feats = self._image_forward(batch)
                    for j, i in enumerate(chunk):
                        out[i] = feats[j]
        return out

    def encode_images(self, image_paths) -> np.ndarray:
        """Path-based encode on the C++ decode pool where the spec allows
        it (see the module docstring), else the per-image host decode."""
        spec = self.preprocess
        if ((spec.shortest_edge and not self.assume_square_sources)
                or not native_available()):
            return super().encode_images(image_paths)
        size = spec.resize_size
        chunks = [image_paths[s:s + self.max_batch]
                  for s in range(0, len(image_paths), self.max_batch)]
        out_embs: List[np.ndarray] = []
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(decode_batch, chunks[0], size, size) if chunks else None
            for i in range(len(chunks)):
                batch, ok = fut.result()
                if i + 1 < len(chunks):
                    fut = ex.submit(decode_batch, chunks[i + 1], size, size)
                if not ok.any():
                    continue
                # the device runs this chunk while the worker decodes the next
                out_embs.append(self._image_forward(batch[ok]))
        if out_embs:
            return np.concatenate(out_embs, axis=0)
        return np.array([])

    def encode_batch_texts(self, texts: List[str]) -> List[Optional[np.ndarray]]:
        if self.text_model is None or self._tokenize is None:
            raise NotImplementedError(f"{type(self).__name__} is text-less")
        if not texts:
            return []
        ids, mask = self._tokenize(texts)
        out: List[Optional[np.ndarray]] = []
        for start in range(0, len(texts), self.max_batch):
            stop = start + self.max_batch
            feats = self._text_forward(
                ids[start:stop], None if mask is None else mask[start:stop])
            out.extend(feats[i] for i in range(len(feats)))
        return out

    def to(self, device: str):
        """Move the towers to one ``device``; an encoder on a mesh leaves
        it for that device alone."""
        self.mesh = None
        self._devices = [torch.device(device)]
        self._image_models = [self.image_model.to(device)]
        if self._text_models is not None:
            self._text_models = [self.text_model.to(device)]
        return super().to(device)
