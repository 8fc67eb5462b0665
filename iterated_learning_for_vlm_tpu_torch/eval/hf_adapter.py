"""Local-weights ja_clip / nllb_clip eval adapters (torch-backed).

Counterpart of ``iterated_learning_for_vlm_tpu/eval/hf_adapter.py``: the same
loader semantics, language map and input checks, with a ``device`` (the CUDA
card unless the caller names another, as every entry point of the port:
``models.resolve_device``) that holds the model and receives each batch.
``transformers`` is imported when an encoder is built; without it the
constructor raises ``ImportError`` naming the package.

Parity target: the reference eval harness's remaining ``TYPE2FUNC`` entries
(``CLIP_benchmark/clip_benchmark/models/__init__.py:8-13``):

- ``ja_clip`` (``models/japanese_clip.py:16-53``): wraps rinna's
  Japanese-CLIP — an HF dual-encoder whose surface is
  ``get_image_features`` / ``get_text_features`` — and tokenizes with the
  note that ``attention_mask`` AND ``position_ids`` must be passed for
  ``encode_text`` to be correct.
- ``nllb_clip`` (``models/nllb_clip.py``): an HF NLLB text tower whose
  tokenizer needs ``set_src_lang_special_tokens(<flores_code>)`` driven by
  a 2-letter -> FLORES-200 language map before encoding.

Both reference loaders FETCH models from the network (HF hub / GitHub
package installs), which a zero-egress deployment cannot do.  This adapter
keeps the same model surface but loads from a LOCAL directory in standard
HF ``save_pretrained`` layout (``local_files_only=True`` everywhere): any
model class exposing ``get_image_features``/``get_text_features``
(``CLIPModel``, ``VisionTextDualEncoderModel`` — the rinna shape,
``ChineseCLIPModel``, ...) plus its tokenizer and image processor.

The returned encoder duck-types ``JitEncoder``'s metric surface
(``encode_images`` / ``encode_texts`` -> L2-normalized numpy), so every
task in ``eval/cli.py`` works unchanged.  These are *eval-compatibility*
paths for third-party towers, not training paths.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Optional, Sequence

import numpy as np

# 2-letter (and legacy) codes -> FLORES-200 codes, from the reference's
# ``nllb_clip.py`` ``lang_map`` head (the remainder of that 200+-entry table
# is the identity on FLORES codes, handled by the passthrough below).
_NLLB_LANG = {
    "en": "eng_Latn", "es": "spa_Latn", "it": "ita_Latn", "ko": "kor_Hang",
    "ru": "rus_Cyrl", "zh": "zho_Hant", "de": "deu_Latn", "fr": "fra_Latn",
    "jp": "jpn_Jpan", "cn": "zho_Hant", "zhm": "yue_Hant", "ar": "arb_Arab",
    "bn": "ben_Beng", "cs": "ces_Latn", "da": "dan_Latn", "el": "ell_Grek",
    "fa": "pes_Arab", "fi": "fin_Latn", "fil": "tgl_Latn", "hi": "hin_Deva",
    "hr": "hrv_Latn", "hu": "hun_Latn", "ja": "jpn_Jpan", "id": "ind_Latn",
    "he": "heb_Hebr", "mi": "mri_Latn", "nl": "nld_Latn", "no": "nno_Latn",
    "pl": "pol_Latn", "pt": "por_Latn", "quz": "quy_Latn", "ro": "ron_Latn",
    "sv": "swe_Latn", "sw": "swh_Latn", "te": "tel_Telu", "th": "tha_Thai",
    "tr": "tur_Latn", "uk": "ukr_Cyrl", "vi": "vie_Latn",
}


def _image_processor(model_dir: str):
    """The directory's image processor through ``AutoImageProcessor``. Where
    that needs torchvision and finds none (transformers 5), the class the
    directory names (``image_processor_type``), in its PIL form where there is
    one: the same resize, crop and normalize, on PIL and numpy."""
    import transformers

    try:
        return transformers.AutoImageProcessor.from_pretrained(model_dir,
                                                               local_files_only=True)
    except ImportError:
        with open(os.path.join(model_dir, "preprocessor_config.json"), encoding="utf-8") as f:
            name = json.load(f)["image_processor_type"]
        cls = getattr(transformers, name + "Pil", None) or getattr(transformers, name)
        return cls.from_pretrained(model_dir, local_files_only=True)


def nllb_language_code(code: str) -> str:
    """Map an eval ``--language`` code to the FLORES-200 code the NLLB
    tokenizer expects.  FLORES codes (``xxx_Yyyy``) pass through."""
    if code in _NLLB_LANG:
        return _NLLB_LANG[code]
    if len(code.split("_")) == 2 and len(code.split("_")[0]) in (3, 4):
        return code  # already a FLORES code
    raise KeyError(f"no NLLB language mapping for {code!r}")


class HFClipEncoder:
    """``encode_images``/``encode_texts`` over a local HF dual-encoder.

    Parameters
    ----------
    model_dir: local ``save_pretrained`` directory (model + tokenizer +
        image processor).  Nothing is fetched.
    model_type: ``"ja_clip"`` or ``"nllb_clip"`` — selects the reference
        loader semantics (position_ids for ja_clip, src-lang special
        tokens for nllb_clip).
    language: eval language code; only consulted for nllb_clip.
    device: where the model runs (default: the CUDA card; raises without
        one unless a device is named).
    """

    def __init__(self, model_dir: str, model_type: str = "ja_clip",
                 batch_size: int = 64, normalize: bool = True,
                 language: str = "en", context_length: Optional[int] = None,
                 device=None):
        import torch

        from ..models import resolve_device

        try:
            from transformers import AutoModel, AutoTokenizer
        except ImportError as e:
            raise ImportError(
                f"--model_type {model_type} needs the `transformers` package, which is "
                "not installed") from e

        self._torch = torch
        self.device = resolve_device(device)
        self.model_type = model_type
        self.batch_size = batch_size
        self.normalize = normalize
        self.context_length = context_length
        self.model = AutoModel.from_pretrained(model_dir, local_files_only=True)
        self.model.to(self.device).eval()
        for method in ("get_image_features", "get_text_features"):
            if not hasattr(self.model, method):
                raise TypeError(
                    f"{type(self.model).__name__} from {model_dir} has no "
                    f"{method}; {model_type} needs a dual-encoder layout "
                    "(CLIPModel / VisionTextDualEncoderModel / ...)")
        self.tokenizer = AutoTokenizer.from_pretrained(
            model_dir, local_files_only=True)
        try:
            self.processor = _image_processor(model_dir)
        except Exception:
            self.processor = None  # caller must pass preprocessed arrays
        if model_type == "nllb_clip":
            self.set_language(language)

    def set_language(self, language: str) -> None:
        """nllb_clip: retarget the tokenizer's source-language special
        tokens (reference ``nllb_clip.py:set_language``).  No-op for
        ja_clip — its tokenizer is monolingual."""
        if self.model_type != "nllb_clip":
            return
        lang = nllb_language_code(language)
        tok = self.tokenizer
        if hasattr(tok, "set_src_lang_special_tokens"):
            tok.set_src_lang_special_tokens(lang)
        elif hasattr(tok, "src_lang"):
            tok.src_lang = lang

    def _check_preprocessed(self, chunk: np.ndarray) -> None:
        """Validate float arrays claimed to be fully preprocessed: spatial
        size must match the processor's crop/size config when known, and the
        value distribution must look standardized (mean-subtracted), not
        [0, 1] / [0, 255] raw pixels."""
        if chunk.ndim != 4 or chunk.shape[-1] != 3:
            raise ValueError(
                f"preprocessed image array must be [N,H,W,3], got {chunk.shape}")
        expected = None
        proc = self.processor
        for attr in ("crop_size", "size"):
            sz = getattr(proc, attr, None)
            if isinstance(sz, dict):
                expected = int(sz.get("height") or sz.get("shortest_edge") or 0)
            elif isinstance(sz, int):
                expected = sz
            if expected:
                break
        if expected and chunk.shape[1:3] != (expected, expected):
            raise ValueError(
                f"preprocessed array is {chunk.shape[1]}x{chunk.shape[2]} but "
                f"the model's image processor expects {expected}x{expected}; "
                "pass PIL images or raw uint8 arrays to let the processor "
                "resize, or resize before normalizing")
        if float(chunk.min()) >= 0.0:
            # standardized (mean-subtracted) pixels USUALLY contain negatives,
            # but a batch of uniformly bright images (all channels above the
            # dataset mean — white backgrounds at batch_size 1) is legitimately
            # all-positive.  Only hard-reject when the range also looks like
            # raw pixel data ([0,1] or [0,255]: max <= 1.01 or values near
            # integers spanning >2); otherwise warn.
            mx = float(chunk.max())
            looks_raw = mx <= 1.01 or (
                mx > 2.0 and float(np.abs(chunk - np.round(chunk)).max()) < 1e-3)
            if looks_raw:
                raise ValueError(
                    "preprocessed array has no negative values and a raw-pixel "
                    "value range — it looks like [0,1]/[0,255] pixels, not "
                    "mean-subtracted features; pass uint8/PIL input instead, "
                    "or apply the processor's rescale+normalize first")
            warnings.warn(
                "preprocessed image array has no negative values; if this is "
                "raw pixel data the embeddings will be wrong (uniformly "
                "bright standardized images can legitimately look like this)",
                stacklevel=3)

    def _projected(self, out):
        """The projected features of a ``get_*_features`` call: the tensor
        itself (transformers 4), or the ``pooler_output`` of the model output
        transformers 5 returns in its place, which must then have the
        model's ``projection_dim`` columns."""
        if isinstance(out, self._torch.Tensor):
            return out
        feats = out.pooler_output
        dim = getattr(self.model.config, "projection_dim", None)
        if dim is not None and feats.shape[-1] != dim:
            raise ValueError(f"{type(out).__name__}.pooler_output has {feats.shape[-1]} "
                             f"columns, not the model's projection_dim {dim}")
        return feats

    def _norm(self, feats, normalize: Optional[bool]):
        feats = self._projected(feats)
        nrm = self.normalize if normalize is None else normalize
        arr = feats.detach().cpu().float().numpy()
        if nrm:
            arr = arr / np.maximum(
                np.linalg.norm(arr, axis=-1, keepdims=True), 1e-12)
        return arr

    def encode_images(self, images, normalize: Optional[bool] = None) -> np.ndarray:
        torch = self._torch
        out = []
        imgs = list(images) if not isinstance(images, np.ndarray) else images
        with torch.no_grad():
            for i in range(0, len(imgs), self.batch_size):
                chunk = imgs[i:i + self.batch_size]
                if isinstance(chunk, np.ndarray) and chunk.dtype == np.uint8 \
                        and self.processor is not None:
                    # raw uint8 frames are unambiguous: route through the
                    # processor (it accepts numpy images) for its own
                    # resize/rescale/normalize
                    pixel = self.processor(
                        images=[chunk[j] for j in range(len(chunk))],
                        return_tensors="pt")["pixel_values"]
                elif isinstance(chunk, np.ndarray):
                    # already-preprocessed [N,H,W,3] -> NCHW, as-is.  Guard
                    # the contract (ADVICE r3): a [0,1]-scaled or un-resized
                    # float array would silently produce mis-normalized
                    # embeddings.
                    self._check_preprocessed(chunk)
                    pixel = torch.from_numpy(
                        np.ascontiguousarray(chunk.transpose(0, 3, 1, 2))
                    ).float()
                elif self.processor is not None:
                    pixel = self.processor(
                        images=chunk, return_tensors="pt")["pixel_values"]
                else:
                    raise ValueError(
                        "no image processor in the model dir; pass "
                        "preprocessed [N,H,W,3] float arrays")
                out.append(self._norm(
                    self.model.get_image_features(pixel_values=pixel.to(self.device)),
                    normalize))
        return (np.concatenate(out) if out
                else np.zeros((0, 1), np.float32))

    def encode_texts(self, texts: Sequence[str],
                     normalize: Optional[bool] = None) -> np.ndarray:
        torch = self._torch
        out = []
        with torch.no_grad():
            for i in range(0, len(texts), self.batch_size):
                chunk = list(texts[i:i + self.batch_size])
                enc = self.tokenizer(
                    chunk, padding=True, truncation=True,
                    max_length=self.context_length, return_tensors="pt")
                inputs = {"input_ids": enc["input_ids"].to(self.device),
                          "attention_mask": enc["attention_mask"].to(self.device)}
                if self.model_type == "ja_clip":
                    # reference japanese_clip.py:33 — position_ids must be
                    # passed explicitly or rinna's text pooling is wrong
                    seq = enc["input_ids"].shape[1]
                    inputs["position_ids"] = torch.arange(
                        seq, device=self.device).unsqueeze(0).expand(
                        enc["input_ids"].shape[0], seq)
                out.append(self._norm(
                    self.model.get_text_features(**inputs), normalize))
        return (np.concatenate(out) if out
                else np.zeros((0, 1), np.float32))
