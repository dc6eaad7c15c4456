"""Image-quality metrics for dataset filtering, in PyTorch.

Counterpart of `video_styler_tpu/extensions/image_quality_metric.py`: the
LAION aesthetic head, a CLIP score over pluggable embedders, PickScore and
HPS v2 (`models.clip_dual.ClipDual`), MPS (ClipDual and its cross model)
and ImageReward (`models.blip_reward.BlipReward`), with the same registry.
The towers run on their modules' device; the scores come back as Python
floats. Frames are preprocessed by PIL's bicubic resize, centre crop and
the CLIP mean and std (`preprocess_metric_image`, PIL imported there, as
in JAX).

Mirrored from the JAX package as it is: `AestheticPredictor`'s activation
branch is a no-op (the reference head is plain linears, its dropouts are
identity in eval); PickScore's softmax runs over the images of one call,
not over one image as the reference's does.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.clip_vit import CLIP_MEAN, CLIP_STD


class AestheticPredictor:
    """LAION aesthetic-v2 head: MLP(768->1024->128->64->16->1) over
    L2-normalised CLIP ViT-L/14 image embeddings."""

    LAYER_DIMS = [(768, 1024), (1024, 128), (128, 64), (64, 16), (16, 1)]

    def __init__(self, mlp_params: Dict, feature_fn: Optional[Callable] = None):
        self.params = mlp_params
        self.feature_fn = feature_fn

    @classmethod
    def from_state_dict(cls, sd, feature_fn=None, device=None):
        """torch keys layers.{0,2,4,6,7}.weight/bias (a Sequential with
        dropouts) -> {"0".."4": {"w": (out, in), "b"}} on `device`."""
        device = resolve_device(device)
        idxs = [i for i in ("0", "2", "4", "6", "7") if f"layers.{i}.weight" in sd]
        t = lambda v: torch.as_tensor(np.asarray(v, np.float32) if not torch.is_tensor(v)
                                      else v).float().to(device)
        params = {str(j): {"w": t(sd[f"layers.{i}.weight"]), "b": t(sd[f"layers.{i}.bias"])}
                  for j, i in enumerate(idxs)}
        return cls(params, feature_fn)

    def score_embeddings(self, emb) -> np.ndarray:
        dev = self.params["0"]["w"].device
        x = torch.as_tensor(np.asarray(emb, np.float32) if not torch.is_tensor(emb) else emb,
                            device=dev).float()
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        n = len(self.params)
        for i in range(n):
            p = self.params[str(i)]
            x = F.linear(x, p["w"], p["b"])
            if i < n - 1 and x.shape[-1] >= 64:
                pass  # the reference head is plain linears; its dropouts are identity in eval
        return x[..., 0].cpu().numpy()

    def score(self, images: List) -> List[float]:
        if self.feature_fn is None:
            raise RuntimeError("no CLIP feature_fn attached; pass embeddings to "
                               "score_embeddings instead")
        return [float(s) for s in self.score_embeddings(self.feature_fn(images))]


class CLIPScore:
    """cosine(image_emb, text_emb) * 100 over pluggable embedders."""

    def __init__(self, image_fn: Callable, text_fn: Callable):
        self.image_fn = image_fn
        self.text_fn = text_fn

    def score(self, images: List, prompt: str) -> List[float]:
        ie = np.asarray(self.image_fn(images), np.float32)
        te = np.asarray(self.text_fn([prompt]), np.float32)
        ie = ie / np.linalg.norm(ie, axis=-1, keepdims=True)
        te = te / np.linalg.norm(te, axis=-1, keepdims=True)
        return [float(s) for s in (ie @ te.T)[:, 0] * 100.0]


def preprocess_metric_image(image, image_size: int = 224) -> np.ndarray:
    """CLIP-style eval transform (the reference's imagereward.py:15-22 and
    the HF CLIPImageProcessor defaults): PIL bicubic resize of the short
    side to `image_size`, centre crop, CLIP mean/std -> (3, S, S)."""
    from PIL import Image
    if not isinstance(image, Image.Image):
        image = Image.fromarray(np.asarray(image.cpu() if torch.is_tensor(image) else image))
    image = image.convert("RGB")
    w, h = image.size
    scale = image_size / min(w, h)
    image = image.resize((max(image_size, round(w * scale)), max(image_size, round(h * scale))),
                         Image.BICUBIC)
    w, h = image.size
    left, top = (w - image_size) // 2, (h - image_size) // 2
    image = image.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(image, np.float32).transpose(2, 0, 1) / 255.0
    mean = np.asarray(CLIP_MEAN, np.float32)[:, None, None]
    std = np.asarray(CLIP_STD, np.float32)[:, None, None]
    return (arr - mean) / std


def _as_pixel_batch(images, image_size: int, device) -> torch.Tensor:
    if not isinstance(images, (list, tuple)):
        images = [images]
    return torch.from_numpy(np.stack([preprocess_metric_image(im, image_size)
                                      for im in images])).to(device)


def _normed(t: torch.Tensor) -> np.ndarray:
    x = t.float().cpu().numpy()
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _device(module) -> torch.device:
    return next(module.parameters()).device


class PickScore:
    """PickScore (pickscore.py:8-112): normalised CLIP text @ image
    similarity on the PickScore-finetuned ViT-H/14."""

    def __init__(self, params, cfg=None, tokenizer=None):
        from ..models import clip_dual as C
        self.C = C
        self.params = params
        self.cfg = cfg or C.CLIP_VIT_H_14_DUAL
        self.tokenizer = tokenizer

    @classmethod
    def from_state_dict(cls, sd, cfg=None, tokenizer=None, device=None):
        from ..models import clip_dual as C
        cfg = cfg or C.CLIP_VIT_H_14_DUAL
        return cls(C.convert_hf_clip(sd, cfg, device), cfg, tokenizer)

    def score(self, images, prompt: str, softmax: bool = False) -> List[float]:
        C, cfg = self.C, self.cfg
        t = self.tokenizer([prompt], padding=True, truncation=True, max_length=77,
                           return_tensors="np")
        with torch.no_grad():
            te = _normed(C.clip_text_features(self.params, cfg, t["input_ids"],
                                              t["attention_mask"]))
            pix = _as_pixel_batch(images, cfg.image_size, _device(self.params))
            ie = _normed(C.clip_image_features(self.params, cfg, pix))
        scores = (te @ ie.T)[0]
        if softmax:
            # the reference scores one image per call, so its softmax is
            # degenerate (pickscore.py:50-53); softmax over the batch here
            e = np.exp(np.exp(float(self.params.logit_scale)) * scores)
            scores = e / e.sum()
        return [float(s) for s in scores]


class HPScore:
    """HPS v2/v2.1 (hps.py:20-118): diagonal of normalised image @ text
    similarity on the HPS-tuned open_clip ViT-H-14."""

    def __init__(self, params, cfg=None, tokenizer=None):
        from ..models import clip_dual as C
        self.C = C
        self.params = params
        self.cfg = cfg or C.CLIP_VIT_H_14_DUAL
        self.tokenizer = tokenizer

    @classmethod
    def from_state_dict(cls, sd, cfg=None, tokenizer=None, device=None):
        from ..models import clip_dual as C
        cfg = cfg or C.CLIP_VIT_H_14_DUAL
        return cls(C.convert_open_clip(sd, cfg, device), cfg, tokenizer)

    def score(self, images, prompt: str) -> List[float]:
        C, cfg = self.C, self.cfg
        t = self.tokenizer([prompt], padding="max_length", truncation=True, max_length=77,
                           return_tensors="np")
        with torch.no_grad():
            te = _normed(C.clip_text_features(self.params, cfg, t["input_ids"]))
            pix = _as_pixel_batch(images, cfg.image_size, _device(self.params))
            ie = _normed(C.clip_image_features(self.params, cfg, pix))
        return [float(s) for s in (ie @ te.T)[:, 0]]


MPS_CONDITIONS = {
    "overall": "light, color, clarity, tone, style, ambiance, artistry, shape, face, "
               "hair, hands, limbs, structure, instance, texture, quantity, attributes, "
               "position, number, location, word, things",
    "aesthetics": "light, color, clarity, tone, style, ambiance, artistry",
    "quality": "shape, face, hair, hands, limbs, structure, instance, texture",
    "semantic": "quantity, attributes, position, number, location",
}


class MPScore:
    """MPS (mps.py:27-96): token-level CLIP features and a 4-layer
    multi-query cross model; the text/condition similarity gates which text
    tokens the image may attend to."""

    def __init__(self, params, cross_params, cfg=None, tokenizer=None,
                 condition: str = "overall", cross_heads: int = 16):
        from ..models import clip_dual as C
        self.C = C
        self.params = params
        self.cross_params = cross_params
        self.cfg = cfg or C.CLIP_VIT_H_14_DUAL
        self.tokenizer = tokenizer
        self.condition = condition
        self.cross_heads = cross_heads

    @classmethod
    def from_state_dict(cls, sd, cfg=None, tokenizer=None, condition: str = "overall",
                        device=None):
        from ..models import clip_dual as C
        cfg = cfg or C.CLIP_VIT_H_14_DUAL
        return cls(C.convert_hf_clip(sd, cfg, device), C.convert_cross_model(sd, device=device),
                   cfg, tokenizer, condition)

    def _text_tokens(self, prompt: str):
        t = self.tokenizer([prompt], padding="max_length", truncation=True, max_length=77,
                           return_tensors="np")
        tokens, pooled = self.C.clip_text_forward(self.params, self.cfg, t["input_ids"])
        proj = self.params.text_projection
        return proj(tokens).float().cpu().numpy(), proj(pooled).float().cpu().numpy()

    def score(self, images, prompt: str) -> List[float]:
        C, cfg = self.C, self.cfg
        dev = _device(self.params)
        with torch.no_grad():
            text_f, text_eos = self._text_tokens(prompt)
            cond_f, _ = self._text_tokens(MPS_CONDITIONS[self.condition])
        # mask: which text tokens are similar enough to the condition set
        sim = np.einsum("bid,bjd->bji", text_f, cond_f)
        sim = sim.max(axis=1, keepdims=True)
        sim = sim / sim.max()
        mask = np.where(sim > 0.3, 0.0, -np.inf).astype(np.float32)
        scores = []
        for im in (images if isinstance(images, (list, tuple)) else [images]):
            with torch.no_grad():
                pix = _as_pixel_batch([im], cfg.image_size, dev)
                tokens, _ = C.clip_vision_forward(self.params, cfg, pix)
                image_f = self.params.visual_projection(tokens)
                m = torch.from_numpy(np.repeat(mask, image_f.shape[1], axis=1)).to(dev)
                fused = C.cross_model_forward(self.cross_params, image_f,
                                              torch.from_numpy(text_f).to(dev), m,
                                              heads=self.cross_heads)[:, 0, :]
            ie = _normed(fused)
            te = text_eos / np.linalg.norm(text_eos, axis=-1, keepdims=True)
            logit = np.exp(float(self.params.logit_scale))
            scores.append(float((logit * te @ ie.T)[0, 0]))
        return scores


class ImageRewardScore:
    """ImageReward (imagereward.py:55-190): BLIP multimodal [CLS] state ->
    5-layer MLP -> z-scored reward."""

    def __init__(self, params, cfg=None, tokenizer=None):
        from ..models import blip_reward as B
        self.B = B
        self.params = params
        self.cfg = cfg or B.IMAGE_REWARD
        self.tokenizer = tokenizer

    @classmethod
    def from_state_dict(cls, sd, cfg=None, tokenizer=None, device=None):
        from ..models import blip_reward as B
        cfg = cfg or B.IMAGE_REWARD
        return cls(B.convert_image_reward(sd, cfg, device), cfg, tokenizer)

    def score(self, images, prompt: str) -> List[float]:
        B, cfg = self.B, self.cfg
        t = self.tokenizer([prompt], padding="max_length", truncation=True, max_length=35,
                           return_tensors="np")
        with torch.no_grad():
            pix = _as_pixel_batch(images, cfg.image_size, _device(self.params))
            n = pix.shape[0]
            r = B.image_reward_forward(self.params, cfg, pix,
                                       np.repeat(t["input_ids"], n, axis=0),
                                       np.repeat(t["attention_mask"], n, axis=0))
        return [float(s) for s in r.float().cpu().numpy()]


_METRICS = {"aesthetic": AestheticPredictor, "clip": CLIPScore, "pickscore": PickScore,
            "hps": HPScore, "mps": MPScore, "imagereward": ImageRewardScore}


def get_metric(name: str, **kwargs):
    name = name.lower()
    if name in _METRICS:
        return _METRICS[name](**kwargs)
    raise ValueError(f"unknown metric {name}")
