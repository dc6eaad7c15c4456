"""Turn the JAX package's parameter trees into the port's modules.

`from_jax_params(kind, tree, cfg)` takes a JAX parameter pytree whose
leaves were converted to numpy (`jax.tree_util.tree_map(np.asarray, p)`)
and returns the port's module for `kind`:

  "dit"  -> models.wan_dit.WanDiT       (cfg: WanDiTConfig)
  "vace" -> models.wan_vace.WanVace     (cfg: VaceConfig)
  "t5"   -> models.t5.T5Encoder         (cfg: T5Config)
  "vae"  -> models.wan_vae.WanVAE       (cfg: WanVAEConfig), or
            models.wan_vae.WanVAE38     (cfg: WanVAE38Config, the Wan2.2 VAE)
  "clip" -> models.clip_vit.ClipVit     (cfg: ClipVitConfig)
  "animate" -> models.wan_animate.WanAnimateAdapter (cfg: AnimateConfig;
            the tree nests the reference's names, torch layouts)
  "motion_controller" -> models.wan_controllers.MotionController
  "control_adapter"   -> models.wan_controllers.SimpleAdapter
            (cfg: None for these two; the widths come from the tree)
  "s2v"  -> models.wan_s2v.WanS2V       (cfg: WanS2VConfig)
  "wav2vec" -> models.wav2vec.Wav2Vec2  (cfg: Wav2Vec2Config)
  "xlm_roberta" -> models.clip_vit.XlmRoberta (cfg: XlmRobertaConfig)
  "clip_dual" -> models.clip_dual.ClipDual (cfg: CLIPDualConfig; the tree's
            `logit_scale`, a Python float, becomes a float64 scalar)
  "cross_model" -> models.clip_dual.CrossModel (cfg: None, the widths come
            from the tree)
  "blip_reward" -> models.blip_reward.BlipReward (cfg: BlipRewardConfig)
  "flux_dit" -> models.flux_dit.FluxDiT   (cfg: FluxDiTConfig)
  "sd3_vae_encoder" / "sd3_vae_decoder" -> models.sd3_vae.SD3VAEEncoder /
            SD3VAEDecoder (cfg: SD3VAEConfig)
  "clip_l_text" -> models.sd3_text_encoder.ClipTextEncoder (cfg: ClipTextConfig)
  "clip_g_text" -> models.sdxl.SDXLTextEncoder2 (cfg: ClipTextConfig)
  "flux_controlnet" -> models.flux_controlnet.FluxControlNet (cfg: FluxControlNetConfig)
  "flux_ipadapter" -> models.flux_controlnet.FluxIpAdapter (cfg: FluxIpAdapterConfig;
            the tree's stacked `modules` become `blocks`)
  "infiniteyou" -> models.flux_adapters.InfiniteYouProjector (cfg: InfiniteYouConfig)
  "value_encoder" -> models.flux_adapters.SingleValueEncoder (cfg: None, the widths
            come from the tree)
  "lora_encoder" -> models.flux_adapters.FluxLoRAEncoder (cfg: FluxLoRAEncoderConfig)
  "sd3_dit" -> models.sd3_dit.SD3DiT (cfg: SD3DiTConfig)
  ("t5" takes T5 v1.1 too: with `shared_pos` only layer 0 has `pos_emb`)
  "hunyuan_dit" -> models.hunyuan_image_dit.HunyuanImageDiT (cfg:
            HunyuanImageDiTConfig; `down_blocks` then `up_blocks` become
            `blocks`)
  "hunyuan_bert" -> models.hunyuan_image_dit.HunyuanBert (cfg: HunyuanBertConfig)
  "step1_llm" -> models.stepvideo_llm.Step1LLM (cfg: Step1LLMConfig)
  "step_video_dit" -> models.stepvideo_dit.StepVideoDiT (cfg: StepVideoDiTConfig)
  "step_vae" -> models.stepvideo_vae.StepVideoVAE (cfg: StepVAEConfig)
  "cog_dit" -> models.cog_video.CogDiT (cfg: CogDiTConfig)
  "cog_vae_encoder" / "cog_vae_decoder" -> models.cog_video.CogVAEEncoder /
            CogVAEDecoder (cfg: None)
  "svd_unet" -> models.svd.SVDUNet (cfg: SDUNetConfig; ExVideo's where the
            tree has positional convolutions)
  "svd_vae_decoder" -> models.svd.SVDVAEDecoder (cfg: None)
  "svd_image_encoder" -> models.svd.SVDImageEncoder (cfg: SVDImageEncoderConfig)
  "omnigen" -> models.omnigen.OmniGen (cfg: OmniGenConfig)
  "qwen_image_dit" -> models.qwen_image_dit.QwenImageDiT (cfg: QwenImageDiTConfig;
            the tree's stacked `transformer_blocks` become the module list)
  (in these trees a LayerNorm's or RMSNorm's `scale` becomes the port's
  `weight` and the other names follow the port's modules; the SVD and VAE
  trees already carry the port's names)

A Fun DiT's tree carries `ref_conv` ({"w", "b"}, as the patch embedding)
and `control_adapter` (torch layout), which a config with `has_ref_conv`
and `has_control_adapter` takes.

`from_jax_lora(lora)` turns a JAX LoRA pytree (`trainers.lora_train
.init_lora`: {path: {"A": (L, in, r), "B": (L, r, out)}}, stacked over
blocks, or (in, r) / (r, out) on an unstacked linear) into the port's
per-block factors in torch layout. Every tree of the trainers maps one JAX
`{"w"}` node to one port linear of the same path: the Wan DiT and VACE,
the FLUX, SD3 and Qwen-Image DiTs (any `*blocks` stack: `blocks.`,
`single_blocks.`, `transformer_blocks.`) and the SD/SDXL UNets.

The layouts that differ: JAX linears store `w` as (in, out) and
`nn.Linear` stores `weight` as (out, in) (a convolution's `w`, 3-D and up,
is already in the torch layout and only takes the name `weight`); the
stacked `blocks` (and VACE `after_proj`, FLUX `single_blocks`, the
ControlNet's `controlnet_blocks` / `controlnet_single_blocks`, SD3's
`dual_blocks`) trees of the DiT, VACE, S2V, FLUX DiT, FLUX ControlNet,
IP-Adapter and SD3 DiT carry a leading layer axis that becomes the index of an `nn.ModuleList`
(the CLIP tower's `blocks` are a dict keyed by index, the wav2vec and
XLM-R towers' a list: the same names). VAE conv weights are already OIDHW
and keep their names.
bfloat16 and float8_e4m3fn leaves (ml_dtypes) keep their bits.

A tree quantised by the JAX package's `quantize_params` (linear leaves
`w_q` or `w_q4`, `w_scale`, `b`) converts too: each such leaf becomes an
`ops.quant.QuantLinear` holding the same integers and scales in the same
(in, out) layout, so both packages can run on identical quantised weights.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import resolve_device
from .models.blip_reward import BlipReward
from .models.clip_dual import ClipDual, CrossModel, cross_model_config
from .models.clip_vit import ClipVit, XlmRoberta
from .models.cog_video import CogDiT, CogVAEDecoder, CogVAEEncoder
from .models.flux_adapters import (FluxLoRAEncoder, InfiniteYouProjector, SingleValueEncoder,
                                   ValueEncoderConfig)
from .models.flux_controlnet import FluxControlNet, FluxIpAdapter
from .models.flux_dit import FluxDiT
from .models.hunyuan_image_dit import HunyuanBert, HunyuanImageDiT
from .models.omnigen import OmniGen
from .models.qwen_image_dit import QwenImageDiT
from .models.sd3_dit import SD3DiT
from .models.sd3_text_encoder import ClipTextEncoder
from .models.sd3_vae import SD3VAEDecoder, SD3VAEEncoder
from .models.sdxl import SDXLTextEncoder2
from .models.stepvideo_dit import StepVideoDiT
from .models.stepvideo_llm import Step1LLM
from .models.stepvideo_vae import StepVideoVAE
from .models.svd import SVDImageEncoder, SVDUNet, SVDVAEDecoder
from .models.t5 import T5Encoder
from .models.wan_animate import WanAnimateAdapter, animate_head_dim
from .models.wan_controllers import MotionController, SimpleAdapter
from .models.wan_dit import WanDiT
from .models.wan_s2v import WanS2V
from .models.wan_vace import WanVace
from .models.wan_vae import WanVAE, WanVAE38, WanVAE38Config
from .models.wav2vec import Wav2Vec2
from .ops.quant import QuantLinear

def _animate(cfg, sd):
    return WanAnimateAdapter(cfg, animate_head_dim(sd))


def _motion_controller(cfg, sd):
    dim, freq_dim = sd["fc1.weight"].shape
    return MotionController(dim, freq_dim)


def _simple_adapter(cfg, sd):
    blocks = len({k.split(".")[1] for k in sd if k.startswith("residual_blocks.")})
    return SimpleAdapter(sd["conv.weight"].shape[1] // 64, sd["conv.weight"].shape[0],
                         blocks)


_MODULES = {"dit": WanDiT, "vace": WanVace, "t5": T5Encoder, "vae": WanVAE,
            "clip": ClipVit, "s2v": WanS2V, "wav2vec": Wav2Vec2, "xlm_roberta": XlmRoberta,
            "clip_dual": ClipDual, "blip_reward": BlipReward, "flux_dit": FluxDiT,
            "sd3_vae_encoder": SD3VAEEncoder, "sd3_vae_decoder": SD3VAEDecoder,
            "clip_l_text": ClipTextEncoder, "clip_g_text": SDXLTextEncoder2,
            "flux_controlnet": FluxControlNet, "flux_ipadapter": FluxIpAdapter,
            "infiniteyou": InfiniteYouProjector, "lora_encoder": FluxLoRAEncoder,
            "sd3_dit": SD3DiT, "hunyuan_dit": HunyuanImageDiT, "hunyuan_bert": HunyuanBert,
            "step1_llm": Step1LLM, "step_video_dit": StepVideoDiT, "step_vae": StepVideoVAE,
            "cog_dit": CogDiT, "cog_vae_encoder": CogVAEEncoder,
            "cog_vae_decoder": CogVAEDecoder, "svd_vae_decoder": SVDVAEDecoder,
            "svd_image_encoder": SVDImageEncoder, "omnigen": OmniGen,
            "qwen_image_dit": QwenImageDiT}
_BUILDERS = {"animate": _animate, "motion_controller": _motion_controller,
             "control_adapter": _simple_adapter,
             "cross_model": lambda cfg, sd: CrossModel(cross_model_config(sd)),
             "value_encoder": lambda cfg, sd: SingleValueEncoder(ValueEncoderConfig(
                 sd["fc1.weight"].shape[1], sd["fc1.weight"].shape[0], sd["pos"].shape[0])),
             "svd_unet": lambda cfg, sd: SVDUNet(cfg, exvideo=any(
                 ".positional_conv." in k for k in sd))}
_STACKED = ("blocks", "after_proj", "single_blocks", "controlnet_blocks",
            "controlnet_single_blocks", "dual_blocks", "down_blocks", "up_blocks",
            "transformer_blocks")
_STACKED_KINDS = ("dit", "vace", "s2v", "flux_dit", "flux_controlnet", "flux_ipadapter",
                  "sd3_dit", "hunyuan_dit", "step1_llm", "step_video_dit", "cog_dit",
                  "omnigen", "qwen_image_dit")


def _sub(rules):
    """A renamer applying `(old, new)` prefix rules, first match only."""
    def rename(name: str) -> str:
        for old, new in rules:
            if name.startswith(old):
                return new + name[len(old):]
        return name
    return rename


def _norm_weight(name: str) -> str:
    return name[:-len(".scale")] + ".weight" if name.endswith(".scale") else name


_HUNYUAN_BLOCK = _sub([("attn1_q.", "attn1.to_q."), ("attn1_k.", "attn1.to_k."),
                       ("attn1_v.", "attn1.to_v."), ("attn1_o.", "attn1.to_out."),
                       ("attn2_q.", "attn2.to_q."), ("attn2_k.", "attn2.to_k."),
                       ("attn2_v.", "attn2.to_v."), ("attn2_o.", "attn2.to_out."),
                       ("q_norm1.", "rota1.q_norm."), ("k_norm1.", "rota1.k_norm."),
                       ("q_norm2.", "rota2.q_norm."), ("k_norm2.", "rota2.k_norm."),
                       ("modulation.", "modulation.1."), ("mlp_fc1.", "mlp.0."),
                       ("mlp_fc2.", "mlp.2.")])
_HUNYUAN_TOP = _sub([("patch_embedder.", "patch_embedder.proj."),
                     ("timestep_embedder.fc1.", "timestep_embedder.mlp.0."),
                     ("timestep_embedder.fc2.", "timestep_embedder.mlp.2."),
                     ("final_adaln.", "final_layer.adaLN_modulation.1."),
                     ("final_linear.", "final_layer.linear.")])


def _hunyuan_dit_name(name: str, cfg) -> str:
    parts = name.split(".")
    if parts[0] in ("down_blocks", "up_blocks"):
        i = int(parts[1]) + (cfg.num_layers_down if parts[0] == "up_blocks" else 0)
        return f"blocks.{i}." + _norm_weight(_HUNYUAN_BLOCK(".".join(parts[2:])))
    return _HUNYUAN_TOP(name)


_BERT_LAYER = _sub([("q.", "attention.self.query."), ("k.", "attention.self.key."),
                    ("v.", "attention.self.value."), ("o.", "attention.output.dense."),
                    ("attn_ln.", "attention.output.LayerNorm."),
                    ("fc1.", "intermediate.dense."), ("fc2.", "output.dense."),
                    ("out_ln.", "output.LayerNorm.")])
_BERT_TOP = _sub([("tok_emb", "embeddings.word_embeddings.weight"),
                  ("pos_emb", "embeddings.position_embeddings.weight"),
                  ("type_emb", "embeddings.token_type_embeddings.weight"),
                  ("emb_ln.", "embeddings.LayerNorm.")])


def _bert_name(name: str, cfg) -> str:
    parts = name.split(".")
    if parts[0] == "blocks":
        return f"encoder.layer.{parts[1]}." + _norm_weight(_BERT_LAYER(".".join(parts[2:])))
    return _norm_weight(_BERT_TOP(name))


_STEP1_LAYER = _sub([("wqkv.", "attention.wqkv."), ("wo.", "attention.wo."),
                     ("w1.", "feed_forward.w1."), ("w2.", "feed_forward.w2.")])


def _step1_name(name: str, cfg) -> str:
    parts = name.split(".")
    if parts[0] == "blocks":
        return (f"transformer.layers.{parts[1]}."
                + _norm_weight(_STEP1_LAYER(".".join(parts[2:]))))
    return "tok_embeddings.word_embeddings.weight"


_COG_TOP = _sub([("time_embedder.fc1.", "time_embedder.timestep_embedder.0."),
                 ("time_embedder.fc2.", "time_embedder.timestep_embedder.2.")])
_OMNIGEN_LAYER = _sub([("ln1.", "input_layernorm."), ("qkv.", "self_attn.qkv_proj."),
                       ("o.", "self_attn.o_proj."), ("ln2.", "post_attention_layernorm."),
                       ("gate_up.", "mlp.gate_up_proj."), ("down.", "mlp.down_proj.")])
_OMNIGEN_TOP = _sub([("embed_tokens", "llm.embed_tokens.weight"),
                     ("x_embedder.", "x_embedder.proj."),
                     ("input_x_embedder.", "input_x_embedder.proj."),
                     ("time_token.fc1.", "time_token.mlp.0."),
                     ("time_token.fc2.", "time_token.mlp.2."),
                     ("t_embedder.fc1.", "t_embedder.mlp.0."),
                     ("t_embedder.fc2.", "t_embedder.mlp.2."),
                     ("final_norm.", "llm.norm."),
                     ("final_adaln.", "final_layer.adaLN_modulation.1."),
                     ("final_linear.", "final_layer.linear.")])


def _omnigen_name(name: str, cfg) -> str:
    parts = name.split(".")
    if parts[0] == "blocks":
        return f"llm.layers.{parts[1]}." + _norm_weight(_OMNIGEN_LAYER(".".join(parts[2:])))
    return _norm_weight(_OMNIGEN_TOP(name))


# kinds whose JAX tree names differ from the port's: tree name -> port name
_RENAMES = {"hunyuan_dit": _hunyuan_dit_name, "hunyuan_bert": _bert_name,
            "step1_llm": _step1_name,
            "step_video_dit": lambda n, cfg: _norm_weight(n),
            "cog_dit": lambda n, cfg: _norm_weight(_COG_TOP(n)),
            "omnigen": _omnigen_name}


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _flatten(node, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(node)


def jax_tree_to_state_dict(tree, stacked: bool) -> Dict[str, torch.Tensor]:
    """Dotted torch names -> tensors. stacked: the `blocks`/`after_proj`/
    `single_blocks` subtrees carry a leading layer axis (DiT, VACE, FLUX)."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    quantized = {name.rsplit(".", 1)[0] for name in flat
                 if name.endswith((".w_q", ".w_q4"))}
    sd = {}
    for name, arr in flat.items():
        parts = name.split(".")
        items = [(parts, arr)]
        if stacked and parts[0] in _STACKED:
            items = [([parts[0], str(i)] + parts[1:], arr[i])
                     for i in range(arr.shape[0])]
        for p, a in items:
            if p[-1] == "w":
                p, a = p[:-1] + ["weight"], (a.T if a.ndim == 2 else a)
            elif p[-1] == "b" and name.rsplit(".", 1)[0] not in quantized:
                p = p[:-1] + ["bias"]
            sd[".".join(p)] = _to_tensor(a)
    return sd


def _swap_in_quant_linears(module: torch.nn.Module, sd: Dict[str, torch.Tensor]):
    """Replace each linear whose leaf arrived quantised by a `QuantLinear`
    holding that leaf's tensors."""
    for key in [k for k in sd if k.endswith((".w_q", ".w_q4"))]:
        path, kind = key.rsplit(".", 1)
        parent, _, name = path.rpartition(".")
        layer = QuantLinear(**{kind: sd.pop(key)}, w_scale=sd.pop(f"{path}.w_scale"),
                            b=sd.pop(f"{path}.b", None))
        setattr(module.get_submodule(parent) if parent else module, name, layer)
        for buf in ("w_q", "w_q4", "w_scale", "b"):
            if getattr(layer, buf) is not None:
                sd[f"{path}.{buf}"] = getattr(layer, buf)


def from_jax_params(kind: str, tree, cfg, device=None) -> torch.nn.Module:
    """The port's `kind` module holding the JAX tree's values (strict), on
    `device` (the card unless "cpu", as every entry point)."""
    device = resolve_device(device)
    if kind not in _MODULES and kind not in _BUILDERS:
        raise ValueError(f"unknown model kind {kind!r}; one of "
                         f"{sorted(_MODULES) + sorted(_BUILDERS)}")
    if kind == "flux_ipadapter":
        tree = {("blocks" if k == "modules" else k): v for k, v in tree.items()}
    sd = jax_tree_to_state_dict(tree, stacked=kind in _STACKED_KINDS)
    if kind in _RENAMES:
        sd = {_RENAMES[kind](k, cfg): v for k, v in sd.items()}
    with torch.device("meta"):
        if kind in _BUILDERS:
            module = _BUILDERS[kind](cfg, sd)
        else:
            module = (WanVAE38 if isinstance(cfg, WanVAE38Config) else _MODULES[kind])(cfg)
    _swap_in_quant_linears(module, sd)
    module.load_state_dict(sd, strict=True, assign=True)
    return module.to(device).eval()


def from_jax_lora(lora):
    """JAX LoRA pytree (numpy or jax leaves) -> the port's LoRA dict
    {'blocks.{i}.self_attn.q': {"A": (r, in), "B": (out, r)}} of fp32
    `nn.Parameter`s, ready for `trainers.lora_train.apply_lora`."""
    out = {}
    for path, ab in lora.items():
        a = np.asarray(ab["A"], np.float32)
        b = np.asarray(ab["B"], np.float32)
        if a.ndim == 3:
            head, tail = path.split("blocks.", 1)
            items = [(f"{head}blocks.{i}.{tail}", a[i], b[i]) for i in range(a.shape[0])]
        else:
            items = [(path, a, b)]
        for name, ai, bi in items:
            out[name] = {k: torch.nn.Parameter(torch.from_numpy(
                np.ascontiguousarray(x.T))) for k, x in (("A", ai), ("B", bi))}
    return out
