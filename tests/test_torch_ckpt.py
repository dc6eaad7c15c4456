"""The port's checkpoint loading against the JAX package's: detection, the
converters behind `from_pretrained`, the LoRA hotload stack, and the
tokenizer found beside a checkpoint.

Every file here is synthetic: tensors from a numpy seed under the
reference's key names (those the JAX converters read), written as the
release lays them out: DiT and VACE together in safetensors shards, umT5 and
the VAE as `.pth`. Widths: DiT/VACE dim 128 with `text_dim` 4096 and
`freq_dim` 256 (detection keeps those defaults in both packages), 2 DiT and
2 VACE blocks; umT5 and the VAE through small configs monkeypatched over
the module-level `UMT5_XXL`/`WAN21_VAE` of both packages (their
`from_pretrained` always builds those). Loaded weights must be bit-equal.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.clip_vit as JCLIP
import video_styler_tpu.models.t5 as JT
import video_styler_tpu.models.wan_dit as JD
import video_styler_tpu.models.wan_vae as JVAE
import video_styler_tpu.pipelines.wan_video as JW
from video_styler_tpu.prompters.wan_prompter import WanPrompter as JPrompter
from video_styler_tpu.utils import ckpt as JC
from video_styler_tpu.utils.model_config import ModelConfig as JModelConfig

import video_styler_tpu_torch.models.clip_vit as TCLIP
import video_styler_tpu_torch.models.t5 as TT
import video_styler_tpu_torch.models.wan_dit as TD
import video_styler_tpu_torch.models.wan_vace as TV
import video_styler_tpu_torch.models.wan_vae as TVAE
import video_styler_tpu_torch.pipelines.wan_video as TW
from video_styler_tpu_torch import safetensors_io
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.prompters.wan_prompter import WanPrompter as TPrompter
from video_styler_tpu_torch.utils import ckpt as TC
from video_styler_tpu_torch.utils.convert import (export_t5, export_vace,
                                                  export_wan_dit, export_wan_vae)
from video_styler_tpu_torch.utils.model_config import ModelConfig

from test_torch_pipeline import cpu_share  # noqa: F401

DIT = dict(dim=128, in_dim=4, ffn_dim=256, out_dim=4, num_heads=1, num_layers=2)
VACE = dict(vace_layers=(0, 1), vace_in_dim=72, dim=128, num_heads=1, ffn_dim=256)
T5 = dict(vocab=128, dim=64, dim_attn=64, dim_ffn=128, num_heads=4,
          num_layers=2, num_buckets=8)
VAE = dict(dim=16, z_dim=4, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
           latent_mean=(0.0,) * 4, latent_std=(1.0,) * 4)
TORCH = {"bf16": torch.bfloat16, "fp32": torch.float32}
JAXD = {"bf16": jnp.bfloat16, "fp32": jnp.float32}


def _random_like(names, seed, dtype):
    """{name: tensor of the meta tensor's shape}, N(0, 0.05^2) from a numpy
    seed, in sorted name order."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(0.05 * rng.standard_normal(tuple(t.shape))
                                .astype(np.float32)).to(dtype)
            for k, t in sorted(names.items())}


def _reference_files(folder, file_dtype=torch.bfloat16, seed=0):
    """The DiT+VACE as two safetensors shards, umT5 and the VAE as .pth
    (VAE in fp32, as the official file), under the reference's names.
    Returns (shard paths, vae path, t5 path)."""
    with torch.device("meta"):
        names = {**export_wan_dit(TD.WanDiT(TD.WanDiTConfig(**DIT))),
                 **export_vace(TV.WanVace(TV.VaceConfig(**VACE)))}
        t5_names = export_t5(TT.T5Encoder(TT.T5Config(**T5)))
        vae_names = export_wan_vae(TVAE.WanVAE(TVAE.WanVAEConfig(**VAE)))
    sd = _random_like(names, seed, file_dtype)
    keys = sorted(sd)
    shards = []
    for i, part in enumerate((keys[::2], keys[1::2])):
        path = os.path.join(folder, f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors")
        safetensors_io.save_file({k: sd[k] for k in part}, path)
        shards.append(path)
    vae_path = os.path.join(folder, "Wan2.1_VAE.pth")
    torch.save(_random_like(vae_names, seed + 1, torch.float32), vae_path)
    t5_path = os.path.join(folder, "models_t5_umt5-xxl-enc.pth")
    torch.save(_random_like(t5_names, seed + 2, file_dtype), t5_path)
    return shards, vae_path, t5_path


@pytest.fixture
def small_t5_vae(monkeypatch):
    """Both packages' pipelines build the small umT5 and VAE."""
    monkeypatch.setattr(TW, "UMT5_XXL", TT.T5Config(**T5))
    monkeypatch.setattr(TVAE, "WAN21_VAE", TVAE.WanVAEConfig(**VAE))
    monkeypatch.setattr(JW, "UMT5_XXL", JT.T5Config(**T5))
    monkeypatch.setattr(JVAE, "WAN21_VAE", JVAE.WanVAEConfig(**VAE))
    monkeypatch.setenv("VIDEO_STYLER_OFFLINE", "1")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(cls, jcfg, **port_only):
    """The port's config of a JAX config; `port_only`: the port's fields the
    JAX config has not (`has_control_adapter`), else their defaults."""
    fields = cls.__dataclass_fields__
    return cls(**{k: getattr(jcfg, k) for k in fields if hasattr(jcfg, k)}, **port_only)


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_bit_equal(got: torch.nn.Module, want: torch.nn.Module):
    g, w = got.state_dict(), want.state_dict()
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(_bits(g[k]), _bits(w[k])), k


# ---------------------------------------------------------------- detection

_Z = np.zeros((4, 4), np.float32)
KIND_CASES = [
    ({"double_blocks.0.img_attn.qkv.weight": _Z}, "flux_dit"),
    ({"img_in.weight": _Z}, "flux_dit"),
    ({"controlnet_x_embedder.weight": _Z}, "flux_controlnet"),
    ({"joint_blocks.0.x_block.attn.qkv.weight": _Z}, "sd3_dit"),
    ({"single_blocks.0.linear1.weight": _Z}, "hunyuan_video_dit"),
    ({"blocks.0.rota1.q_norm.weight": _Z}, "hunyuan_dit"),
    ({"llm.layers.0.self_attn.qkv_proj.weight": _Z}, "omnigen"),
    ({"encoder.layers.0.self_attention.query_key_value.weight": _Z},
     "kolors_text_encoder"),
    ({"transformer_blocks.0.attn1.norm_q.weight": _Z}, "qwen_image_dit"),
    ({"input_blocks.0.0.weight": _Z}, "sd_unet"),
    ({"wav2vec2.feature_extractor.conv_layers.0.conv.weight": _Z}, "wav2vec"),
    ({"blocks.0.self_attn.q.weight": _Z}, "dit"),
    ({"token_embedding.weight": _Z}, "t5"),
    ({"controlnet_blocks.0.x_rms.weight": _Z, "img_in.weight": _Z},
     "qwen_image_blockwise_controlnet"),
    ({"embedder.model_dict.blocks___0___ff_a___0.x": _Z}, "flux_lora_encoder"),
    ({"prefer_value_embedder.0.weight": _Z, "positional_embedding": _Z},
     "flux_value_encoder"),
    ({"layers.0.0.to_kv.weight": _Z, "latents": _Z}, "flux_infiniteyou_projector"),
    ({"tok_embeddings.word_embeddings.weight": _Z,
      "transformer.layers.0.attention.wqkv.weight": _Z}, "stepvideo_text_encoder"),
    ({"motion_modules.0.transformer_blocks.0.attention_blocks.0.to_q.weight": _Z},
     "motion_modules"),
    # the Wan families the port builds, and those it does not
    ({"vace_blocks.0.before_proj.weight": _Z}, "vace"),
    ({"vace.vace_blocks.0.before_proj.weight": _Z,
      "blocks.0.self_attn.q.weight": _Z}, "dit+vace"),
    ({"encoder.conv1.weight": _Z, "decoder.conv1.weight": _Z}, "vae"),
    ({"model.encoder.conv1.weight": _Z}, "vae"),
    ({"visual.patch_embedding.weight": _Z}, "clip"),
    ({"casual_audio_encoder.weights": _Z, "blocks.0.self_attn.q.weight": _Z}, "s2v"),
    ({"face_adapter.fuser_blocks.0.q.weight": _Z}, "animate"),
    ({"down_blocks.0.mix_factor": _Z}, "svd_unet"),
    ({"blocks.0.positional_conv.weight": _Z}, "svd_unet_exvideo"),
]


@pytest.mark.parametrize("sd,want", KIND_CASES, ids=[w for _, w in KIND_CASES])
def test_detect_model_kind_matches_jax(sd, want):
    assert JC.detect_model_kind(sd) == want
    assert TC.detect_model_kind(sd) == want


def test_detect_model_kind_unknown_raises_in_both():
    for detect in (JC.detect_model_kind, TC.detect_model_kind):
        with pytest.raises(ValueError):
            detect({"something.else": _Z})


class _Shape:
    """A stand-in tensor: detection reads only `.shape`."""

    def __init__(self, *shape):
        self.shape = shape


def _wan_keys(dim, ffn, layers, vace_blocks, in_dim=16, out_dim=16, vace_in=96):
    sd = {"patch_embedding.weight": _Shape(dim, in_dim, 1, 2, 2),
          "head.head.weight": _Shape(out_dim * 4, dim)}
    for i in range(layers):
        sd[f"blocks.{i}.self_attn.q.weight"] = _Shape(dim, dim)
        sd[f"blocks.{i}.ffn.0.weight"] = _Shape(ffn, dim)
    for i in range(vace_blocks):
        sd[f"vace_blocks.{i}.after_proj.weight"] = _Shape(dim, dim)
        sd[f"vace_blocks.{i}.ffn.0.weight"] = _Shape(ffn, dim)
    if vace_blocks:
        sd["vace_blocks.0.before_proj.weight"] = _Shape(dim, dim)
        sd["vace_patch_embedding.weight"] = _Shape(dim, vace_in, 1, 2, 2)
    return sd


CONFIG_CASES = {
    "14B": (_wan_keys(5120, 13824, 40, 8), TD.WAN_T2V_14B, TV.VACE_14B),
    # VACE_14B at dim 5120 whatever the block count, in both packages
    "14B-4-vace-blocks": (_wan_keys(5120, 13824, 40, 4), TD.WAN_T2V_14B, TV.VACE_14B),
    "1.3B": (_wan_keys(1536, 8960, 30, 15), None, TV.VACE_1_3B),
    "narrow": (_wan_keys(256, 512, 3, 2, in_dim=4, out_dim=4, vace_in=72), None, None),
}


@pytest.mark.parametrize("case", list(CONFIG_CASES))
def test_detect_configs_match_jax(case):
    sd, want_dit, want_vace = CONFIG_CASES[case]
    dit, jdit = TC.detect_wan_dit_config(sd), JC.detect_wan_dit_config(sd)
    vace, jvace = TC.detect_vace_config(sd), JC.detect_vace_config(sd)
    assert dit == _port_cfg(TD.WanDiTConfig, jdit)
    assert vace == _port_cfg(TV.VaceConfig, jvace)
    if want_dit is not None:
        assert dit == want_dit
    if want_vace is not None:
        assert vace == want_vace


def _image_dit_keys(case):
    if case == "ti2v":
        return _wan_keys(3072, 14336, 2, 0, in_dim=48, out_dim=48)
    sd = _wan_keys(5120, 13824, 2, 0, in_dim=36)
    if case in ("i2v", "flf2v", "ref_conv"):
        sd["blocks.0.cross_attn.k_img.weight"] = _Shape(5120, 5120)
    if case == "flf2v":
        sd["img_emb.emb_pos"] = _Shape(1, 514, 1280)
    if case == "ref_conv":
        sd["ref_conv.weight"] = _Shape(5120, 16, 2, 2)
    return sd


@pytest.mark.parametrize("case", ["i2v", "flf2v", "ti2v", "ref_conv"])
def test_detect_unported_dit_raises(case):
    """I2V (image input), FLF2V (and its CLIP position table), TI2V
    (separated timestep, fused first frame) and Fun V1.1 (a reference conv)
    DiTs are detected as the JAX detector detects them."""
    sd = _image_dit_keys(case)
    jcfg = JC.detect_wan_dit_config(sd)
    cfg = TC.detect_wan_dit_config(sd)
    assert cfg == _port_cfg(TD.WanDiTConfig, jcfg)
    want = {"i2v": TD.WAN_I2V_14B, "ti2v": TD.WAN_TI2V_5B,
            "flf2v": dataclasses.replace(TD.WAN_I2V_14B, has_image_pos_emb=True),
            "ref_conv": dataclasses.replace(TD.WAN_I2V_14B, has_ref_conv=True)}[case]
    assert cfg == dataclasses.replace(want, num_layers=2)
    assert cfg.has_ref_conv == jcfg.has_ref_conv == (case == "ref_conv")


def test_wan22_i2v_detection_fault_is_mirrored(tmp_path):
    """A Wan2.2-I2V-A14B expert has 36 input channels but no `k_img` (no
    CLIP branch): both detectors give has_image_input=False, so both
    pipelines build no y for an input image and 16 latent channels meet
    the 36-channel patch embedding (ROADMAP Queue 3). At smoke size: a DiT
    taking 2z + 4 channels without image input, given an image."""
    sd = _wan_keys(5120, 13824, 2, 0, in_dim=36)
    for detect in (JC.detect_wan_dit_config, TC.detect_wan_dit_config):
        cfg = detect(sd)
        assert cfg.in_dim == 36 and not cfg.has_image_input and cfg.require_vae_embedding
    from test_torch_pipeline import DIT as SMOKE_DIT, _pipelines, _tree
    jp, tp = _pipelines(jnp.float32, torch.float32)
    jp.vace_cfg = jp.vace_params = None
    tp.vace = None
    jp.dit_cfg = JD.WanDiTConfig(**dict(SMOKE_DIT, in_dim=12))
    jp.dit_params = JD.init_wan_dit(jax.random.PRNGKey(0), jp.dit_cfg)
    tp.dit = from_jax_params("dit", _tree(jp.dit_params),
                             TD.WanDiTConfig(**dict(SMOKE_DIT, in_dim=12)), device="cpu")
    from PIL import Image
    image = Image.fromarray(np.full((32, 32, 3), 128, np.uint8))
    kw = dict(prompt="x", input_image=image, num_frames=5, height=32, width=32, seed=1,
              num_inference_steps=1, cfg_scale=1.0, return_latents=True)
    assert jp.build_image_conditioning(image, None, 5, 32, 32, False, None, None) == (None,
                                                                                      None)
    with pytest.raises(TypeError, match="dot_general"):
        jp(**kw)
    with pytest.raises(RuntimeError, match="shapes cannot be multiplied"):
        tp(**kw)


# ---------------------------------------------------------------- loading

LOAD_CASES = {"bf16": ("bf16", "bf16"), "fp32": ("fp32", "fp32"),
              "bf16-files-fp32-pipeline": ("bf16", "fp32")}


@pytest.mark.parametrize("case", list(LOAD_CASES))
def test_from_pretrained_matches_jax(case, tmp_path, small_t5_vae):
    """Two DiT+VACE shards, a VAE .pth and a umT5 .pth through both
    packages' `from_pretrained`: the port's modules are bit-equal to
    `from_jax_params` of what the JAX converters made of the same files."""
    file_dtype, dtype = LOAD_CASES[case]
    shards, vae_path, t5_path = _reference_files(str(tmp_path), TORCH[file_dtype])
    jp = JW.WanVideoPipeline.from_pretrained(
        [JModelConfig(path=shards), JModelConfig(path=vae_path),
         JModelConfig(path=t5_path)], dtype=JAXD[dtype])
    tp = TW.WanVideoPipeline.from_pretrained(
        [ModelConfig(path=shards), ModelConfig(path=vae_path), ModelConfig(path=t5_path)],
        device="cpu", dtype=TORCH[dtype])

    assert tp.dit.cfg == _port_cfg(TD.WanDiTConfig, jp.dit_cfg)
    assert tp.dit.cfg == TD.WanDiTConfig(**DIT)
    assert tp.vace.cfg == _port_cfg(TV.VaceConfig, jp.vace_cfg) == TV.VaceConfig(**VACE)
    _assert_bit_equal(tp.dit, from_jax_params("dit", _np(jp.dit_params), tp.dit.cfg,
                                              device="cpu"))
    _assert_bit_equal(tp.vace, from_jax_params("vace", _np(jp.vace_params), tp.vace.cfg,
                                               device="cpu"))
    _assert_bit_equal(tp.vae, from_jax_params("vae", _np(jp.vae_params),
                                              TVAE.WanVAEConfig(**VAE), device="cpu"))
    _assert_bit_equal(tp.prompter.text_encoder, from_jax_params(
        "t5", _np(jp.text_encoder_params), TT.T5Config(**T5), device="cpu"))
    assert tp.dit.patch_embedding.weight.dtype == TORCH[dtype]
    assert tp.vae.conv1.weight.dtype == torch.float32


def test_load_model_matches_from_pretrained(tmp_path, monkeypatch):
    """`load_model` on each file: its kind, configs and modules."""
    for module in (TT, TW):
        monkeypatch.setattr(module, "UMT5_XXL", TT.T5Config(**T5))
    monkeypatch.setattr(TVAE, "WAN21_VAE", TVAE.WanVAEConfig(**VAE))
    shards, vae_path, t5_path = _reference_files(str(tmp_path))
    kind, out = TC.load_model(shards, device="cpu")
    assert kind == "dit+vace" and out["dit_cfg"] == TD.WanDiTConfig(**DIT)
    assert out["vace_cfg"] == TV.VaceConfig(**VACE)
    kind_v, vae = TC.load_model(vae_path, device="cpu")
    kind_t, t5 = TC.load_model(t5_path, device="cpu")
    assert (kind_v, kind_t) == ("vae", "t5")
    tp = TW.WanVideoPipeline(device="cpu")
    for kind, sd in (("dit+vace", TC.load_state_dict_files(shards, lazy=True)),
                     ("vae", TC.load_state_dict(vae_path, lazy=True)),
                     ("t5", TC.load_state_dict(t5_path, lazy=True))):
        tp._attach(kind, sd)
    _assert_bit_equal(out["dit"], tp.dit)
    _assert_bit_equal(out["vace"], tp.vace)
    _assert_bit_equal(vae["vae"], tp.vae)
    _assert_bit_equal(t5, tp.prompter.text_encoder)


CLIP_FILE = dict(image_size=28, patch_size=14, dim=64, num_heads=2, num_layers=32)
VAE38_FILE = dict(dim=16, dec_dim=16, z_dim=48, num_res_blocks=1,
                  latent_mean=(0.0,) * 48, latent_std=(1.0,) * 48)
FLF2V_FILE = dict(DIT, in_dim=36, has_image_input=True, has_image_pos_emb=True)


def _image_files(folder, file_dtype=torch.bfloat16, seed=10):
    """An FLF2V DiT (k_img, v_img, norm_k_img, img_emb with emb_pos) as two
    safetensors shards, a CLIP `.pth` (`visual.*` keys; 32 blocks, as the
    JAX converter reads ViT-H/14's count, 64 wide) and a Wan2.2 VAE `.pth`
    (z 48, so its top conv1 has 96 rows; 16 wide), under the reference's
    names. Returns (shard paths, clip path, vae path)."""
    with torch.device("meta"):
        names = export_wan_dit(TD.WanDiT(TD.WanDiTConfig(**FLF2V_FILE)))
        clip_names = TCLIP.export_clip_vit(TCLIP.ClipVit(TCLIP.ClipVitConfig(**CLIP_FILE)))
        vae_names = export_wan_vae(TVAE.WanVAE38(TVAE.WanVAE38Config(**VAE38_FILE)))
    sd = _random_like(names, seed, file_dtype)
    keys = sorted(sd)
    shards = []
    for i, part in enumerate((keys[::2], keys[1::2])):
        path = os.path.join(folder, f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors")
        safetensors_io.save_file({k: sd[k] for k in part}, path)
        shards.append(path)
    clip_path = os.path.join(folder, "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth")
    torch.save(_random_like(clip_names, seed + 1, file_dtype), clip_path)
    vae_path = os.path.join(folder, "Wan2.2_VAE.pth")
    torch.save(_random_like(vae_names, seed + 2, torch.float32), vae_path)
    return shards, clip_path, vae_path


@pytest.mark.parametrize("case", list(LOAD_CASES))
def test_image_files_from_pretrained_match_jax(case, tmp_path, small_t5_vae, monkeypatch):
    """FLF2V DiT shards, a CLIP `.pth` and a Wan2.2 VAE `.pth` through both
    packages' `from_pretrained` (and the port's `load_model`): the port's
    modules are bit-equal to `from_jax_params` of the JAX converters'
    output. The JAX pipeline keeps its Wan2.1 VAE config for the Wan2.2
    file (ROADMAP Queue 3); the port builds a `WanVAE38`."""
    monkeypatch.setattr(TCLIP, "CLIP_VIT_H_14", TCLIP.ClipVitConfig(**CLIP_FILE))
    monkeypatch.setattr(JCLIP, "CLIP_VIT_H_14", JCLIP.ClipVitConfig(**CLIP_FILE))
    monkeypatch.setattr(TVAE, "WAN22_VAE", TVAE.WanVAE38Config(**VAE38_FILE))
    file_dtype, dtype = LOAD_CASES[case]
    shards, clip_path, vae_path = _image_files(str(tmp_path), TORCH[file_dtype])
    jp = JW.WanVideoPipeline.from_pretrained(
        [JModelConfig(path=shards), JModelConfig(path=clip_path), JModelConfig(path=vae_path)],
        dtype=JAXD[dtype])
    tp = TW.WanVideoPipeline.from_pretrained(
        [ModelConfig(path=shards), ModelConfig(path=clip_path), ModelConfig(path=vae_path)],
        device="cpu", dtype=TORCH[dtype])

    assert tp.dit.cfg == _port_cfg(TD.WanDiTConfig, jp.dit_cfg) == TD.WanDiTConfig(**FLF2V_FILE)
    _assert_bit_equal(tp.dit, from_jax_params("dit", _np(jp.dit_params), tp.dit.cfg,
                                              device="cpu"))
    clip_cfg = TCLIP.ClipVitConfig(**CLIP_FILE)
    _assert_bit_equal(tp.image_encoder, from_jax_params(
        "clip", _np(jp.image_encoder_params), clip_cfg, device="cpu"))
    vae_cfg = TVAE.WanVAE38Config(**VAE38_FILE)
    _assert_bit_equal(tp.vae, from_jax_params("vae", _np(jp.vae_params), vae_cfg,
                                              device="cpu"))
    assert isinstance(tp.vae, TVAE.WanVAE38) and tp.vae.cfg == vae_cfg
    assert jp.vae_cfg == JVAE.WAN21_VAE
    assert tp.dit.img_emb.emb_pos.dtype == TORCH[dtype]
    assert tp.image_encoder.blocks[0].to_qkv.weight.dtype == TORCH[dtype]
    assert tp.vae.conv1.weight.dtype == torch.float32

    kind, clip = TC.load_model(clip_path, device="cpu", dtype=TORCH[dtype])
    assert kind == "clip"
    _assert_bit_equal(clip, tp.image_encoder)
    kind, vae = TC.load_model(vae_path, device="cpu")
    assert kind == "vae" and vae["vae_cfg"] == vae_cfg
    _assert_bit_equal(vae["vae"], tp.vae)
    kind, dit = TC.load_model(shards, device="cpu", dtype=TORCH[dtype])
    assert kind == "dit" and dit["dit_cfg"] == tp.dit.cfg
    _assert_bit_equal(dit["dit"], tp.dit)


def test_release_files_of_an_flf2v_pipeline_load_back(tmp_path, small_t5_vae, monkeypatch):
    """`save_release_files` of an FLF2V pipeline (no VACE; a CLIP tower):
    DiT shards with the image keys and the position table, umT5, the VAE
    and the CLIP `.pth`, read back by `from_pretrained` bit-equal, module by
    module."""
    from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer
    from video_styler_tpu_torch.utils.convert import save_release_files
    clip_cfg = TCLIP.ClipVitConfig(**dict(CLIP_FILE, num_layers=2))
    monkeypatch.setattr(TCLIP, "CLIP_VIT_H_14", clip_cfg)
    pipe = TW.WanVideoPipeline.from_configs(
        TD.WanDiTConfig(**FLF2V_FILE), None, TT.T5Config(**T5), TVAE.WanVAEConfig(**VAE),
        StubTokenizer(16), 16, seed=0, device="cpu", clip_cfg=clip_cfg)
    with torch.no_grad():
        pipe.dit.img_emb.emb_pos.normal_()   # zero at init: make it count
    paths = save_release_files(pipe, str(tmp_path), n_shards=3)
    assert len(paths["dit"]) == 3 and os.path.basename(paths["vae"]) == "Wan2.1_VAE.pth"
    groups = [paths["dit"], [paths["vae"]], [paths["t5"]], [paths["clip"]]]
    kinds = [TC.detect_model_kind(TC.load_state_dict_files(g, lazy=True)) for g in groups]
    assert kinds == ["dit", "vae", "t5", "clip"]
    back = TW.WanVideoPipeline.from_pretrained([ModelConfig(path=g) for g in groups],
                                               device="cpu")
    assert back.dit.cfg == pipe.dit.cfg
    for name in ("dit", "vae", "image_encoder"):
        _assert_bit_equal(getattr(back, name), getattr(pipe, name))
    _assert_bit_equal(back.prompter.text_encoder, pipe.prompter.text_encoder)


def test_safetensors_and_pth_load_identically(tmp_path):
    """The same tensors (bf16, fp32, int64) from a safetensors file and a
    .pth load identically, lazily or not; detection reads no tensor bytes,
    and `read_tensors` reads each tensor's bytes once."""
    rng = np.random.default_rng(3)
    sd = {"a.weight": torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)
                                       ).to(torch.bfloat16),
          "b.bias": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
          "c.index": torch.arange(5, dtype=torch.int64),
          "d.scalar": torch.tensor(1.5)}
    st, pth = str(tmp_path / "m.safetensors"), str(tmp_path / "m.pth")
    safetensors_io.save_file(sd, st)
    torch.save({"state_dict": sd}, pth)
    for path in (st, pth):
        before = TC.BYTES_READ
        lazy = TC.load_state_dict(path, lazy=True)
        assert all(isinstance(v, TC.LazyTensor) for v in lazy.values())
        assert TC.hash_state_dict_keys(lazy) == TC.hash_state_dict_keys(sd)
        assert TC.BYTES_READ == before
        eager = TC.load_state_dict(path)
        read = TC.read_tensors(lazy, "cpu")
        assert TC.BYTES_READ - before == 2 * sum(t.numel() * t.element_size()
                                                 for t in sd.values())
        for got in (eager, read):
            assert got.keys() == sd.keys()
            for k in sd:
                assert got[k].dtype == sd[k].dtype and torch.equal(_bits(got[k]), _bits(sd[k]))
    prefixed = TC.load_state_dict(st, prefix="a.")
    assert list(prefixed) == ["weight"]
    # the JAX loader reads the same file (as fp32 numpy)
    jsd = JC.load_state_dict(st)
    np.testing.assert_array_equal(jsd["a.weight"], sd["a.weight"].float().numpy())


def test_pth_not_row_major_raises(tmp_path):
    """A .pth tensor that is not row-major has no byte range of its own in
    the file: the loader names the file and the tensor instead of reading it
    through the mapping."""
    path = str(tmp_path / "strided.pth")
    torch.save({"w": torch.arange(12.0).reshape(3, 4).t(), "b": torch.zeros(4)}, path)
    with pytest.raises(ValueError, match=r"strided\.pth.*not row-major.*'w'"):
        TC.load_state_dict(path, lazy=True)


def test_vace_prefix_quirk_is_mirrored(tmp_path, monkeypatch):
    """Both detectors call a file with `vace.vace_blocks.*` keys a DiT+VACE;
    both converters read only `vace_blocks.*`, so neither loads it."""
    monkeypatch.setenv("VIDEO_STYLER_OFFLINE", "1")
    shards, _, _ = _reference_files(str(tmp_path))
    sd = TC.load_state_dict_files(shards)
    sd = {("vace." + k if k.startswith("vace") else k): v for k, v in sd.items()}
    path = str(tmp_path / "prefixed.safetensors")
    safetensors_io.save_file(sd, path)
    jsd = JC.load_state_dict(path)
    assert JC.detect_model_kind(jsd) == TC.detect_model_kind(sd) == "dit+vace"
    with pytest.raises(AttributeError):   # its detect_vace_config gives None
        JW.WanVideoPipeline.from_pretrained([JModelConfig(path=path)])
    with pytest.raises(KeyError, match="vace_blocks.0.before_proj.weight"):
        TW.WanVideoPipeline.from_pretrained([ModelConfig(path=path)], device="cpu")


def test_unported_kinds_raise(tmp_path, monkeypatch):
    """No kind is left unported (item 11f built the last ones): a file of
    hunyuan_dit keys goes to `build_family_module`, which names the key it
    lacks, and the Wan pipeline refuses the kind as the JAX one does. `s2v` and
    `wav2vec` attach as in the JAX pipeline: `s2v` builds the default (14B)
    config whatever the file, `wav2vec` raises the JAX pipeline's
    ValueError (ROADMAP Queue 3). `flux_dit` and `motion_modules` are ported
    (`load_model` builds them) and, as in the JAX package, are no kind of
    the Wan pipeline; so is `hunyuan_video_dit` (ported with item 11e)."""
    import video_styler_tpu_torch.models.wan_s2v as TS
    path = str(tmp_path / "hunyuan_dit.safetensors")
    safetensors_io.save_file({"blocks.0.attn1.Wqkv.weight": torch.zeros(12, 4)}, path)
    with pytest.raises(KeyError, match="text_emb_padding"):
        TC.load_model(path, device="cpu")
    tp = TW.WanVideoPipeline(device="cpu")
    assert TC.UNPORTED_KINDS == {}
    jp = JW.WanVideoPipeline(dtype=jnp.float32)
    for pipe in (jp, tp):
        with pytest.raises(ValueError, match="unknown model kind hunyuan_dit"):
            pipe._attach("hunyuan_dit", {})
        with pytest.raises(ValueError, match="unknown model kind wav2vec"):
            pipe._attach("wav2vec", {})
        with pytest.raises(ValueError, match="unknown model kind motion_modules"):
            pipe._attach("motion_modules", {})
        with pytest.raises(ValueError, match="unknown model kind flux_dit"):
            pipe._attach("flux_dit", {})
        with pytest.raises(ValueError, match="unknown model kind"):
            pipe._attach("not-a-kind", {})
    built = []

    def convert(sd, cfg):
        built.append(cfg)
        raise KeyError("stop")
    monkeypatch.setattr(TS, "convert_wan_s2v", convert)
    with pytest.raises(KeyError, match="stop"):
        tp._attach("s2v", {})
    assert built == [TS.WAN_S2V_14B]
    monkeypatch.undo()
    # the DiT's shards read as an S2V file: the 14B S2V keys are missing
    shards, _, _ = _reference_files(str(tmp_path))
    with pytest.raises(KeyError):
        TW.WanVideoPipeline.from_pretrained(
            [ModelConfig(path=shards, model_kind="s2v")], device="cpu")


def test_model_config_resolves_locally(tmp_path, monkeypatch):
    d = tmp_path / "Wan-AI" / "Wan2.1-VACE-14B"
    d.mkdir(parents=True)
    for i in (1, 2):
        (d / f"diffusion_pytorch_model-0000{i}-of-00002.safetensors").write_bytes(b"")
    monkeypatch.setenv("VIDEO_STYLER_MODEL_DIR", str(tmp_path))
    mc = ModelConfig(model_id="Wan-AI/Wan2.1-VACE-14B",
                     origin_file_pattern="diffusion_pytorch_model*.safetensors")
    assert [os.path.basename(p) for p in mc.paths()] == [
        "diffusion_pytorch_model-00001-of-00002.safetensors",
        "diffusion_pytorch_model-00002-of-00002.safetensors"]
    jmc = JModelConfig(model_id="Wan-AI/Wan2.1-VACE-14B",
                       origin_file_pattern="diffusion_pytorch_model*.safetensors")
    assert jmc.paths() == mc.paths()
    with pytest.raises(FileNotFoundError, match="Wan2.1_VAE.pth"):
        ModelConfig(model_id="Wan-AI/Wan2.1-VACE-14B",
                    origin_file_pattern="Wan2.1_VAE.pth").paths()
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        TW.WanVideoPipeline.from_pretrained([ModelConfig(path=str(tmp_path / "missing.pth"))],
                                            device="cpu")


# ---------------------------------------------------------------- LoRA hotload

def _lora_sd(seed, rank=4):
    """Reference-named LoRA factors on the VACE q, k, v, o, ffn.0, ffn.2."""
    rng = np.random.default_rng(seed)
    sd = {}
    dim, ffn = VACE["dim"], VACE["ffn_dim"]
    for i in range(len(VACE["vace_layers"])):
        shapes = {f"{a}.{n}": (dim, dim) for a in ("self_attn", "cross_attn")
                  for n in "qkvo"}
        shapes.update({"ffn.0": (ffn, dim), "ffn.2": (dim, ffn)})
        for name, (out_f, in_f) in shapes.items():
            pre = f"vace_blocks.{i}.{name}"
            sd[f"{pre}.lora_A.weight"] = (0.1 * rng.standard_normal((rank, in_f))
                                          ).astype(np.float32)
            sd[f"{pre}.lora_B.weight"] = (0.1 * rng.standard_normal((out_f, rank))
                                          ).astype(np.float32)
    return sd


def test_hotload_stack_matches_jax(tmp_path, small_t5_vae):
    """Two hotloaded LoRAs on the VACE branch, the last rescaled to 0.5 and
    then 0, against the JAX pipeline's stack on the same files (fp32, tight
    rtol); with every scale 0, and after `unload_loras`, the weights are
    bit-equal to the loaded base."""
    shards, _, _ = _reference_files(str(tmp_path), torch.float32)
    jp = JW.WanVideoPipeline.from_pretrained([JModelConfig(path=shards)], dtype=jnp.float32)
    tp = TW.WanVideoPipeline.from_pretrained([ModelConfig(path=shards)], device="cpu",
                                             dtype=torch.float32)
    base = {k: v.clone() for k, v in tp.vace.state_dict().items()}
    loras = [_lora_sd(10), _lora_sd(11)]
    path = str(tmp_path / "lora.safetensors")
    safetensors_io.save_file(loras[1], path)
    jp.load_lora("vace", state_dict=loras[0], alpha=1.0, hotload=True)
    jp.load_lora("vace", state_dict=loras[1], alpha=0.8, hotload=True)
    tp.load_lora("vace", state_dict={k: torch.from_numpy(v) for k, v in loras[0].items()},
                 alpha=1.0, hotload=True)
    tp.load_lora("vace", path=path, alpha=0.8, hotload=True)

    def check():
        want = from_jax_params("vace", _np(jp.vace_params), tp.vace.cfg, device="cpu")
        for k, v in want.state_dict().items():
            np.testing.assert_allclose(tp.vace.state_dict()[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)

    check()
    for scale in (0.5, 0.0):
        jp.set_lora_scale("vace", scale)
        tp.set_lora_scale("vace", scale)
        check()
    tp.set_lora_scale("vace", 0.0, index=0)
    for k, v in tp.vace.state_dict().items():
        assert torch.equal(v, base[k]), k
    tp.set_lora_scale("vace", 1.0, index=0)
    jp.unload_loras("vace")
    tp.unload_loras("vace")
    check()
    for k, v in tp.vace.state_dict().items():
        assert torch.equal(v, base[k]), k
    assert "vace" not in tp._lora_stacks


# ---------------------------------------------------------------- tokenizer

def _save_tokenizer(folder):
    """A small word-level tokenizer built here, saved as transformers saves
    one (tokenizer.json, tokenizer_config.json)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    words = "make it a watercolor painting of the city at night".split()
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2, **{w: i + 3 for i, w in enumerate(words)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>",
                                   unk_token="<unk>", eos_token="</s>")
    fast.save_pretrained(folder)


def test_fetch_tokenizer_near_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("VIDEO_STYLER_OFFLINE", "1")
    ckpt = tmp_path / "Wan2.1-VACE-14B" / "diffusion_pytorch_model.safetensors"
    ckpt.parent.mkdir()
    ckpt.write_bytes(b"")
    # no tokenizer beside the checkpoint yet: neither package finds one
    assert TPrompter().fetch_tokenizer_near([str(ckpt)]) is False
    assert JPrompter().fetch_tokenizer_near([str(ckpt)]) is False
    _save_tokenizer(str(ckpt.parent / "google" / "umt5-xxl"))
    tp, jp = TPrompter(), JPrompter()
    assert tp.fetch_tokenizer_near([str(ckpt)]) is True
    assert jp.fetch_tokenizer_near([str(ckpt)]) is True
    for prompt in ("make it a watercolor  painting", "the city at night, unseen words"):
        t_ids, t_mask = tp.tokenize(prompt)
        j_ids, j_mask = jp.tokenize(prompt)
        assert t_ids.shape == (1, 512)
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_mask, j_mask)
        assert t_mask.sum() > 1


# ------------------------------------------------- Fun, Animate, speed files

FUN_FILES = {"control-ref_conv": dict(DIT, in_dim=16, has_ref_conv=True),
             "camera-control_adapter": dict(DIT, in_dim=8, has_control_adapter=True)}


def _write_shards(folder, sd, name="diffusion_pytorch_model"):
    keys = sorted(sd)
    paths = []
    for i, part in enumerate((keys[::2], keys[1::2])):
        path = os.path.join(folder, f"{name}-0000{i + 1}-of-00002.safetensors")
        safetensors_io.save_file({k: sd[k] for k in part}, path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("case", list(FUN_FILES))
def test_fun_dit_files_from_pretrained_match_jax(case, tmp_path, monkeypatch):
    """A Fun V1.1 Control DiT (`ref_conv`, a Conv2d (dim, z, 2, 2)) and a Fun
    Camera DiT (`control_adapter.*`, the SimpleAdapter) through both
    packages' `from_pretrained`: detected alike (the port's config also
    names the adapter, which the JAX converter adds by key), the port's
    DiT bit-equal to `from_jax_params` of the JAX converter's tree."""
    monkeypatch.setenv("VIDEO_STYLER_OFFLINE", "1")
    cfg = TD.WanDiTConfig(**FUN_FILES[case])
    with torch.device("meta"):
        names = export_wan_dit(TD.WanDiT(cfg))
    assert ("ref_conv.weight" in names) == cfg.has_ref_conv
    if cfg.has_ref_conv:
        assert tuple(names["ref_conv.weight"].shape) == (128, 4, 2, 2)
    shards = _write_shards(str(tmp_path), _random_like(names, 3, torch.bfloat16))
    jp = JW.WanVideoPipeline.from_pretrained([JModelConfig(path=shards)], dtype=jnp.bfloat16)
    tp = TW.WanVideoPipeline.from_pretrained([ModelConfig(path=shards)], device="cpu")
    assert tp.dit.cfg == cfg
    assert tp.dit.cfg == _port_cfg(TD.WanDiTConfig, jp.dit_cfg,
                                   has_control_adapter="control_adapter" in jp.dit_params)
    assert ("ref_conv" in jp.dit_params) == cfg.has_ref_conv
    _assert_bit_equal(tp.dit, from_jax_params("dit", _np(jp.dit_params), cfg, device="cpu"))
    kind, dit = TC.load_model(shards, device="cpu")
    assert kind == "dit"
    _assert_bit_equal(dit["dit"], tp.dit)


def _animate_file(folder, seed=4):
    """The Wan2.2-Animate release's layout: the DiT (I2V keys) and the
    adapter in the same shards (small widths: dim 128, 1 head of 128, 2
    layers; a face size of 64, 1 face block)."""
    from video_styler_tpu_torch.models import wan_animate as TA
    cfg = TA.AnimateConfig(dim=128, num_face_blocks=1, face_size=64, face_conv_dim=32,
                           pose_in_dim=4)
    with torch.device("meta"):
        names = {**export_wan_dit(TD.WanDiT(TD.WanDiTConfig(**dict(DIT, in_dim=12,
                                                                   has_image_input=True)))),
                 **TA.export_wan_animate(TA.WanAnimateAdapter(cfg, 128))}
    sd = _random_like(names, seed, torch.bfloat16)
    for k in sd:
        if k.endswith(".kernel"):   # the blur kernels are fixed values
            sd[k] = TA._blur_kernel().to(torch.bfloat16)
    return _write_shards(folder, sd), cfg


def test_animate_file_detection_fault_is_mirrored(tmp_path, monkeypatch):
    """The official Animate file holds the DiT beside the adapter: both
    detectors call it `animate` (a `face_adapter.`/`pose_patch_embedding.`
    key wins before the DiT rule), both pipelines attach only the adapter
    (the JAX one nests the whole file into it) and load no DiT (ROADMAP
    Queue 3). The adapter is bit-equal to `from_jax_params` of the JAX
    tree's adapter part; naming the DiT's kind as well loads both."""
    from video_styler_tpu_torch.models import wan_animate as TA
    monkeypatch.setenv("VIDEO_STYLER_OFFLINE", "1")
    shards, cfg = _animate_file(str(tmp_path))
    sd = TC.load_state_dict_files(shards, lazy=True)
    assert TC.detect_model_kind(sd) == JC.detect_model_kind(sd) == "animate"
    jp = JW.WanVideoPipeline.from_pretrained([JModelConfig(path=shards)], dtype=jnp.bfloat16)
    tp = TW.WanVideoPipeline.from_pretrained([ModelConfig(path=shards)], device="cpu")
    assert jp.dit_params is None and tp.dit is None
    assert "blocks" in jp.animate_params   # the DiT's keys, nested into the adapter
    tree = {k: v for k, v in jp.animate_params.items() if k + "." in TA.ANIMATE_PREFIXES}
    assert tp.animate.cfg == cfg
    _assert_bit_equal(tp.animate, from_jax_params("animate", _np(tree), cfg, device="cpu"))
    both = TW.WanVideoPipeline.from_pretrained(
        [ModelConfig(path=shards, model_kind="dit"),
         ModelConfig(path=shards, model_kind="animate")], device="cpu")
    assert both.dit is not None and both.dit.cfg.has_image_input
    _assert_bit_equal(both.animate, tp.animate)
    kind, adapter = TC.load_model(shards, device="cpu")
    assert kind == "animate"
    _assert_bit_equal(adapter, tp.animate)


def test_speed_controller_file_detection_fault_is_mirrored(tmp_path, monkeypatch):
    """The speed controller's `model.safetensors` (`linear.{0,2,4}.*`) is
    detected by neither package (a ValueError: ROADMAP Queue 3); with its
    kind named, both load it, the port's bit-equal to `from_jax_params`."""
    from video_styler_tpu_torch.models import wan_controllers as TCTL
    monkeypatch.setenv("VIDEO_STYLER_OFFLINE", "1")
    with torch.device("meta"):
        names = TCTL.export_motion_controller(TCTL.MotionController(128, 256))
    path = str(tmp_path / "model.safetensors")
    safetensors_io.save_file(_random_like(names, 5, torch.bfloat16), path)
    sd = TC.load_state_dict(path)
    for detect in (TC.detect_model_kind, JC.detect_model_kind):
        with pytest.raises(ValueError, match="cannot detect model kind"):
            detect(sd)
    with pytest.raises(ValueError, match="cannot detect model kind"):
        TW.WanVideoPipeline.from_pretrained([ModelConfig(path=path)], device="cpu")
    jp = JW.WanVideoPipeline.from_pretrained(
        [JModelConfig(path=path, model_kind="motion_controller")], dtype=jnp.bfloat16)
    tp = TW.WanVideoPipeline.from_pretrained(
        [ModelConfig(path=path, model_kind="motion_controller")], device="cpu")
    _assert_bit_equal(tp.motion_controller, from_jax_params(
        "motion_controller", _np(jp.motion_controller_params), None, device="cpu"))
    assert tp.motion_controller.fc3.weight.shape == (6 * 128, 128)
