"""Text-to-image with the PyTorch/CUDA port, by family.

    python -m video_styler_tpu_torch.image_gen --family flux --prompt "a cat" \
        --dit_path flux1-dev.safetensors --vae_path vae.safetensors \
        --clip_path clip_l.safetensors --t5_path "t5-1.safetensors|t5-2.safetensors" \
        --tokenizer_path tokenizer --tokenizer_2_path tokenizer_2 --output out.png
    python -m video_styler_tpu_torch.image_gen --family flux --smoke --device cpu
    python -m video_styler_tpu_torch.image_gen --family sd3 --prompt "a cat" \
        --dit_path sd3.5_large.safetensors --vae_path vae.safetensors
    python -m video_styler_tpu_torch.image_gen --family sd --prompt "a cat" \
        --dit_path v1-5-pruned-emaonly.safetensors --tokenizer_path clip_tokenizer \
        --height 512 --width 512
    python -m video_styler_tpu_torch.image_gen --family sdxl --smoke --device cpu
    python -m video_styler_tpu_torch.image_gen --family hunyuan_image --smoke --device cpu
    python -m video_styler_tpu_torch.image_gen --family omnigen --smoke --device cpu
    python -m video_styler_tpu_torch.image_gen --family qwen --prompt "a cat" \
        --dit_path "dit-1.safetensors|dit-2.safetensors" --vae_path vae.safetensors \
        --text_encoder_path "te-1.safetensors|te-2.safetensors" --tokenizer_path tokenizer \
        --cfg_scale 4 --height 1328 --width 1328

The counterpart of the JAX package's `examples/image_gen.py`, for the
families the port runs: `flux` (FLUX.1-dev, or schnell where the DiT file
has no guidance embedder; embedded guidance 3.5, CFG 1, --steps steps,
--lora_path merged at alpha 1), `sd3` (SD3 / SD3.5, the config inferred
from the DiT file; --cfg_scale, default 7.5, with --negative_prompt; the
JAX runner's `from_pretrained` loads the DiT and the VAE only, so without
--smoke the prompter has no text encoder and the request raises, as the
JAX runner's does), `sd` (SD 1.5 from a civitai single file: UNet, CLIP-L
and VAE; DDIM, --cfg_scale) and `sdxl` (SDXL from a civitai single file:
the UNet, CLIP-L, CLIP-G and the VAE; the JAX runner passes the UNet
alone, under LDM names its converter does not rename, and no text tower or
VAE, so its request cannot run) and `qwen` (Qwen-Image: the DiT, the VAE
and, from --text_encoder_path with --tokenizer_path, the Qwen2.5-VL text
tower; --cfg_scale two-pass; the JAX runner fetches no text encoder, so its
request calls None; here a request without one raises a RuntimeError
naming what it lacks), `hunyuan_image` (HunyuanDiT: the DiT, the SDXL VAE,
the CLIP-BERT of --clip_path and mT5-XL of --t5_path with their tokenizers
--tokenizer_path and --tokenizer_2_path; --cfg_scale two-pass) and
`omnigen` (OmniGen: the transformer, the SDXL VAE and the Phi-3 tokenizer
of --tokenizer_path; text CFG at --cfg_scale); where the JAX runner loads
too little to run (it calls None at the prompt), a missing file raises a
RuntimeError naming it. Checkpoints come from local files only:
--dit_path (DiffSynth or BFL layout; shards `|`-separated; sd / sdxl: the
civitai file), --vae_path (the encoder's and decoder's state dicts under
`encoder.` / `decoder.`), --clip_path (CLIP-L), --t5_path (T5 v1.1-XXL, HF
names; shards `|`-separated), --tokenizer_path (the CLIP tokenizer; sd /
sdxl without one take the JAX pipelines' stand-in ids) and
--tokenizer_2_path (the T5 tokenizer; the JAX runner passes none, and its
prompter then has no T5 tokenizer). --smoke runs a tiny random model
(flux: FLUX_DIT_TINY, CLIP-L and T5 v1.1 at tiny widths with stand-in
tokenizers, the FLUX VAE; sd3: SD3_DIT_TINY with a 4096-wide context,
CLIP-L and CLIP-G at tiny widths, no T5, the SD3 VAE; sd / sdxl: the tiny
UNets and CLIP towers, the SD VAE; qwen: QWEN_IMAGE_TINY, a tiny
Qwen2.5-VL text tower with a stand-in tokenizer, the Wan2.1 VAE, CFG 1;
hunyuan_image: HUNYUAN_DIT_TINY, a tiny BERT and mT5 with stand-in
tokenizers; omnigen: OMNIGEN_TINY with a stand-in tokenizer; both on the
SDXL VAE) at 64x64 for 2 steps. The VAE files of hunyuan_image and omnigen
hold the encoder's and decoder's state dicts under `encoder.` / `decoder.`.
Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse

SMOKE_SIZE = 64
SMOKE_STEPS = 2


def build_smoke_pipeline(device=None, seed: int = 0):
    """A FLUX pipeline of tiny random models (weights from `seed`), fp32."""
    import torch
    from .models.flux_dit import FLUX_DIT_TINY
    from .models.sd3_text_encoder import CLIP_L_TINY
    from .models.sd3_vae import FLUX_VAE
    from .models.t5 import T5_V11_TINY
    from .pipelines.flux_image import FluxImagePipeline
    from .prompters.flux_prompter import StubClipTokenizer, StubT5Tokenizer
    return FluxImagePipeline.from_configs(
        FLUX_DIT_TINY, CLIP_L_TINY, T5_V11_TINY, FLUX_VAE,
        StubClipTokenizer(CLIP_L_TINY.vocab), StubT5Tokenizer(T5_V11_TINY.vocab),
        seed=seed, device=device, dtype=torch.float32)


def run_flux(a):
    from .pipelines.flux_image import FluxImagePipeline
    if a.smoke:
        pipe = build_smoke_pipeline(device=a.device, seed=a.seed)
    else:
        pipe = FluxImagePipeline.from_pretrained(
            dit_path=a.dit_path.split("|"), vae_path=a.vae_path, clip_path=a.clip_path,
            t5_paths=a.t5_path.split("|") if a.t5_path else None,
            tokenizer_1_path=a.tokenizer_path, tokenizer_2_path=a.tokenizer_2_path,
            device=a.device)
    if a.lora_path:
        pipe.load_lora(a.lora_path, alpha=1.0)
    return pipe(a.prompt, embedded_guidance=3.5, num_inference_steps=a.steps,
                height=a.height, width=a.width, seed=a.seed)


def build_sd3_smoke_pipeline(device=None, seed: int = 0):
    """An SD3 pipeline of tiny random models (weights from `seed`), fp32:
    the prompter's 4096-wide context and pooled CLIP-L + CLIP-G width."""
    import dataclasses
    import torch
    from .models.sd3_dit import SD3_DIT_TINY
    from .models.sd3_text_encoder import CLIP_L_TINY
    from .models.sd3_vae import SD3_VAE
    from .models.sdxl import CLIP_G_TINY
    from .pipelines.sd3_image import SD3ImagePipeline
    from .prompters.flux_prompter import StubClipTokenizer
    dit = dataclasses.replace(SD3_DIT_TINY, context_dim=4096,
                              pooled_dim=CLIP_L_TINY.dim + CLIP_G_TINY.dim)
    return SD3ImagePipeline.from_configs(
        dit, CLIP_L_TINY, CLIP_G_TINY, None, SD3_VAE,
        (StubClipTokenizer(CLIP_L_TINY.vocab), StubClipTokenizer(CLIP_G_TINY.vocab), None),
        seed=seed, device=device, dtype=torch.float32)


def run_sd3(a):
    from .pipelines.sd3_image import SD3ImagePipeline
    if a.smoke:
        pipe = build_sd3_smoke_pipeline(device=a.device, seed=a.seed)
    else:
        pipe = SD3ImagePipeline.from_pretrained(dit_path=a.dit_path.split("|"),
                                                vae_path=a.vae_path, device=a.device)
    return pipe(a.prompt, negative_prompt=a.negative_prompt, cfg_scale=a.cfg_scale,
                num_inference_steps=a.steps, height=a.height, width=a.width, seed=a.seed)


def build_sd_smoke_pipeline(xl: bool, device=None, seed: int = 0):
    """An SD 1.5 (or, xl, SDXL) pipeline of tiny random models (weights
    from `seed`), fp32, with the JAX pipelines' stand-in ids."""
    import torch
    from .models import sd as SD
    from .models import sdxl as XL
    if xl:
        from .pipelines.sdxl_image import SDXLImagePipeline
        return SDXLImagePipeline.from_configs(XL.SDXL_UNET_TINY, XL.CLIP_L_TINY_12,
                                              XL.CLIP_G_TINY, seed=seed, device=device,
                                              dtype=torch.float32)
    from .pipelines.sd_image import SDImagePipeline
    return SDImagePipeline.from_configs(SD.SD_UNET_TINY, XL.CLIP_L_TINY_12, seed=seed,
                                        device=device, dtype=torch.float32)


def _run_sd_family(a, xl: bool):
    if a.smoke:
        pipe = build_sd_smoke_pipeline(xl, device=a.device, seed=a.seed)
    elif xl:
        from .pipelines.sdxl_image import SDXLImagePipeline
        pipe = SDXLImagePipeline.from_civitai_file(a.dit_path, tokenizer_path=a.tokenizer_path,
                                                   device=a.device)
    else:
        from .pipelines.sd_image import SDImagePipeline
        pipe = SDImagePipeline.from_civitai_file(a.dit_path, tokenizer_path=a.tokenizer_path,
                                                 device=a.device)
    return pipe(a.prompt, negative_prompt=a.negative_prompt, cfg_scale=a.cfg_scale,
                num_inference_steps=a.steps, height=a.height, width=a.width, seed=a.seed)


def run_sd(a):
    return _run_sd_family(a, xl=False)


def run_sdxl(a):
    return _run_sd_family(a, xl=True)


# the qwen smoke's text tower: DECODER_LM_TINY (heads of 16) under a
# multimodal RoPE split of its 8 frequencies
QWEN_SMOKE_MROPE = (2, 3, 3)


def build_qwen_smoke_pipeline(device=None, seed: int = 0):
    """A Qwen-Image pipeline of tiny random models (weights from `seed`),
    fp32: QWEN_IMAGE_TINY, DECODER_LM_TINY as the text tower (no vision
    tower) with `StubQwenTokenizer`, the Wan2.1 VAE at its release widths."""
    import torch
    from .models.llm_decoder import DECODER_LM_TINY
    from .models.qwen_image_dit import QWEN_IMAGE_TINY
    from .models.qwen_vl_embedder import QwenVL, StubQwenTokenizer
    from .pipelines.qwen_image import QwenImagePipeline
    vl = QwenVL.from_configs(DECODER_LM_TINY, None, StubQwenTokenizer(DECODER_LM_TINY.vocab_size),
                             seed=seed + 1, device=device, dtype=torch.float32,
                             mrope_section=QWEN_SMOKE_MROPE)
    return QwenImagePipeline.from_configs(QWEN_IMAGE_TINY, vl, seed=seed, device=device,
                                          dtype=torch.float32)


def run_qwen(a):
    from .pipelines.qwen_image import QwenImagePipeline
    if a.smoke:
        pipe, cfg_scale = build_qwen_smoke_pipeline(device=a.device, seed=a.seed), 1.0
    else:
        pipe, cfg_scale = QwenImagePipeline.from_pretrained(
            dit_paths=a.dit_path.split("|"), vae_path=a.vae_path, device=a.device), a.cfg_scale
        if a.text_encoder_path:
            if not a.tokenizer_path:
                raise RuntimeError("--text_encoder_path needs --tokenizer_path (the "
                                   "Qwen2.5-VL tokenizer)")
            pipe.fetch_text_encoder(a.text_encoder_path.split("|"), a.tokenizer_path)
    return pipe(a.prompt, negative_prompt=a.negative_prompt, cfg_scale=cfg_scale,
                num_inference_steps=a.steps, height=a.height, width=a.width, seed=a.seed)


# the hunyuan_image smoke's mT5: the tiny DiT's 32-wide T5 input
MT5_SMOKE = dict(vocab=128, dim=32, dim_attn=32, dim_ffn=64, num_heads=4, num_layers=2,
                 shared_pos=True)


def build_hunyuan_image_smoke_pipeline(device=None, seed: int = 0):
    """A HunyuanDiT pipeline of tiny random models (weights from `seed`),
    fp32: HUNYUAN_DIT_TINY, the tiny BERT and a 32-wide mT5 with stand-in
    tokenizers, the SDXL VAE at its release widths."""
    import torch
    from .models.hunyuan_image_dit import HUNYUAN_BERT_TINY, HUNYUAN_DIT_TINY
    from .models.t5 import T5Config
    from .pipelines.hunyuan_image import (HunyuanImagePipeline, StubBertTokenizer,
                                          StubMT5Tokenizer)
    t5 = T5Config(**MT5_SMOKE)
    return HunyuanImagePipeline.from_configs(
        HUNYUAN_DIT_TINY, HUNYUAN_BERT_TINY, t5, StubBertTokenizer(HUNYUAN_BERT_TINY.vocab),
        StubMT5Tokenizer(t5.vocab), seed=seed, device=device, dtype=torch.float32)


def run_hunyuan_image(a):
    """HunyuanDiT: the DiT, the SDXL VAE, the CLIP-BERT (--clip_path) and
    mT5-XL (--t5_path) with their tokenizers. The JAX runner loads the DiT
    and the VAE alone and its request calls None at the prompt; here a
    missing file raises first, naming it."""
    from .pipelines.hunyuan_image import HunyuanImagePipeline
    if a.smoke:
        pipe = build_hunyuan_image_smoke_pipeline(device=a.device, seed=a.seed)
    else:
        _require("hunyuan_image", {"--vae_path": a.vae_path, "--clip_path": a.clip_path,
                                   "--t5_path": a.t5_path, "--tokenizer_path": a.tokenizer_path,
                                   "--tokenizer_2_path": a.tokenizer_2_path},
                 "the DiT, the SDXL VAE, the CLIP-BERT and mT5-XL and their tokenizers")
        pipe = HunyuanImagePipeline.from_pretrained(
            dit_path=a.dit_path.split("|"), vae_path=a.vae_path, bert_path=a.clip_path,
            t5_paths=a.t5_path.split("|"), tokenizer_path=a.tokenizer_path,
            tokenizer_t5_path=a.tokenizer_2_path, device=a.device)
    return pipe(a.prompt, negative_prompt=a.negative_prompt, cfg_scale=a.cfg_scale,
                num_inference_steps=a.steps, height=a.height, width=a.width, seed=a.seed)


def build_omnigen_smoke_pipeline(device=None, seed: int = 0):
    """An OmniGen pipeline of tiny random models (weights from `seed`),
    fp32: OMNIGEN_TINY (no su factors: its heads are 8 wide) with the
    stand-in Phi-3 tokenizer, the SDXL VAE at its release widths."""
    import torch
    from .models.omnigen import OMNIGEN_TINY
    from .pipelines.omnigen_image import OmnigenImagePipeline
    from .prompters.omnigen_prompter import StubPhi3Tokenizer
    return OmnigenImagePipeline.from_configs(OMNIGEN_TINY, StubPhi3Tokenizer(
        OMNIGEN_TINY.vocab_size), seed=seed, device=device, dtype=torch.float32, su_factor=None)


def run_omnigen(a):
    """OmniGen: the transformer, the SDXL VAE and Phi-3's tokenizer
    (--tokenizer_path); the JAX runner loads no tokenizer and its prompter
    calls None. Text CFG at --cfg_scale."""
    from .pipelines.omnigen_image import OmnigenImagePipeline
    if a.smoke:
        pipe = build_omnigen_smoke_pipeline(device=a.device, seed=a.seed)
    else:
        _require("omnigen", {"--vae_path": a.vae_path, "--tokenizer_path": a.tokenizer_path},
                 "the transformer, the SDXL VAE and the Phi-3 tokenizer")
        pipe = OmnigenImagePipeline.from_pretrained(
            transformer_path=a.dit_path, vae_path=a.vae_path, tokenizer_path=a.tokenizer_path,
            device=a.device)
    return pipe(a.prompt, cfg_scale=a.cfg_scale, num_inference_steps=a.steps,
                height=a.height, width=a.width, seed=a.seed)


def _require(family: str, need: dict, what: str):
    missing = [flag for flag, v in need.items() if not v]
    if missing:
        raise RuntimeError(f"{family} needs {', '.join(missing)} ({what})")


RUNNERS = {"flux": run_flux, "sd3": run_sd3, "sd": run_sd, "sdxl": run_sdxl,
           "qwen": run_qwen, "hunyuan_image": run_hunyuan_image, "omnigen": run_omnigen}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", required=True, choices=sorted(RUNNERS))
    p.add_argument("--prompt", default="a lighthouse on a cliff at dawn")
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--cfg_scale", type=float,
                   help="sd3, sd, sdxl, qwen, hunyuan_image (default 7.5) and omnigen "
                        "(default 2)")
    p.add_argument("--dit_path")
    p.add_argument("--vae_path")
    p.add_argument("--clip_path")
    p.add_argument("--t5_path")
    p.add_argument("--lora_path")
    p.add_argument("--tokenizer_path")
    p.add_argument("--tokenizer_2_path")
    p.add_argument("--text_encoder_path",
                   help="qwen: the Qwen2.5-VL checkpoint (shards `|`-separated)")
    p.add_argument("--steps", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--width", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="out.png")
    p.add_argument("--smoke", action="store_true",
                   help="tiny random models at 64x64, 2 steps")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if not a.smoke and not a.dit_path:
        p.error("--dit_path is required (or use --smoke)")
    if a.cfg_scale is None:
        a.cfg_scale = 2.0 if a.family == "omnigen" else 7.5
    a.steps = a.steps or (SMOKE_STEPS if a.smoke else 30)
    a.height = a.height or (SMOKE_SIZE if a.smoke else 1024)
    a.width = a.width or (SMOKE_SIZE if a.smoke else 1024)
    return a


def main(argv=None):
    a = parse_args(argv)
    image = RUNNERS[a.family](a)
    image.save(a.output)
    print(f"saved {a.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
