"""Video generation with the PyTorch/CUDA port, by family.

    python -m video_styler_tpu_torch.video_gen --family sd_animatediff \\
        --prompt "a red fox" --dit_path v1-5-pruned-emaonly.safetensors \\
        --motion_path mm_sd_v15_v2.safetensors --tokenizer_path clip_tokenizer \\
        --num_frames 16 --height 512 --width 512 --output out.mp4
    python -m video_styler_tpu_torch.video_gen --family sd_animatediff --smoke --device cpu
    python -m video_styler_tpu_torch.video_gen --family hunyuan_video --prompt "a red fox" \\
        --dit_path hunyuan_video_t2v_720p_bf16.pt --vae_path hunyuan_video_vae_bf16.pt \\
        --clip_path clip_l.safetensors --clip_tokenizer_path clip_tokenizer \\
        --llm_path llava_llama3_8b --tokenizer_path llava_llama3_tokenizer
    python -m video_styler_tpu_torch.video_gen --family hunyuan_video --smoke --device cpu
    python -m video_styler_tpu_torch.video_gen --family step_video --smoke --device cpu
    python -m video_styler_tpu_torch.video_gen --family cog_video --smoke --device cpu
    python -m video_styler_tpu_torch.video_gen --family svd --smoke --device cpu
    python -m video_styler_tpu_torch.video_gen --family wan_t2v --prompt "a red fox" \\
        --dit_path wan_t2v_1.3b.safetensors --vae_path Wan2.1_VAE.pth \\
        --t5_path models_t5_umt5-xxl-enc-bf16.pth --tokenizer_path umt5_tokenizer

The counterpart of the JAX package's `examples/video_gen.py`:
`sd_animatediff` (`SDVideoPipeline`: the UNet, CLIP-L and VAE of a civitai
SD 1.5 file, the motion modules of --motion_path (kind `motion_modules`),
--cfg_scale two-pass CFG over windows of 16 frames, DDIM) and `wan_t2v`
(`WanVideoPipeline.from_pretrained` on the three files, tiled VAE). SD
video needs a CLIP tokenizer (--tokenizer_path), as the JAX pipeline does.
`hunyuan_video` (`HunyuanVideoPipeline`: the DiT, the VAE decoder, CLIP-L
and its tokenizer, the LLaMA tower of --llm_path and its tokenizer; 720x1280,
129 frames, CFG 1 at embedded guidance 6 by default; without one of them
it raises a RuntimeError naming it). --smoke runs sd_animatediff on tiny
random models (UNet, motion modules, CLIP-L) with the SD VAE and a
stand-in tokenizer, 8 frames at 64x64, 2 steps, or hunyuan_video on tiny
random models (DiT, VAE, CLIP-L, LLaMA) with stand-in tokenizers, 9
frames. `cog_video` (`CogVideoPipeline`: the DiT, the VAE decoder, T5
v1.1-XXL and its tokenizer; 480x720, 49 frames, CFG 7), `step_video`
(`StepVideoPipeline`: the DiT, the VAE, the bilingual CLIP and its
tokenizer, the Step-1 LLM and the StepChat sentencepiece model; 544x992,
204 frames, CFG 9) and `svd` (`SVDVideoPipeline`: the UNet, the VAE
encoder and decoder, the image encoder and --input_image; 576x1024, 25
frames); the JAX runner loads too little for any of the three to run, and
here a missing file raises a RuntimeError naming it. Their --smoke runs
tiny random models (5, 17 and 3 frames). The Ditto edit,
the other Wan recipes, the editor and the enhancer have their own CLIs
(`infer_ditto`, `wan_video_gen`, `step2_video_editing`, `enhance_video`);
the Diffutoon runner is `diffutoon`. Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import os

SMOKE_SIZE = 64
SMOKE_FRAMES = {"sd_animatediff": 8, "hunyuan_video": 9, "cog_video": 5, "step_video": 17,
                "svd": 3}
SMOKE_STEPS = 2


def _require(family: str, need: dict, what: str):
    missing = [flag for flag, v in need.items() if not v]
    if missing:
        raise RuntimeError(f"{family} needs {', '.join(missing)} ({what})")


def _shards(path):
    return path.split("|")


def build_sd_video_smoke_pipeline(device=None, seed: int = 0):
    """An SD 1.5 AnimateDiff pipeline of tiny random models (weights from
    `seed`), fp32, with a stand-in CLIP tokenizer."""
    import torch
    from .models import motion as M
    from .models import sd as SD
    from .models.sdxl import CLIP_L_TINY_12
    from .pipelines.sd_video import SDVideoPipeline
    from .prompters.flux_prompter import StubClipTokenizer
    base = SDVideoPipeline.from_configs(SD.SD_UNET_TINY, CLIP_L_TINY_12,
                                        StubClipTokenizer(CLIP_L_TINY_12.vocab), seed=seed,
                                        device=device, dtype=torch.float32)
    gen = torch.Generator(base.device).manual_seed(seed + 1)
    with torch.device("meta"):
        motion = M.sd_motion_model(SD.SD_UNET_TINY, dtype=torch.float32)
    base.motion_modules = SD.init_sd_module_(motion.to_empty(device=base.device), gen).eval()
    return base


def run_sd_animatediff(a):
    from .pipelines.sd_video import SDVideoPipeline
    from .utils.ckpt import load_model
    if a.smoke:
        pipe = build_sd_video_smoke_pipeline(device=a.device, seed=a.seed)
    else:
        pipe = SDVideoPipeline.from_civitai_file(a.dit_path, tokenizer_path=a.tokenizer_path,
                                                 device=a.device)
        kind, pipe.motion_modules = load_model(a.motion_path, device=a.device)
        if kind != "motion_modules":
            raise ValueError(f"--motion_path holds a {kind!r} model, not motion modules")
    return pipe(prompt=a.prompt, negative_prompt=a.negative_prompt, num_frames=a.num_frames,
                height=a.height, width=a.width, cfg_scale=a.cfg_scale,
                num_inference_steps=a.steps, seed=a.seed)


def run_wan_t2v(a):
    from .pipelines.wan_video import WanVideoPipeline
    from .utils.model_config import ModelConfig
    pipe = WanVideoPipeline.from_pretrained(
        model_configs=[ModelConfig(path=a.dit_path), ModelConfig(path=a.vae_path),
                       ModelConfig(path=a.t5_path)],
        tokenizer_path=a.tokenizer_path, device=a.device)
    return pipe(prompt=a.prompt, negative_prompt=a.negative_prompt, num_frames=a.num_frames,
                height=a.height, width=a.width, cfg_scale=a.cfg_scale,
                num_inference_steps=a.steps, seed=a.seed, tiled=True)


def build_hunyuan_video_smoke_pipeline(device=None, seed: int = 0):
    """A HunyuanVideo pipeline of tiny random models (weights from `seed`),
    fp32: `HUNYUAN_VIDEO_TINY`, a 16-channel VAE of width 8, CLIP-L's and
    a 4-layer LLaMA's tiny widths, with stand-in tokenizers."""
    import dataclasses
    import torch
    from .models.hunyuan_video_dit import HUNYUAN_VIDEO_TINY
    from .models.hunyuan_video_vae import HUNYUAN_VAE_TINY
    from .models.llm_decoder import DECODER_LM_TINY
    from .models.sd3_text_encoder import CLIP_L_TINY
    from .pipelines.hunyuan_video import HunyuanVideoPipeline, StubLlamaTokenizer
    from .prompters.flux_prompter import StubClipTokenizer
    llm = dataclasses.replace(DECODER_LM_TINY, num_layers=4, qkv_bias=False, rope_theta=500000.0)
    dit = dataclasses.replace(HUNYUAN_VIDEO_TINY, text_dim=llm.hidden, pooled_dim=CLIP_L_TINY.dim)
    vae = dataclasses.replace(HUNYUAN_VAE_TINY, z_dim=16)
    return HunyuanVideoPipeline.from_configs(dit, CLIP_L_TINY, llm, vae,
                                             StubClipTokenizer(CLIP_L_TINY.vocab),
                                             StubLlamaTokenizer(llm.vocab_size), seed=seed,
                                             device=device, dtype=torch.float32)


def run_hunyuan_video(a):
    """HunyuanVideo t2v: the DiT, the VAE decoder, CLIP-L and its tokenizer,
    the LLaMA tower and its tokenizer. The JAX runner loads the DiT alone
    and its request calls None at the prompt; here a missing file raises
    first, naming it."""
    from .pipelines.hunyuan_video import HunyuanVideoPipeline
    if a.smoke:
        pipe = build_hunyuan_video_smoke_pipeline(device=a.device, seed=a.seed)
    else:
        _require("hunyuan_video", {"--dit_path": a.dit_path, "--vae_path": a.vae_path,
                                   "--clip_path": a.clip_path,
                                   "--clip_tokenizer_path": a.clip_tokenizer_path,
                                   "--llm_path": a.llm_path},
                 "the DiT, the VAE decoder, CLIP-L and its tokenizer, the LLaMA text tower")
        pipe = HunyuanVideoPipeline.from_pretrained(
            dit_path=a.dit_path, vae_decoder_path=a.vae_path, clip_path=a.clip_path,
            clip_tokenizer_path=a.clip_tokenizer_path, device=a.device)
        shards = a.llm_path.split("|")
        pipe.fetch_llm(shards, a.tokenizer_path or os.path.dirname(os.path.abspath(shards[0])))
    return pipe(prompt=a.prompt, negative_prompt=a.negative_prompt, num_frames=a.num_frames,
                height=a.height, width=a.width, cfg_scale=a.cfg_scale,
                num_inference_steps=a.steps, seed=a.seed)


def build_cog_video_smoke_pipeline(device=None, seed: int = 0):
    """A CogVideoX pipeline of tiny random models (weights from `seed`),
    fp32: COG_DIT_TINY, a tiny T5 v1.1 with a stand-in tokenizer, the VAE at
    its release widths."""
    import torch
    from .models.cog_video import COG_DIT_TINY
    from .models.t5 import T5_V11_TINY, T5Encoder, init_t5_
    from .pipelines.cog_video import CogVideoPipeline
    from .prompters.flux_prompter import StubT5Tokenizer
    pipe = CogVideoPipeline.from_configs(COG_DIT_TINY, seed=seed, device=device,
                                         dtype=torch.float32)
    with torch.device("meta"):
        t5 = T5Encoder(T5_V11_TINY, dtype=torch.float32)
    gen = torch.Generator(pipe.device).manual_seed(seed + 1)
    t5 = init_t5_(t5.to_empty(device=pipe.device), gen).eval()
    return pipe.fetch_text_encoder(t5, StubT5Tokenizer(T5_V11_TINY.vocab))


def run_cog_video(a):
    """CogVideoX: the DiT, the VAE decoder, T5 v1.1-XXL and its tokenizer.
    The JAX runner loads the DiT alone: no VAE and no text encoder, so its
    request calls None; here a missing file raises first, naming it."""
    from .pipelines.cog_video import CogVideoPipeline
    if a.smoke:
        pipe = build_cog_video_smoke_pipeline(device=a.device, seed=a.seed)
    else:
        _require("cog_video", {"--vae_path": a.vae_path, "--t5_path": a.t5_path,
                               "--tokenizer_path": a.tokenizer_path},
                 "the DiT, the VAE decoder, T5 v1.1-XXL and its tokenizer")
        pipe = CogVideoPipeline.from_pretrained(dit_paths=_shards(a.dit_path),
                                                vae_decoder_path=a.vae_path, device=a.device)
        pipe.fetch_text_encoder(_shards(a.t5_path), a.tokenizer_path)
    return pipe(prompt=a.prompt, negative_prompt=a.negative_prompt, cfg_scale=a.cfg_scale,
                num_inference_steps=a.steps, num_frames=a.num_frames, height=a.height,
                width=a.width, seed=a.seed)


def build_step_video_smoke_pipeline(device=None, seed: int = 0):
    """A StepVideo pipeline of tiny random models (weights from `seed`),
    fp32: STEP_VIDEO_TINY on a 96-wide Step-1 LLM and the tiny BERT with
    stand-in tokenizers, the VAE at its release widths and latent channels,
    one resnet a level."""
    import dataclasses
    import torch
    from .models import stepvideo_llm as L
    from .models.hunyuan_image_dit import (HUNYUAN_BERT_TINY, HunyuanBert,
                                           init_hunyuan_image_dit_)
    from .models.stepvideo_dit import STEP_VIDEO_TINY
    from .models.stepvideo_vae import STEP_VAE_TINY
    from .pipelines.hunyuan_image import StubBertTokenizer
    from .pipelines.step_video import StepVideoPipeline
    llm_cfg = dataclasses.replace(L.STEP1_LLM_TINY, hidden_size=STEP_VIDEO_TINY.caption_dim)
    dit = dataclasses.replace(STEP_VIDEO_TINY, clip_dim=HUNYUAN_BERT_TINY.dim)
    vae = dataclasses.replace(STEP_VAE_TINY, z_channels=dit.in_channels)
    pipe = StepVideoPipeline.from_configs(dit, vae, seed=seed, device=device,
                                          dtype=torch.float32)
    gen = torch.Generator(pipe.device).manual_seed(seed + 2)
    with torch.device("meta"):
        llm = L.Step1LLM(llm_cfg, dtype=torch.float32)
        bert = HunyuanBert(HUNYUAN_BERT_TINY, dtype=torch.float32)
    llm = L.init_step1_llm_(llm.to_empty(device=pipe.device), gen).eval()
    bert = init_hunyuan_image_dit_(bert.to_empty(device=pipe.device), gen).eval()
    return pipe.fetch_text_encoders(bert, StubBertTokenizer(HUNYUAN_BERT_TINY.vocab), llm,
                                    L.stub_stepchat_tokenize(llm_cfg.vocab_size))


def run_step_video(a):
    """StepVideo: the DiT, the VAE, the bilingual CLIP (--clip_path) and
    its tokenizer (--clip_tokenizer_path), the Step-1 LLM (--llm_path) and
    the StepChat sentencepiece model (--tokenizer_path). The JAX runner
    never calls `fetch_text_encoders` and its request calls None; here a
    missing file raises first, naming it."""
    from .pipelines.step_video import StepVideoPipeline
    if a.smoke:
        pipe = build_step_video_smoke_pipeline(device=a.device, seed=a.seed)
    else:
        _require("step_video", {"--vae_path": a.vae_path, "--clip_path": a.clip_path,
                                "--clip_tokenizer_path": a.clip_tokenizer_path,
                                "--llm_path": a.llm_path, "--tokenizer_path": a.tokenizer_path},
                 "the DiT, the VAE, the bilingual CLIP and the Step-1 LLM and their "
                 "tokenizers")
        pipe = StepVideoPipeline.from_pretrained(dit_paths=_shards(a.dit_path),
                                                 vae_path=a.vae_path, device=a.device)
        pipe.fetch_text_encoders(a.clip_path, a.clip_tokenizer_path, _shards(a.llm_path),
                                 a.tokenizer_path)
    return pipe(prompt=a.prompt, negative_prompt=a.negative_prompt, cfg_scale=a.cfg_scale,
                num_inference_steps=a.steps, num_frames=a.num_frames, height=a.height,
                width=a.width, seed=a.seed)


def build_svd_smoke_pipeline(device=None, seed: int = 0):
    """An SVD pipeline of tiny random models (weights from `seed`), fp32:
    SVD_UNET_TINY, the tiny CLIP-H image tower, the VAE at its release
    widths."""
    import torch
    from .models import svd as S
    from .pipelines.svd_video import SVDVideoPipeline
    return SVDVideoPipeline.from_configs(S.SVD_UNET_TINY, S.SVD_IMAGE_ENCODER_TINY_224,
                                         seed=seed, device=device, dtype=torch.float32)


def run_svd(a):
    """SVD image-to-video: the UNet (--dit_path), the VAE encoder and
    decoder (--vae_encoder_path, --vae_path), the image encoder
    (--image_encoder_path) and --input_image. The JAX runner loads the
    UNet alone; here a missing file raises first, naming it."""
    from .pipelines.svd_video import SVDVideoPipeline
    if a.smoke:
        pipe = build_svd_smoke_pipeline(device=a.device, seed=a.seed)
        image = _smoke_image(a.height, a.width, a.seed)
    else:
        _require("svd", {"--vae_path": a.vae_path, "--vae_encoder_path": a.vae_encoder_path,
                         "--image_encoder_path": a.image_encoder_path,
                         "--input_image": a.input_image},
                 "the UNet, the VAE encoder and decoder, the image encoder and the image")
        pipe = SVDVideoPipeline.from_pretrained(
            unet_path=a.dit_path, vae_encoder_path=a.vae_encoder_path,
            vae_decoder_path=a.vae_path, image_encoder_path=a.image_encoder_path,
            device=a.device)
        from PIL import Image
        image = Image.open(a.input_image).convert("RGB")
    return pipe(input_image=image, num_frames=a.num_frames, height=a.height, width=a.width,
                num_inference_steps=a.steps, seed=a.seed)


def _smoke_image(height: int, width: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (height, width, 3), dtype=np.uint8)


RUNNERS = {"sd_animatediff": run_sd_animatediff, "wan_t2v": run_wan_t2v,
           "hunyuan_video": run_hunyuan_video, "cog_video": run_cog_video,
           "step_video": run_step_video, "svd": run_svd}
# the published request of each family the defaults follow:
# (frames, height, width, cfg_scale)
DEFAULTS = {"hunyuan_video": (129, 720, 1280, 1.0), "cog_video": (49, 480, 720, 7.0),
            "step_video": (204, 544, 992, 9.0), "svd": (25, 576, 1024, None)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", required=True, choices=sorted(RUNNERS))
    p.add_argument("--prompt", default="a red fox running through snow")
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--dit_path")
    p.add_argument("--vae_path")
    p.add_argument("--t5_path")
    p.add_argument("--motion_path")
    p.add_argument("--clip_path", help="hunyuan_video: CLIP-L; step_video: the bilingual "
                                       "CLIP-BERT")
    p.add_argument("--vae_encoder_path", help="svd: the VAE encoder (--vae_path: its decoder)")
    p.add_argument("--image_encoder_path", help="svd: the CLIP-H image encoder")
    p.add_argument("--input_image", help="svd: the first frame")
    p.add_argument("--llm_path", help="hunyuan_video: the LLaMA text tower; step_video: the "
                                      "Step-1 LLM (a file, or shards separated by '|')")
    p.add_argument("--tokenizer_path", help="the CLIP tokenizer (sd_animatediff), umT5's "
                                            "(wan_t2v), T5's (cog_video), LLaMA's "
                                            "(hunyuan_video; default: the folder of "
                                            "--llm_path), the StepChat sentencepiece model "
                                            "(step_video)")
    p.add_argument("--clip_tokenizer_path", help="hunyuan_video: the CLIP tokenizer; "
                                                 "step_video: the BERT tokenizer")
    p.add_argument("--cfg_scale", type=float)
    p.add_argument("--steps", type=int)
    p.add_argument("--num_frames", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--width", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="out.mp4")
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--smoke", action="store_true",
                   help="the family on tiny random models at 64x64, 2 steps "
                        "(SMOKE_FRAMES frames)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if not a.smoke and not a.dit_path:
        p.error("--dit_path is required (or use --smoke)")
    if a.smoke and a.family not in SMOKE_FRAMES:
        p.error(f"--smoke runs the {' and '.join(SMOKE_FRAMES)} families")
    frames, height, width, cfg = DEFAULTS.get(a.family, (81, 480, 832, 5.0))
    a.steps = a.steps or (SMOKE_STEPS if a.smoke else 30)
    a.num_frames = a.num_frames or (SMOKE_FRAMES[a.family] if a.smoke else frames)
    a.height = a.height or (SMOKE_SIZE if a.smoke else height)
    a.width = a.width or (SMOKE_SIZE if a.smoke else width)
    # HunyuanVideo's default is CFG 1 (embedded guidance 6); SVD's CFG runs
    # from 1 to 3 across the frames
    a.cfg_scale = a.cfg_scale if a.cfg_scale is not None else cfg
    return a


def main(argv=None):
    a = parse_args(argv)
    frames = RUNNERS[a.family](a)
    from .data.video import save_video
    save_video(frames, a.output, fps=a.fps)
    print(f"saved {a.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
