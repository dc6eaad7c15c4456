#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (video_styler_tpu_torch) on one GPU.

    python3 chip_smoke.py                          # all phases, one card
    python3 chip_smoke.py --frames 73 --steps 1    # the full Ditto clip size
    python3 chip_smoke.py --train-frames 41        # fp32 LoRA steps at 17,160 tokens

Phases, each printing one JSON line (any failure raises and exits non-zero):
  device     nvidia-smi name and power limit, torch/CUDA versions, the
             kernel build time (every csrc/*.cu, one nvcc each, in parallel),
             each kernel's registers and spills (-Xptxas=-v)
  kernel     K1 (flash attention, self and cross), K4 (RMSNorm+RoPE) and K5
             (RMSNorm), then K1 with its stats output and K3 (the flash
             backward: dq, dk and dv in one kernel, and its dq-only twin)
             through the autograd Function that training uses, then K2 and K8 (online softmax, single and
             dual, self and cross; K2 also with stats, on its 3-D entry,
             under a q x24 stress and feeding K3), K6 (int8 Q K^T, capped and online;
             beside the bf16 kernel of the same body on the same inputs) and
             K7 (its 3-D twin), the float32 instantiations K1f (with and
             without stats), K3f, K3q-f, K4f and K5f (the Ditto recipe's fp32
             activations; within 2^-17 / 2^-20 of the plain versions, and
             each of them and the plain versions against the float64
             function on the heads checked), held
             against their plain PyTorch versions
             on the card
             at the Ditto shapes of a 73-frame 480x832 edit (29,640 tokens)
             and of this run's requests (--frames and --train-frames,
             default 9: 4,680 tokens), and K1 cross to 257 and 769 keys
             (I2V's image branch, FLF2V's text branch) at this run's and
             the I2V recipe's 81-frame (32,760) query rows, K1/K4/K5 at
             TI2V-5B's 24 heads (Dm 3072) over 5,070 tokens, K1/K4/K5 at
             S2V's 448x832 shapes (self over 5,824 and 30,576 tokens with
             the segment RoPE rows, the text cross at 5,824 rows, the audio
             cross of 3 and 20 batch rows of 1,456 queries against 5 keys
             with K5 on those rows), and FastBlend's F1-F3 (remap, patch
             error, pairwise patch error; fp32) at the post-processing
             path's top pyramid level (8 pairs of 480x832, pad 6, patch 13
             and 5, a coherent field):
             max abs/rel error against the stated tolerance, median kernel
             time over CUDA-event timed runs (L2 flushed before each), plain
             and library times, the bound from the work and the card's
             data-sheet rates, the time over the library call's; the
             attention kernels and K5 also their registers and spills from
             the build log
  reference  the smoke-size pipeline on the card against the same weights
             on the CPU (plain versions), latents and decoded frames
  reference_quant  the same after quantize(): int8 linears with int8
             attention, then fp8, int4 and group-wise int4 linears, the card
             against the CPU on the same quantised weights
  train_reference  2 LoRA steps of the smoke-size model on the card and on
             the CPU from the same weights, LoRA, inputs, tid and noise:
             losses, gradients and updated LoRA
  e2e        one VACE edit at Wan2.1-VACE-14B width (40 DiT + 8 VACE blocks,
             umT5-XXL, Wan2.1 VAE; random bf16 weights from a seed) of a
             480x832 clip: stage times, peak memory, output shape, and each
             kernel's launch count in this run; then the same request again
             under torch.profiler for device time by kernel category
  load       that pipeline written in the layout of the Wan2.1-VACE-14B
             release (DiT+VACE as 7 bf16 safetensors shards under the
             reference's names, umT5 and the VAE as .pth) to --ckpt-dir,
             freed, and built again by `from_pretrained` on the card:
             detected kinds and configs, seconds, GB read, GB/s, the host's
             peak RSS and the device's peak; every tensor bit-equal to what
             was written (per-tensor checksums on the card); the e2e request
             again (`load_edit`, counted): frames identical to e2e's; then a
             random rank-128 Ditto-style LoRA hotloaded on the VACE branch,
             its scale set to 0 and unloaded (weights bit-equal to the base
             each time) and the time of one re-apply. Every later phase runs
             on the loaded pipeline; the files are removed at the end
  train      2 steps of the Ditto LoRA recipe (rank 128 on the VACE q, k, v,
             o, ffn.0, ffn.2; AdamW) on the loaded 14B-width pipeline, on the
             --train-frames request (default 9: 4,680 tokens), at the
             recipe's fp32 activations on the bf16 weights (K1f, K3f, K3q-f,
             K4f, K5f; no bf16 kernel), through the
             training CLI's data path (video_styler_tpu_torch/train.py): its
             `preprocess` with umT5 parked on the host between encodes,
             `launch_data_process_task` writing the clip's encodes,
             `CachedLatentDataset` reading them back (bit-equal to the
             in-memory ones, the same loss on both), umT5 and the VAE parked
             for the cache-fed steps; seconds per cached sample and the
             encodes' peak memory, losses, step times, peak memory, LoRA size, each
             kernel's launches against the count derived from the
             configuration; then one more step under torch.profiler
  e2e_online one step of the same edit on the online-softmax route
             (FLASH_CAPPED=0: K2), then one with FLASH_DUAL=1 (K8)
  train_precision  one LoRA loss and gradient on the train clip at the
             recipe's fp32 activations through the float32 kernels and
             through the plain versions: loss within 1e-5 relative, LoRA
             gradients within 1e-3 relative L2; each run's peak memory (an
             OOM fails the phase; `--only train` reports the plain run's)
  editor_reference  the smoke-size keyframe-guided editor (9 frames of
             32x32, keyframes at frames 0 and 8, CFG 5 two-pass, 2 steps) on
             the card against the same weights on the CPU
  enhance_reference  the smoke-size Wan2.2 enhancer with two distinct tiny
             experts on a window crossing the expert boundary (8 steps of
             shift 5, the last 6: 2 high-noise, 4 low-noise), card vs CPU
  editor     the keyframe-guided editor on the loaded pipeline's DiT: the
             --frames clip with keyframes at its first and last frame (and
             the middle one from 73 frames on), --steps steps, CFG 5
             two-pass, alpha 10: the joint [main | keyframes] token count,
             stage and step times, peak memory, compute_metrics, K1/K4/K5
             launches against 2/1/1 per block and CFG pass; the request
             again under torch.profiler; then K1, K4 and K5 held against
             their plain versions at the joint sequence's length with its
             RoPE ids
  enhance    the Wan2.2 enhancer at A14B width: the loaded DiT as the
             low-noise expert, a second WAN_T2V_14B DiT from a seed as the
             high-noise expert (both resident; umT5 and VACE parked on the
             host), the --frames clip, the boundary-crossing window, guide
             scales (3, 4): each step's expert and seconds, peak memory,
             launches (above --frames 9, running out of memory is reported,
             not raised); the request again under torch.profiler
  i2v_reference  the FLF2V smoke recipe of `wan_video_gen` (a tiny
             257-token CLIP tower, y, a first and an end image) on the card
             against the same weights on the CPU
  ti2v_reference  the TI2V smoke recipe (the first frame's latent fused
             into the noise, a tiny Wan2.2-family VAE), card vs CPU
  fun_reference  the Fun V1.1 Control (a control video and a reference
             image), V1.1 Control-Camera and speed-control smoke recipes
             of `wan_video_gen`, card vs CPU
  animate_reference  the Wan2.2-Animate smoke recipe (a tiny adapter at
             face size 64, pose and face videos cut from the clip), card
             vs CPU
  postprocess_reference  the post-processing chain (FastBlend balanced,
             RIFE 2x at full IFNet width, ESRGAN x4 with 2 blocks, the six
             image-quality metrics at their tiny configs) on 4 frames of
             64x64, card vs CPU on the same weights, stage by stage, and
             the share of NNF entries that differ
  streaming_reference  the smoke VACE pipeline after
             enable_block_streaming("int8", resident_blocks=1) (one trunk
             block resident, the other and both VACE blocks through the
             copy stream and the slot ring), card vs CPU; then the card's
             serial walk (overlap=False), bit-equal to its overlapped one
  streaming_train_reference  the smoke DiT and VACE streamed from an int8
             store (one trunk block resident): one streamed VACE-LoRA
             gradient (trainers/streaming_train.py) in "device" mode
             (2-item segments) and in "host" mode, card vs CPU: loss,
             gradients, and K1/K3/K3q/K4/K5 launches on the card against
             the derived counts
  image_lora_reference  one LoRA step of each image family's tiny model
             (train_lora.smoke_pack: FLUX and Qwen-Image at heads of 128,
             remat on the card; SD3; in bf16 and again in fp32, as
             `train_lora --smoke` runs them; the real tiny SD UNet in fp32),
             card vs CPU on the same weights, LoRA, tid and noise: loss and
             gradients, and K1/K3 (K1f/K3f) launches against the derived
             counts
  transformers_backends  the two `transformers` backends (Qwen2.5-VL for
             Qwen-Image, LLaMA for HunyuanVideo) on tiny models built from
             configs and written by `save_pretrained`, against the native
             paths on the same files, fp32, on the card: the library's
             version, the key names written, relative L2
  s2v_reference  the Wan2.2-S2V smoke recipe (a tiny S2V model and
             wav2vec2 tower, a synthetic waveform through
             `extract_audio_features` on each device, 12 frames with a pose
             video, CFG 4.5), card vs CPU: audio features and latents
  e2e_quant  the trained LoRA merged, then quantize("int8",
             quantize_attention=True) and the same edit again: int8 GEMMs
             and K6 for every attention; profiled like e2e; then one step
             with FLASH_CAPPED=0 (K6's online body)
  entry_3d   the (BH, S, D) entry points driven as a caller would:
             flash_attention_3d without and with grad (K2, K2 + K3) and
             flash_attention_int8_3d (K7)
  i2v        Wan2.1-I2V-14B-480P at full width in the VACE pipeline's
             place (its DiT and VACE freed; umT5-XXL and the Wan2.1 VAE
             kept): a random WAN_I2V_14B DiT and CLIP ViT-H/14 tower, the
             --frames clip's first frame as the image, --steps steps, CFG 5
             two-pass: stage times (clip_encode, vae_encode_image, steps,
             decode), peak memory, K1/K4/K5 launches against 3/1/1 per
             block and pass; profiled; then an FLF2V request (a 514-row
             position table, the clip's last frame as the end image) and a
             2-step dual-expert request (a second I2V expert below
             switch_DiT_boundary, umT5 and CLIP parked on the host)
  fun        Wan2.1-Fun-14B on the I2V phase's trunk, before its dual
             expert: InP (the trunk as it is, the first and last frames),
             V1.1 Control (a random 48-channel patch embedding and
             `ref_conv`: the clip as the control video, its first frame as
             the reference image, one more leading latent frame: 6,240
             tokens at 9 frames) and V1.1 Control-Camera (a random
             SimpleAdapter 24 -> 5120, the camera moving left, the I2V y):
             stage and step times, peak memory, tokens, K1/K4/K5 launches
             against 3/1/1 per block and pass
  animate    Wan2.2-Animate-14B on the same trunk: a random adapter (the
             pose embedding 16 -> 5120, 8 face blocks of 40 heads, the face
             and motion encoders at face size 512), the clip's frames 1..
             as the pose video, 5 face crops of 512x512: the adapter's
             stage (pose tokens, motion and face encoders once) and one
             face block timed apart, step times, peak, launches (3/1/1; the
             face blocks' 5-key attention is the plain `sdpa`)
  speed      Wan2.1-T2V-1.3B at full width (30 blocks of 1536, 12 heads)
             with a random speed controller (its last layer random, not
             zero), the loaded umT5 and VAE, --frames, --steps, CFG 5
             two-pass: step times, peak, launches (2/1/1); two motion ids
             give different latents
  ti2v       Wan2.2-TI2V-5B at full width: a random WAN_TI2V_5B DiT and
             Wan2.2 VAE, 49 frames of 480x832 (5,070 tokens), --steps
             steps, CFG 5 two-pass, streaming encode and decode: stage and
             step times, peak memory, launches (2/1/1 per block and pass),
             the first latent frame bit-equal to the image's encode
  s2v        Wan2.2-S2V-14B at full width: a random WAN_S2V_14B (the
             40-block trunk, 12 audio injectors and their AdaLN, the audio
             encoder, the frame packer, cond_encoder) and XLSR-53 tower
             beside the loaded umT5 and VAE; 5 s of synthetic audio through
             the tower; 12 frames of 448x832 (5,824 tokens), --steps steps,
             CFG 4.5 two-pass: the tower's and the audio encoder's times,
             stage and step times, peak, launches against 184/80/104 per
             two-pass step; profiled; then one step at the recipe's 80
             frames (30,576 tokens), latents only (`s2v_recipe_frames`)
  postprocess  on a free card, the chain at full width on 9 frames of
             480x832: FastBlend balanced with its defaults (F1/F2 launches
             against the count derived from the config, the host time of
             its random-search draws, the frame-to-frame change before and
             after), RIFE 2x (9 -> 17 frames), ESRGAN x4 (23 blocks) to
             1920x3328 on all 17, the six metrics at full width (random
             towers, stub token ids): each stage's seconds and peak; one
             FastBlend batch profiled (`postprocess_profile`); one pyramid
             estimate with use_pairwise_patch_error, counted for F3
             (`postprocess_pairwise`)
  streaming  on a free card, the e2e edit's models at full width again
             (random bf16 WAN_T2V_14B + VACE_14B from seed 0, umT5-XXL
             parked on the host between encodes, the Wan2.1 VAE),
             quantize("int8") without int8 attention, the --frames
             request resident (--steps steps, CFG 5 two-pass, latents);
             then enable_block_streaming("int8", 13.5 GB, depth 3) on the
             same int8 weights: the plan (resident blocks, resident GB,
             streamed GB a pass), the host store's build and pin seconds,
             its pinned bytes and the host's counters around it, the
             host-to-device rate from pinned memory alone, GB streamed a
             step, step seconds overlapped and
             resident and (1 step) serial, the denoise loop's peak (reset
             at its first forward) against the budget plus the VAE (umT5's
             bytes printed apart: on the host during the loop), latents
             against the resident int8 run, K1/K4/K5 launches (384/192/192
             at 2 steps), one forward each way on the same inputs
             bit-equal, then each traced (torch.profiler): the copies'
             device time and the share of it spent under a kernel
  streaming_train  on that int8 store, the Ditto recipe's VACE LoRA (rank
             128, fp32) through the streamed trainer: one step in "host"
             mode and one in "device" mode (k = 7; then an AdamW update),
             sub_remat on: step seconds, the loop's peak against the budget
             plus what lies outside it, GB the ring copied, the two modes'
             gradients against each other, K1/K3/K3q/K4/K5 launches against
             the derived counts
  workflow_smokes  `run_comfyui_workflow --smoke` (a graph of the
             reference workflow's node types: fp8 model (int8 here),
             block swap (every block streamed), UniPC, cfg 1.2, VACE
             0.975, SLG) and `video_editing_with_agent --smoke` (the step1
             agent with the mock image provider on a synthetic clip, then
             the editor) on the card: seconds, frames, launches, the
             workflow's streaming plan and blocks copied
  flux_kernels  (with the kernel rows) K1 at the FLUX DiT's joint
             self-attention: 24 heads of 128 over [512 text | image] tokens
             at 1024x1024 (4,608) and 512x512 (1,536)
  flux_reference  a small FLUX pipeline (head dim 128: dim 256, 2 heads, 2 +
             2 blocks; tiny CLIP-L and T5 v1.1, the release-width VAE) at
             256x256, 2 steps, CFG 1 and CFG 2 two-pass, card vs CPU on the
             same weights; the fp32 decode of the same latents on both
  flux       on a free card, FLUX.1-dev at full width and depth (dim 3072,
             24 heads, 19 + 38 blocks, T5 v1.1-XXL, CLIP-L, the FLUX VAE;
             random bf16 weights from seed 0, the VAE fp32): one 1024x1024
             request (4,608 tokens), --steps steps at the recipe's embedded
             guidance 3.5 and CFG 1, then the decode: weights, stage times
             (clip_encode, t5_encode, each step, vae_decode), peak memory,
             K1 launches against 57 a step; one DiT step profiled by
             category (`flux_profile`: K1, GEMM, elementwise, other); the
             recipe's 30-step request composed from the stages and the
             fastest step (`flux_image`)
  flux_lora_kernels  (with the kernel rows) K1 with its stats output and K3
             at the FLUX LoRA step's attention, 24 heads of 128 over 4,608
             tokens, against their plain versions, SDPA's forward and
             backward beside them; their launches are `flux_lora`'s
  card       the card's name and power limit again (nvidia-smi), ahead of
             the adapters' and SD3's phases
  flux_adapter_kernels  (with the kernel rows) K1 at the FLUX adapters'
             shapes, 24 heads of 128: the IP-Adapter cross from 4,096 and
             4,608 query rows to 128 and 256 keys, and every
             self-attention length the adapters' requests give it (the
             union ControlNet's and the LoRA encoder's 4,609,
             InfiniteYou's 4,105, the value encoder's 4,612, Kontext's
             8,704)
  flux_adapters_reference  each FLUX adapter (union ControlNet, also
             under two-pass CFG; IP-Adapter; EliGen; InfiniteYou; a value
             encoder; the LoRA encoder; Flex) on the small FLUX of
             `flux_reference`, 256x256, 2 steps, card vs CPU
  sd3_reference  a small SD3 (a dual block, RMS q/k norm, tiny CLIP-L and
             CLIP-G) at 256x256, 2 steps, CFG 4 two-pass, t2i and a local
             prompt, card vs CPU
  flux_adapters  on the resident FLUX.1-dev after `flux`, at 1024x1024,
             --steps steps, each adapter at its published width with
             random weights from a seed (the union ControlNet, 5 + 10
             blocks, CFG 1 and two-pass; InfiniteYou on its branch; the
             IP-Adapter, 57 k/v pairs of 128 tokens, a seeded SigLIP
             stand-in; EliGen with two entity masks; a value encoder; the
             LoRA encoder on a rank-16 LoRA; Flex), then img2img, Kontext,
             TeaCache, 512x512, schnell's path and a merged LoRA: step
             seconds, peak, K1 launches against the count from the code
             (`flux_adapters_summary`: adapter GiB, launches by case)
  flux_lora  on the resident FLUX.1-dev after `flux_adapters`: the JAX
             family recipe's LoRA (rank 4 on every linear, fp32, Adam) at
             1024x1024, bf16, remat, --steps steps of
             trainers/image_training.py: step seconds, peak, losses, K1 /
             K3 / K3q launches against 2 x 57 / 57 / 0 a step
  sd3        SD3.5-Large at full width and depth (dim 2432, 38 heads of
             64, 38 layers) with CLIP-G drawn from a seed and FLUX's
             CLIP-L, T5 v1.1-XXL and VAE modules, 1024x1024, CFG 7.5
             two-pass, --steps steps: stage times, peak, no K1 launch;
             one step profiled by category and one exact `sdpa` call
             timed (`sd3_profile`); the 20-step request composed
             (`sd3_image`)
  sd_reference, sdxl_reference, sd_video_reference  the tiny SD 1.5 (t2i,
             a local prompt), SDXL (t2i; Kolors on a tiny ChatGLM) and
             AnimateDiff (6 frames, two overlapping windows) pipelines on
             the card against the same fp32 weights on the CPU, 128x128, 2
             steps, CFG 5 two-pass, latents within 5%
  sd         SD 1.5 at its published widths (the 860 M UNet, FLUX's CLIP-L
             tower, the SD VAE drawn), 512x512, CFG 7.5 two-pass, DDIM,
             --steps steps: stage and step seconds, peak, K1/K4/K5 launches
             (0: the exact `sdpa` is the route, as in JAX); one step by
             category with one `sdpa` call timed (`sd_profile`); the
             20-step request (`sd_image`); a canny ControlNet and the
             IP-Adapter through CLIP-H (`sd_adapters`)
  sd_video   AnimateDiff (21 motion modules) on `sd`'s modules: 16 frames of
             512x512, one window, decoded; one window step profiled
             (`sd_video_profile`); 24 frames, two windows blended
             (`sd_video_long`); the Diffutoon runner on a JSON config, 8
             frames, the tile ControlNet (`diffutoon`)
  sdxl       SDXL base (2.57 B UNet, CLIP-L; `sd3`'s CLIP-G, `sd`'s VAE),
             1024x1024, CFG 7.5 two-pass, --steps steps, a profiled step
             (`sdxl_profile`), 20 steps composed (`sdxl_image`), the union
             ControlNet (`sdxl_controlnet`), the IP-Adapter's 70 sites from
             image embeds (`sdxl_ipadapter`)
  sdxl_video SDXL AnimateDiff (15 motion modules), 16 frames of 1024x1024,
             one window, decoded; a window step profiled
             (`sdxl_video_profile`); again under InstantStyle
             (`sdxl_video_ipadapter`, latents)
  kolors     ChatGLM3-6B and the Kolors UNet, 1024x1024, --steps steps
  qwen_kernels  (with the kernel rows) K1 at the Qwen-Image DiT's joint
             attention, 24 heads of 128 over every [text | image] length the
             qwen, qwen_edit and qwen_adapters requests give it, positive and
             negative prompt (6,918 and 6,896 at 1328x1328; 4,125 and 4,103
             at 1024x1024; the edit's 9,434 and 9,430), held against its
             plain version (two bf16 ULPs)
  qwen_reference  a small Qwen-Image (head dim 128, 2 blocks; Qwen2.5-VL
             towers of 2 and 4 layers; the Wan2.1 VAE) on the card (K1)
             against the same weights on the CPU: 256x256, 2 steps, t2i at
             CFG 1 and 4, an edit, EliGen and the block-wise ControlNet;
             latents within 5%, the decode within 2 levels, K1's launches
             against blocks x passes x steps
  qwen       on a free card: the 20.4 B Qwen-Image DiT, Qwen2.5-VL-7B (text
             and vision towers) and the Wan2.1 VAE, random weights from a
             seed, 1328x1328, CFG 4 two-pass, --steps steps and the decode:
             stages, peak, K1 launches against 60 a pass; a two-pass step
             profiled (`qwen_profile`); the 30-step image composed
             (`qwen_image_composed`); then on the resident model
             `qwen_edit` (a 1024x1024 edit image through the vision tower
             and as an extra latent) and `qwen_adapters` (EliGen: K1 on the
             negative pass only; a 60-block block-wise ControlNet; inpaint;
             img2img), 1024x1024
  step1x_nexus_kernels  (with the kernel rows) K1 at FLUX's joint attention,
             24 heads of 128, over the step1x_nexus requests' lengths at
             1024x1024: Step1x's 8,832 (640 embedder rows, the image, the
             reference on the Kontext tokens), Nexus-Gen's generation 4,177
             (81 predicted embeddings) and edit 5,402 (and the reference's
             1,225 vision tokens), held against its plain version
  step1x_nexus_reference  the small FLUX of flux_reference with the small
             Qwen2.5-VL towers of qwen_reference, a Step1x connector, a
             Nexus-Gen adapter, merger and AR head of their widths, card (K1)
             against CPU: 256x256, 2 steps, CFG 1, a Step1x edit, a Nexus-Gen
             generation and edit, latents within 5%, K1 4 blocks a step
  step1x_nexus  FLUX.1-dev at full width (T5 v1.1-XXL, CLIP-L, the FLUX VAE)
             beside the qwen phase's Qwen2.5-VL-7B towers, the Step1x
             connector and the Nexus-Gen adapter, merger and AR model's
             vision head and prefill embeds at full width, random weights
             from a seed: a Step1x edit, a Nexus-Gen generation and edit,
             1024x1024, CFG 1, --steps steps each: stages, step seconds,
             peak, K1 launches against 57 a step
  hunyuan_kernels  (with the kernel rows) K1 at the HunyuanVideo DiT's two
             attentions a block, 24 heads of 128: [image | 71 text rows]
             at 720x1280x9 (10,871) and the 185-row text tail, then the
             published 720x1280x129 length (118,871: 2 heads held against
             the plain version on every row, all 24 timed)
  hunyuan_reference  a small HunyuanVideo (head dim 128, 2 + 2 blocks, a
             4-layer LLaMA, tiny CLIP-L, a 16-channel VAE) on the card (K1)
             against the same weights on the CPU: 128x128, 9 frames, 2
             steps, t2v at CFG 1 and 2, v2v (tiled encode) and i2v; latents
             within 5%, the tiled decode within 2 levels, K1 launches
  hunyuan    on a free card: the 12.8 B HunyuanVideo DiT, LLaMA-3-8B's text
             tower, CLIP-L and the fp32 causal VAE, random weights from a
             seed, 720x1280, 9 frames (10,800 image tokens), CFG 1 at
             embedded guidance 6, --steps steps and the tiled decode: stage
             times (llm_encode, clip_encode, each step, vae_decode), peak,
             K1 launches against 120 a step; one step profiled by category
             (`hunyuan_profile`)
  step_video_kernels  (with the kernel rows) K1 at the StepVideo DiT's
             self-attention, 48 heads of 128: 544x992x17 (6,324 tokens),
             then the published 204 frames (75,888: 2 heads held against
             the plain version on every row, all 48 timed)
  step_video_reference  a small StepVideo (heads of 128, 2 blocks, a
             2-layer Step-1 LLM and BERT) on the card (K1) against the CPU:
             64x64x17, 2 steps at CFG 1 and 9; latents within 5%, K1
             launches against one a block, pass and step
  step_video on a free card: the Step-1 LLM (48 layers of 6144) and the
             CLIP-BERT encode and go, then the 30 B DiT (48 blocks of 6144)
             at 544x992x17, CFG 9 two-pass, --steps steps, then goes before
             the fp32 VAE decode: stage times, peaks, K1 launches against
             96 a step; one DiT forward profiled (`step_video_profile`)
  cog_video_reference, hunyuan_image_reference, svd_reference,
  omnigen_reference  each family's tiny pipeline on the card against the
             CPU (bf16): latents within 5%, K1 never launched (the exact
             `sdpa`, as in JAX)
  cog_video  CogVideoX-5B (42 blocks of 3072, 48 heads of 64), T5
             v1.1-XXL and the VAE: 480x720x13 (5,626 tokens), CFG 7, --steps
             steps, the chunked decode; one DiT forward profiled
  hunyuan_image  HunyuanDiT (1.5 B), the CLIP-BERT, mT5-XL and the SDXL
             VAE: 1024x1024, CFG 7.5, --steps steps and the decode
  svd        SVD's 1.5 B UNet, CLIP-H and the temporal VAE: 576x1024x14,
             the CFG ramp, --steps steps and the decode
  omnigen    OmniGen (Phi-3, 32 layers of 3072) and the SDXL VAE:
             1024x1024, text CFG 2, --steps steps and the decode (each of
             the last four with one forward profiled, `<family>_profile`)
  usp_kernels  (with the kernel rows) one rank's work of the multi-GPU path
             at Wan2.1-14B width over the Ditto clip's 29,640 tokens, in
             this process: K1 on a Ulysses share (20 and 10 heads over the
             whole sequence), K1 cross, K4 and K5 on one rank's 7,410 rows
             with its cos/sin rows, and the ring's per-rank body (7,410
             queries against 4 key blocks of 7,410 through K1 with stats and
             the fp32 merge, held against K1's plain version over the whole
             key sequence within four bf16 ULPs), as kernel rows
  usp        last, on a free card: ranks spawned by `parallel.run_local` on
             cuda:0 over gloo (NCCL refuses two ranks on one device). (a)
             Wan2.1-T2V-1.3B at full width cut to 10 of its 30 blocks on
             the mesh (1, 2, 2) (FSDP and Ulysses over 4 ranks; --frames,
             --steps, CFG 5 two-pass); (b) the e2e edit at
             Wan2.1-VACE-14B width cut to 8 of its 40 DiT blocks (the VACE
             layers 0 and 5) on (1, 2, 1), FSDP over 2 ranks, one step,
             each rank drawing only its shards, umT5 parked on the host
             between encodes; per rank:
             latents against the same weights in one process (5%), peak
             memory, DiT+VACE shard GiB, K1/K4/K5 launches against the
             one-process count, step times (a card shared by the ranks, not
             a multi-card speed); (e) in (b)'s ranks after its request, the
             sharded pipeline quantised to int8 with int8 attention (each
             rank quantising its own rows) and the request again: latents
             against the same in one process (5%), the int8 DiT+VACE GiB a
             rank against the whole, K6 launches against the derived count;
             (d) on the mesh (1, 1, 2), two ranks: Wan2.2-Animate-14B on the
             I2V trunk cut to 2 blocks (its face block after block 0) on the
             `animate` phase's --frames 480x832 request, and
             Wan2.2-S2V-14B cut to 2 blocks (its audio injector after block
             0) on the `s2v` phase's 12-frame 448x832 request, one step
             each, the VAE stages split on the frame width; per rank the
             latents and decoded frames against one process (5%), the VAE
             stages' peaks against one process's, K1/K4/K5 launches against
             the derived count; (c) `infer_ditto --smoke --mesh 1,1,1` on
             a one-rank NCCL group: frames and latents bit-equal to the run
             without a mesh
Then the `kernels` summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import math
import os
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# no phase fetches anything: a weight or tokenizer that is not on disk
# raises instead of reaching for the network (`utils.model_config`)
os.environ.setdefault("VIDEO_STYLER_OFFLINE", "1")

# H100 SXM data-sheet peaks (dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores (FastBlend's F1-F3)
# an fp32-accurate product on the tensor cores: TF32's 495 TFLOP/s over the
# three passes (hi*hi + hi*lo + lo*hi) of K1f and K3f
PEAK_TF32X3_FLOPS = 495e12 / 3

# DiT token grids (latent frames, H/16, W/16) after the (1, 2, 2) patchify
DITTO_FRAMES = 73            # 73 frames 480x832 -> 29,640 tokens
RUN_FRAMES = 9               # 9 frames 480x832 -> 4,680 tokens
I2V_RECIPE_FRAMES = 81       # Wan2.1 I2V's 81 frames 480x832 -> 32,760 tokens
TI2V_FRAMES = 49             # Wan2.2 TI2V-5B's 49 frames 480x832 (16x VAE) ->
TI2V_GRID = (13, 15, 26)     # 13 x 15 x 26 = 5,070 tokens
TEXT_LEN = 512
CLIP_ROWS = 257              # the image branch's keys; FLF2V's text branch
FLF2V_TEXT_ROWS = 512 + 257  # takes the end image's 257 rows: 769 keys


def token_grid(frames: int):
    """DiT token grid of a 480x832 clip: (latent frames, H/16, W/16)."""
    return ((frames - 1) // 4 + 1, 30, 52)


START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also carries the script's seconds so far
    (`script_s`), from which each phase's share of the time limit reads."""
    if "phase" in obj:
        obj = {**obj, "script_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# a timed run at least this long is not repeated (time_ms, time_sdpa_bwd)
LONG_RUN_MS = 250.0


def time_ms(torch, fn, reps: int, warmup: int = 2):
    """Median CUDA-event time of fn, with L2 flushed before each run. After
    the flush the card spins for ~100 us before the start event, while the
    host enqueues fn's launches, so the time is the device's: a wrapper's
    host time per launch (17 us for K5's, 14 us for F.rms_norm's on the
    H100's host) would otherwise land inside a kernel of tens of us.

    The first timed run of LONG_RUN_MS or more is the time: the plain
    versions at 29,640 tokens and the float32 kernels there take 0.3-2.4 s
    a call, and their repeats would cost the script's time limit tens of
    seconds. The warm-up runs are never the time: a library's first call
    at a new shape took 0.7-1.0 s more than its next on the H100 (SDPA's,
    in a run that timed them). A warm-up of LONG_RUN_MS or more is the
    last one."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if (time.perf_counter() - t0) * 1e3 >= LONG_RUN_MS:
            break
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        if times[-1] >= LONG_RUN_MS:
            break
    return statistics.median(times)


# two bf16 ULPs at the output's largest magnitude: the kernels and their
# plain versions round at the same points; exp2/rsqrt and the order of fp32
# sums differ in the last bits, which can move one bf16 rounding by one ULP
TOL_ULPS = 2.0 ** -7


def synthetic_clip(f: int, h: int = 480, w: int = 832):
    """A smooth synthetic uint8 clip (f, h, w, 3)."""
    import numpy as np
    tt = np.linspace(0.0, 1.0, f, dtype=np.float32)[:, None, None, None]
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[None, :, None, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, None, :, None]
    cc = np.array([0.2, 0.5, 0.8], np.float32)[None, None, None, :]
    return (255 * (0.5 + 0.5 * np.sin(6.28 * (xx + yy * cc + tt * 0.3)))
            ).astype(np.uint8)


def gpu_clocks() -> str:
    """SM clock, its maximum, power draw and temperature, as nvidia-smi
    reads them now (the card slows down under a power or heat limit)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()


def max_err(torch, got, want):
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, scale


def ptxas_usage(build_dir):
    """Registers and spill bytes of every kernel, from the -Xptxas=-v lines
    of the build logs: {function name: {"registers": n, "spill_stores": b,
    "spill_loads": b}}. Kernels that raise their register limit with
    setmaxnreg report the launch-bound count here."""
    import re
    usage, current = {}, None
    for log in sorted(build_dir.glob("*.log")):
        for ln in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                current = m.group(1)
                usage[current] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and current:
                usage[current].update(spill_stores=int(m.group(1)),
                                      spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and current:
                usage[current]["registers"] = int(m.group(1))
    return usage


PTXAS = {}  # filled by main() from the build logs
CARD = {}   # the card's name and power limit (nvidia-smi), filled by main()


def kernel_usage(*names):
    """The ptxas usage of the kernels whose mangled names contain `names`."""
    return {fn: u for fn, u in PTXAS.items() if any(n in fn for n in names)}


def check_kernels(torch, grid, tag, rope_ids=None, heads: int = 40,
                  cross_lens=(TEXT_LEN,), self_attn: bool = True, norms: bool = True,
                  rope_tables=None):
    """K1 self and cross (to each of `cross_lens` keys), K4 and K5 at `heads`
    heads of 128 (the Ditto 14B width by default) on this token grid
    (rope_ids: the temporal RoPE index of each latent frame, as the editor
    gives its joint sequence; rope_tables: numpy (cos, sin) rows for the
    grid's tokens in their place, as S2V's segments give them).
    self_attn/norms: whether to hold K1 self and K4/K5 too."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr
    from video_styler_tpu_torch.ops.rope import assemble_freqs_grid

    f, h, w = grid
    s, n, d = f * h * w, heads, 128
    dm = n * d
    gen = torch.Generator("cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    rows = []
    tol_ulps = TOL_ULPS

    # K1: self (Sk = S) and cross (Sk = 512 text tokens; 257 CLIP rows and
    # FLF2V's 769-row text branch on the I2V path)
    q = randn(1, s, n, d)
    for kind, sk in ([("self", s)] if self_attn else []) + [("cross", c) for c in cross_lens]:
        k = randn(1, sk, n, d)
        v = randn(1, sk, n, d)
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        sub = torch.cat([torch.arange(0, min(1024, s)),
                         torch.arange(max(0, s - 1024), s)]).unique().cuda()
        want = fa.flash_attention_plain(q[:, sub], k, v)
        err, scale = max_err(torch, out[:, sub], want)
        tol = tol_ulps * scale
        flops = 4.0 * n * s * sk * d
        nbytes = 2.0 * (2 * s * dm + 2 * sk * dm)
        b_ms, b_by = bound(flops, nbytes)
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v), reps=10)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v),
                           reps=3, warmup=1)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt),
                         reps=10)
        rows.append(dict(
            name=f"K1 flash_attention {kind} S={s} Sk={sk} N={n} D={d} [{tag}]",
            kernel="K1", route="cuda",
            source="video_styler_tpu_torch/csrc/flash_attention.cu",
            replaces="video_styler_tpu/ops/flash_attention.py:213",
            max_abs_err=err, max_rel_err=err / scale, tol=tol,
            checked_rows=int(sub.numel()),
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, ratio_to_library=ms / lib_ms, tflops=flops / ms / 1e9,
            ptxas=kernel_usage("flash_fwd_capped_kernel"), clocks=gpu_clocks()))
        del k, v, out, want
    if not norms:
        return emit_rows(rows)

    # K4: RMSNorm + RoPE on q and k in one launch
    if rope_tables is None:
        cos, sin = assemble_freqs_grid(d, f, h, w, rope_ids, device="cuda")
    else:
        cos, sin = (torch.from_numpy(t).cuda() for t in rope_tables)
    xq, xk = randn(1, s, dm), randn(1, s, dm) * 0.7
    wq = (1.0 + 0.1 * randn(dm).float()).to(torch.bfloat16)
    wk = (1.0 + 0.1 * randn(dm).float()).to(torch.bfloat16)
    oq, ok = fnr.fused_rmsnorm_rope(xq, xk, wq, wk, cos, sin)
    pq, pk = fnr.fused_rmsnorm_rope_plain(xq, xk, wq, wk, cos, sin)
    eq, sq_ = max_err(torch, oq, pq)
    ek, sk_ = max_err(torch, ok, pk)
    err, scale = max(eq, ek), max(sq_, sk_)
    tol = tol_ulps * scale
    nbytes = 2.0 * 4 * s * dm + 4.0 * 2 * s * d // 2 + 2.0 * 2 * dm
    b_ms, b_by = bound(0.0, nbytes)
    rows.append(dict(
        name=f"K4 fused_rmsnorm_rope S={s} Dm={dm} [{tag}]", kernel="K4",
        route="cuda", source="video_styler_tpu_torch/csrc/fused_norm_rope.cu",
        replaces="video_styler_tpu/ops/fused_norm_rope.py:51",
        max_abs_err=err, max_rel_err=err / scale, tol=tol,
        ms=time_ms(torch, lambda: fnr.fused_rmsnorm_rope(xq, xk, wq, wk, cos, sin), 10),
        plain_ms=time_ms(torch, lambda: fnr.fused_rmsnorm_rope_plain(
            xq, xk, wq, wk, cos, sin), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # K5: RMSNorm of the cross-attention q
    o5 = fnr.fused_rmsnorm(xq, wq)
    err, scale = max_err(torch, o5, fnr.fused_rmsnorm_plain(xq, wq))
    b_ms, b_by = bound(0.0, 2.0 * 2 * s * dm + 2.0 * dm)
    rows.append(dict(
        name=f"K5 fused_rmsnorm S={s} Dm={dm} [{tag}]", kernel="K5",
        route="cuda", source="video_styler_tpu_torch/csrc/fused_norm_rope.cu",
        replaces="video_styler_tpu/ops/fused_norm_rope.py:154",
        max_abs_err=err, max_rel_err=err / scale, tol=tol_ulps * scale,
        ms=time_ms(torch, lambda: fnr.fused_rmsnorm(xq, wq), 10),
        plain_ms=time_ms(torch, lambda: fnr.fused_rmsnorm_plain(xq, wq), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: F.rms_norm(xq, (dm,), wq, 1e-6), 10),
        ptxas=kernel_usage("rmsnorm_kernel"), clocks=gpu_clocks()))
    rows[-1]["ratio_to_library"] = rows[-1]["ms"] / rows[-1]["library_ms"]
    return emit_rows(rows)


def emit_rows(rows):
    """Print each kernel row; raise on the first outside its tolerance."""
    for r in rows:
        emit({"phase": "kernel", **r, **CARD})
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{r['name']}: max abs err {r['max_abs_err']} "
                                 f"> tolerance {r['tol']}")
    return rows


S2V_GRID = (28, 52)         # 448x832 after the 8x VAE and the (1, 2, 2) patchify
S2V_RUN_FRAMES = 12         # 3 latent frames + the reference: 5,824 tokens
S2V_RECIPE_FRAMES = 80      # 20 latent frames + the reference: 30,576 tokens
AUDIO_KEYS = 5              # 4 audio tokens a frame and the padding token


def s2v_grid(frames: int):
    """S2V's token grid at 448x832: the latent frames and the reference's."""
    return ((frames - 1) // 4 + 2,) + S2V_GRID


def s2v_rope_tables(frames: int):
    from video_styler_tpu_torch.models.wan_s2v import s2v_rope_segments, video_segments
    f, (h, w) = (frames - 1) // 4 + 1, S2V_GRID
    return s2v_rope_segments(128, video_segments(f, h, w, h, w))


def check_audio_cross_kernels(torch, frames, tag, heads: int = 40):
    """S2V's audio injection: K5 on the (frames, 1,456, 5120) query rows,
    then K1 with a batch row per latent frame, 1,456 queries against that
    frame's 5 audio keys (one key tile: 5 real keys, 123 of TMA zero-fill)."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr
    b, s, n, d = frames, math.prod(S2V_GRID), heads, 128
    dm, sk = n * d, AUDIO_KEYS
    gen = torch.Generator("cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    xq = randn(b, s, dm)
    wq = (1.0 + 0.1 * randn(dm).float()).to(torch.bfloat16)
    q = fnr.fused_rmsnorm(xq, wq)
    err, scale = max_err(torch, q, fnr.fused_rmsnorm_plain(xq, wq))
    b_ms, b_by = bound(0.0, 2.0 * 2 * b * s * dm + 2.0 * dm)
    rows = [dict(
        name=f"K5 fused_rmsnorm audio-q B={b} S={s} Dm={dm} [{tag}]", kernel="K5",
        route="cuda", source="video_styler_tpu_torch/csrc/fused_norm_rope.cu",
        replaces="video_styler_tpu/ops/fused_norm_rope.py:154",
        max_abs_err=err, max_rel_err=err / scale, tol=TOL_ULPS * scale,
        ms=time_ms(torch, lambda: fnr.fused_rmsnorm(xq, wq), 10),
        plain_ms=time_ms(torch, lambda: fnr.fused_rmsnorm_plain(xq, wq), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: F.rms_norm(xq, (dm,), wq, 1e-6), 10),
        clocks=gpu_clocks())]
    rows[-1]["ratio_to_library"] = rows[-1]["ms"] / rows[-1]["library_ms"]
    q = q.view(b, s, n, d)
    k, v = randn(b, sk, n, d), randn(b, sk, n, d)
    out = fa.flash_attention(q, k, v)
    err, scale = max_err(torch, out, fa.flash_attention_plain(q, k, v))
    flops = 4.0 * b * n * s * sk * d
    b_ms, b_by = bound(flops, 2.0 * (2 * b * s * dm + 2 * b * sk * dm))
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v), reps=10)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=10)
    rows.append(dict(
        name=f"K1 flash_attention audio-cross B={b} S={s} Sk={sk} N={n} D={d} [{tag}]",
        kernel="K1", route="cuda", source="video_styler_tpu_torch/csrc/flash_attention.cu",
        replaces="video_styler_tpu/ops/flash_attention.py:213",
        max_abs_err=err, max_rel_err=err / scale, tol=TOL_ULPS * scale,
        checked_rows=b * s, ms=ms,
        plain_ms=time_ms(torch, lambda: fa.flash_attention_plain(q, k, v), reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, ratio_to_library=ms / lib_ms,
        tflops=flops / ms / 1e9, clocks=gpu_clocks()))
    return emit_rows(rows)


def card_copy(torch, cpu, cls):
    """A `cls` pipeline on the card holding copies of the CPU pipeline's
    models (the same weights)."""
    from video_styler_tpu_torch.prompters.wan_prompter import WanPrompter
    gpu = cls(device="cuda")
    for name in ("dit", "dit2", "vace", "vae", "image_encoder", "animate",
                 "motion_controller", "s2v_model"):
        m = getattr(cpu, name)
        setattr(gpu, name, None if m is None else copy.deepcopy(m).to("cuda"))
    p = cpu.prompter
    gpu.prompter = WanPrompter(p.tokenizer, p.text_len,
                               copy.deepcopy(p.text_encoder).to("cuda"))
    return gpu


def check_reference(torch):
    """Smoke-size pipeline: card (kernels) vs CPU (plain), same weights."""
    import numpy as np
    from video_styler_tpu_torch.infer_ditto import build_smoke_pipeline, smoke_frames
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    cpu = build_smoke_pipeline(device="cpu", seed=0)
    gpu = card_copy(torch, cpu, WanVideoPipeline)
    kw = dict(prompt="a watercolor city at dusk", vace_video=smoke_frames(9, 32, 32),
              num_frames=9, height=32, width=32, seed=42, cfg_scale=5.0,
              num_inference_steps=2, tiled=True)
    lat_c = cpu(return_latents=True, **kw).float()
    lat_g = gpu(return_latents=True, **kw).float().cpu()
    rel = ((lat_g - lat_c).norm() / lat_c.norm()).item()
    vid_c = cpu.vae_output_to_video(cpu.decode_video(lat_c.to(torch.bfloat16)))
    vid_g = gpu.vae_output_to_video(gpu.decode_video(lat_c.to(torch.bfloat16).cuda()))
    frame_diff = float(np.abs(vid_g.astype(np.int16) - vid_c.astype(np.int16)).max())
    # tolerance: bf16 DiT (cuBLAS vs CPU GEMMs, kernels vs plain) over 2 steps
    # x 2 CFG passes; the fp32 VAE decode of the same latents agrees to 1 level
    res = dict(phase="reference", latents_rel_l2=rel, latents_tol=5e-2,
               frames_max_abs_diff=frame_diff, frames_tol=2.0)
    emit(res)
    if not (rel <= 5e-2 and frame_diff <= 2.0):
        raise AssertionError(f"card vs CPU disagree: {res}")


def check_reference_quant(torch):
    """The smoke-size pipeline quantised on the CPU, then the same quantised
    weights on the card: int8 linears with int8 attention (K6), then fp8,
    int4 and group-wise int4 linears alone. The group is 32 here: the smoke
    VACE patch embedding has 288 inputs, which 128 does not divide.

    Two checks per mode. One quantised linear (the first block's fc1) on the
    same input on both devices: the library GEMM multiplies the same
    integers (or e4m3 values), so it holds to the kernels' two bf16 ULPs.
    Then the pipeline's latents, card against CPU, within 5% as `reference`,
    or within 1.5x the mode's own quantisation noise (the CPU's quantised
    latents against its unquantised ones) where that is larger: a coarse
    activation grid (e4m3 keeps 3 mantissa bits, steps of 6-12%) turns a
    bf16-ULP difference between the devices into a flip to a neighbouring
    value, so two runs of such a mode differ by about its own noise."""
    from video_styler_tpu_torch.infer_ditto import build_smoke_pipeline, smoke_frames
    from video_styler_tpu_torch.ops.attention import set_quantized_attention
    from video_styler_tpu_torch.ops.quant import QuantLinear, quantized_fraction

    kw = dict(prompt="a watercolor city at dusk", vace_video=smoke_frames(9, 32, 32),
              num_frames=9, height=32, width=32, seed=42, cfg_scale=5.0,
              num_inference_steps=2, tiled=True, return_latents=True)
    lat_ref = build_smoke_pipeline(device="cpu", seed=0)(**kw).float()
    x = torch.randn((1, 12, 256), generator=torch.Generator().manual_seed(7)
                    ).to(torch.bfloat16)
    res = dict(phase="reference_quant", latents_rel_l2={}, latents_tol={},
               quantisation_noise_rel_l2={}, linear_max_abs_err={}, linear_tol={},
               quantized_fraction={})
    for mode, attn in (("int8", True), ("fp8", False), ("int4", False), ("int4_g32", False)):
        cpu = build_smoke_pipeline(device="cpu", seed=0)
        try:
            cpu.quantize(mode, quantize_attention=attn)
            gpu = copy.copy(cpu)
            gpu.device = torch.device("cuda")
            gpu.dit, gpu.vace, gpu.vae = (copy.deepcopy(m).to("cuda")
                                          for m in (cpu.dit, cpu.vace, cpu.vae))
            gpu.prompter = copy.copy(cpu.prompter)
            gpu.prompter.text_encoder = copy.deepcopy(cpu.prompter.text_encoder).to("cuda")
            lat_c = cpu(**kw).float()
            lat_g = gpu(**kw).float().cpu()
        finally:
            set_quantized_attention(False)
        name = mode + (" + int8 attention" if attn else "")
        layer_c, layer_g = cpu.dit.blocks[0].ffn.fc1, gpu.dit.blocks[0].ffn.fc1
        if not (isinstance(layer_g, QuantLinear) and layer_g.mode == mode):
            raise AssertionError(f"{name}: fc1 is {layer_g}")
        with torch.no_grad():
            err, scale = max_err(torch, layer_g(x.cuda()).cpu(), layer_c(x))
        noise = ((lat_c - lat_ref).norm() / lat_ref.norm()).item()
        res["linear_max_abs_err"][name] = err
        res["linear_tol"][name] = TOL_ULPS * scale
        res["quantisation_noise_rel_l2"][name] = noise
        res["latents_rel_l2"][name] = ((lat_g - lat_c).norm() / lat_c.norm()).item()
        res["latents_tol"][name] = max(5e-2, 1.5 * noise)
        res["quantized_fraction"][name] = quantized_fraction(gpu.dit)
    emit(res)
    bad = [k for k in res["latents_rel_l2"]
           if not (res["latents_rel_l2"][k] <= res["latents_tol"][k]
                   and res["linear_max_abs_err"][k] <= res["linear_tol"][k])]
    if bad:
        raise AssertionError(f"quantised pipeline, card vs CPU: {bad}")


def build_pipeline(torch):
    """The 14B-width pipeline (random bf16 weights from seed 0) and the
    seconds it took to make."""
    from video_styler_tpu_torch.models.t5 import UMT5_XXL
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_14B
    from video_styler_tpu_torch.models.wan_vace import VACE_14B
    from video_styler_tpu_torch.models.wan_vae import WAN21_VAE
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer

    t0 = time.perf_counter()
    pipe = WanVideoPipeline.from_configs(WAN_T2V_14B, VACE_14B, UMT5_XXL, WAN21_VAE,
                                         StubTokenizer(TEXT_LEN), TEXT_LEN,
                                         seed=0, device="cuda")
    torch.cuda.synchronize()
    return pipe, time.perf_counter() - t0


def check_launches(launches, expected, phase):
    """Each kernel's launches in a run against the derived count (0 for a
    kernel the run must not reach)."""
    for name, count in launches.items():
        if count != expected.get(name, 0) or (name in expected and count == 0):
            raise AssertionError(f"{name}: {count} launches in the {phase} run, "
                                 f"expected {expected.get(name, 0)}")


def edit_request(frames: int, steps: int) -> dict:
    """The e2e phase's VACE edit of a 480x832 clip."""
    return dict(prompt="turn the scene into a watercolor painting",
                negative_prompt="", vace_video=synthetic_clip(frames), num_frames=frames,
                height=480, width=832, seed=42, cfg_scale=5.0,
                num_inference_steps=steps, tiled=True)


def run_edit(torch, pipe, kernels, steps: int, frames: int, phase: str,
             attention_kernels: dict, profile: bool = True, outputs=None, **extra):
    """One VACE edit of a 480x832 clip on `pipe`, with every launch count set
    to 0 just before and read just after. `attention_kernels` names the
    kernel(s) that the run's attention calls must go through and their share
    of them (two attention calls per block and forward); K4 and K5 run once
    per block and forward; every other kernel must stay at 0. `outputs`
    (a list) receives the frames of each run of the request."""
    import numpy as np
    dit_cfg, vace_cfg = pipe.dit.cfg, pipe.vace.cfg
    f, h, w = frames, 480, 832
    request = edit_request(frames, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    out = pipe(**request)
    total_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}

    n_layers = dit_cfg.num_layers + len(vace_cfg.vace_layers)
    forwards = 2 * steps
    expected = {"K4": n_layers * forwards, "K5": n_layers * forwards}
    expected.update({name: int(share * 2 * n_layers * forwards)
                     for name, share in attention_kernels.items()})
    res = dict(phase=phase, dit_layers=dit_cfg.num_layers,
               vace_layers=list(vace_cfg.vace_layers), frames=f,
               tokens=int(np.prod(token_grid(f))),
               steps=steps, cfg="two-pass 5.0", total_s=total_s,
               stages=dict(pipe.stage_times),
               stage_peak_gib={k: v / 2**30 for k, v in pipe.stage_peak_bytes},
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               output_shape=list(out.shape), output_dtype=str(out.dtype),
               # the pipeline raises on a non-finite decoded value
               # (WanVideoPipeline.vae_output_to_video)
               decoded_video_finite=True,
               launches=launches, expected_launches=expected, **extra)
    emit(res)
    if out.shape != (f, h, w, 3):
        raise AssertionError(f"output shape {out.shape}")
    check_launches(launches, expected, phase)
    if outputs is not None:
        outputs.append(out)
    if profile:
        def again():
            frames_again = pipe(**request)
            if outputs is not None:
                outputs.append(frames_again)
        emit({"phase": f"{phase}_profile", **profile_request(torch, again, total_s)})
    return launches


def run_e2e_online(torch, pipe, kernels, frames: int):
    """One step of the edit on the online-softmax route, then one with the
    dual kernel, switched the way a user switches them: the environment."""
    launches = {}
    for phase, env, name in (("e2e_online", {"FLASH_CAPPED": "0"}, "K2"),
                             ("e2e_online_dual", {"FLASH_DUAL": "1"}, "K8")):
        os.environ.update(env)
        try:
            launches[name] = run_edit(torch, pipe, kernels, 1, frames, phase, {name: 1.0},
                                      profile=False, environment=env)[name]
        finally:
            for key in env:
                del os.environ[key]
    return launches


def run_e2e_quant(torch, pipe, kernels, steps: int, frames: int):
    """The edit after quantize("int8", quantize_attention=True). The LoRA of
    the train phase is merged first (quantize must run after LoRA merging),
    and umT5 and the VAE, parked on the host for training, come back."""
    from torch.nn.utils import parametrize
    from video_styler_tpu_torch.ops.attention import set_quantized_attention
    from video_styler_tpu_torch.ops.quant import QuantLinear, quantized_fraction

    for m in pipe.vace.modules():
        if parametrize.is_parametrized(m, "weight"):
            with torch.no_grad():
                parametrize.remove_parametrizations(m, "weight", leave_parametrized=True)
    pipe.prompter.text_encoder.to("cuda")
    pipe.vae.to("cuda")
    t0 = time.perf_counter()
    pipe.quantize("int8", quantize_attention=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    quantize_s = time.perf_counter() - t0
    try:
        return run_edit(
            torch, pipe, kernels, steps, frames, "e2e_quant", {"K6": 1.0},
            quantize="int8 linears + int8 attention", quantize_s=quantize_s,
            quantized_fraction=dict(dit=quantized_fraction(pipe.dit),
                                    vace=quantized_fraction(pipe.vace)),
            quant_linears=sum(isinstance(m, QuantLinear) for m in
                              list(pipe.dit.modules()) + list(pipe.vace.modules())),
            weights_gib=sum(t.numel() * t.element_size() for m in (pipe.dit, pipe.vace)
                            for t in list(m.parameters()) + list(m.buffers())) / 2**30)
    finally:
        set_quantized_attention(False)


# ---------------------------------------------------------------- load phase

def checksums(torch, modules: dict) -> dict:
    """{"<module>.<tensor>": [s1, s2]} of every tensor of `modules`, taken on
    the card over the tensor's bytes as 16-bit words w: s1 = sum(w), s2 =
    sum(w * (position % 65521 + 1)), in int64 (no overflow below 2^31
    words). Two tensors with the same sums hold the same bits unless a
    change cancels in both."""
    names, sums = [], []
    chunk = 1 << 24
    for mname, module in modules.items():
        for key, t in module.state_dict().items():
            words = t.detach().contiguous().reshape(-1).view(torch.int16)
            s1 = torch.zeros((), dtype=torch.int64, device=t.device)
            s2 = torch.zeros((), dtype=torch.int64, device=t.device)
            for begin in range(0, words.numel(), chunk):
                w = words[begin:begin + chunk].to(torch.int64) & 0xFFFF
                pos = torch.arange(begin, begin + w.numel(), device=t.device)
                s1 += w.sum()
                s2 += (w * (pos % 65521 + 1)).sum()
            names.append(f"{mname}.{key}")
            sums.append(torch.stack([s1, s2]))
    return dict(zip(names, torch.stack(sums).tolist()))


def pipeline_modules(pipe) -> dict:
    return {"dit": pipe.dit, "vace": pipe.vace, "t5": pipe.prompter.text_encoder,
            "vae": pipe.vae}


def random_ditto_lora(torch, vace_cfg, rank: int = 128, seed: int = 7):
    """A rank-`rank` LoRA under the reference's names on every VACE block's
    q, k, v, o (self and cross), ffn.0 and ffn.2, bf16, from a seed."""
    gen = torch.Generator().manual_seed(seed)
    dim, ffn = vace_cfg.dim, vace_cfg.ffn_dim
    shapes = {f"{a}.{n}": (dim, dim) for a in ("self_attn", "cross_attn") for n in "qkvo"}
    shapes.update({"ffn.0": (ffn, dim), "ffn.2": (dim, ffn)})
    sd = {}
    for i in range(len(vace_cfg.vace_layers)):
        for name, (out_f, in_f) in shapes.items():
            pre = f"vace_blocks.{i}.{name}"
            sd[f"{pre}.lora_A.weight"] = (torch.randn((rank, in_f), generator=gen)
                                          / math.sqrt(in_f)).to(torch.bfloat16)
            sd[f"{pre}.lora_B.weight"] = (torch.randn((out_f, rank), generator=gen)
                                          * 1e-3).to(torch.bfloat16)
    return sd


def run_load(torch, holder: list, kernels, frames: int, steps: int, e2e_frames: list,
             ckpt_root):
    """Export the e2e pipeline (holder[0]) in the release layout, free it,
    build it again from the files with `from_pretrained`, check every
    tensor, the edit and the LoRA hotload stack. Returns the loaded pipeline
    and the launches of its edit."""
    import numpy as np
    from video_styler_tpu_torch.models.t5 import UMT5_XXL
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_14B
    from video_styler_tpu_torch.models.wan_vace import VACE_14B
    from video_styler_tpu_torch.models.wan_vae import WAN21_VAE
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer
    from video_styler_tpu_torch.safetensors_io import save_file
    from video_styler_tpu_torch.utils import ckpt as C
    from video_styler_tpu_torch.utils.convert import save_release_files
    from video_styler_tpu_torch.utils.host_memory import RssPeak, drop_from_page_cache
    from video_styler_tpu_torch.utils.model_config import ModelConfig

    pipe = holder.pop()
    folder = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ckpt_root)
    res = dict(phase="load", ckpt_dir=folder)
    try:
        want = checksums(torch, pipeline_modules(pipe))
        nbytes = {name: sum(t.numel() * t.element_size() for t in m.state_dict().values())
                  for name, m in pipeline_modules(pipe).items()}
        free = shutil.disk_usage(folder).free
        res.update(disk_free_gb=free / 1e9, weights_gb={k: v / 1e9 for k, v in nbytes.items()})
        if free < 1.05 * sum(nbytes.values()):
            raise RuntimeError(f"{free / 1e9:.1f} GB free under {folder}: the release's "
                               f"files need {sum(nbytes.values()) / 1e9:.1f} (--ckpt-dir)")
        t0 = time.perf_counter()
        paths = save_release_files(pipe, folder)
        written = paths["dit"] + [paths["t5"], paths["vae"]]
        drop_from_page_cache(written)
        export_s = time.perf_counter() - t0
        file_bytes = sum(os.path.getsize(p) for p in written)
        res.update(export_s=export_s, files=[os.path.basename(p) for p in written],
                   files_gb=file_bytes / 1e9, export_gb_per_s=file_bytes / 1e9 / export_s)

        del pipe
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        res["device_allocated_before_gib"] = torch.cuda.memory_allocated() / 2**30

        groups = [paths["dit"], [paths["vae"]], [paths["t5"]]]
        res["detected_kinds"] = [C.detect_model_kind(C.load_state_dict_files(g, lazy=True))
                                 for g in groups]
        torch.cuda.reset_peak_memory_stats()
        read0 = C.BYTES_READ
        maxrss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        with RssPeak() as rss:
            rss_before = rss.peak
            t0 = time.perf_counter()
            pipe = WanVideoPipeline.from_pretrained([ModelConfig(path=g) for g in groups],
                                                    device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        read = C.BYTES_READ - read0
        # the card's machine has no umT5 tokenizer files: e2e's stand-in
        pipe.prompter.tokenizer = StubTokenizer(TEXT_LEN)
        res.update(load_s=load_s, read_gb=read / 1e9, read_gb_per_s=read / 1e9 / load_s,
                   host_rss_before_gb=rss_before / 1e9, host_rss_peak_gb=rss.peak / 1e9,
                   host_rss_peak_over_before_gb=(rss.peak - rss_before) / 1e9,
                   ru_maxrss_life_gb=max(maxrss0, resource.getrusage(
                       resource.RUSAGE_SELF).ru_maxrss * 1024) / 1e9,
                   device_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   device_allocated_gib=torch.cuda.memory_allocated() / 2**30,
                   tokenizer="StubTokenizer (as e2e)")
        configs = dict(dit=pipe.dit.cfg == WAN_T2V_14B, vace=pipe.vace.cfg == VACE_14B,
                       t5=pipe.prompter.text_encoder.cfg == UMT5_XXL,
                       vae=pipe.vae.cfg == WAN21_VAE)
        res.update(dit_cfg=str(pipe.dit.cfg), vace_cfg=str(pipe.vace.cfg),
                   configs_equal_14b=configs)

        got = checksums(torch, pipeline_modules(pipe))
        bad = sorted(k for k in want if got.get(k) != want[k])
        res.update(tensors_checked=len(want), tensors_bit_equal=len(want) - len(bad),
                   tensors_differing=bad[:10], tensors_missing=sorted(set(want) ^ set(got)))
        emit(res)
        if res["detected_kinds"] != ["dit+vace", "vae", "t5"]:
            raise AssertionError(f"detected kinds {res['detected_kinds']}")
        if not all(configs.values()):
            raise AssertionError(f"loaded configs differ from the 14B ones: {configs}")
        if bad or set(want) != set(got):
            raise AssertionError(f"{len(bad)} loaded tensors differ from the written ones")

        # the e2e request on the loaded pipeline: the same frames
        edit = []
        launches = run_edit(torch, pipe, kernels, steps, frames, "load_edit", {"K1": 1.0},
                            profile=False, outputs=edit)
        e2e_runs_differ = float(max(np.abs(a.astype(np.int16) - e2e_frames[0]).max()
                                    for a in e2e_frames))
        diff = float(np.abs(edit[0].astype(np.int16) - e2e_frames[0]).max())
        check = dict(phase="load_edit_check", frames_identical_to_e2e=diff == 0.0,
                     max_abs_diff_to_e2e=diff, e2e_runs_max_abs_diff=e2e_runs_differ,
                     e2e_runs=len(e2e_frames))
        emit(check)
        if diff > e2e_runs_differ:
            raise AssertionError(f"the loaded pipeline's edit differs from e2e's: {check}")

        # LoRA hotload on the VACE branch at 14B width
        lora_path = os.path.join(folder, "ditto_lora_rank128.safetensors")
        save_file(random_ditto_lora(torch, pipe.vace.cfg), lora_path)
        base = {k: v for k, v in want.items() if k.startswith("vace.")}

        def vace_equal_to_base():
            return checksums(torch, {"vace": pipe.vace}) == base

        hot = dict(phase="load_hotload", lora_rank=128, lora_file_gb=os.path.getsize(
            lora_path) / 1e9)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.load_lora("vace", path=lora_path, alpha=1.0, hotload=True)
        torch.cuda.synchronize()
        hot["load_lora_s"] = time.perf_counter() - t0
        hot["lora_targets"] = len(pipe._lora_stacks["vace"]["base"])
        hot["base_copy_gib"] = sum(w.numel() * w.element_size() for w in
                                   pipe._lora_stacks["vace"]["base"].values()) / 2**30
        hot["merged_differs_from_base"] = not vace_equal_to_base()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.set_lora_scale("vace", 0.5)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        hot["reapply_scale_0.5_s"] = times
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.set_lora_scale("vace", 0.0)
        torch.cuda.synchronize()
        hot["reapply_scale_0_s"] = time.perf_counter() - t0
        hot["scale_0_bit_equal_to_base"] = vace_equal_to_base()
        pipe.set_lora_scale("vace", 1.0)
        pipe.unload_loras("vace")
        torch.cuda.synchronize()
        hot["unloaded_bit_equal_to_base"] = vace_equal_to_base()
        hot["device_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        emit(hot)
        if not (hot["merged_differs_from_base"] and hot["scale_0_bit_equal_to_base"]
                and hot["unloaded_bit_equal_to_base"]):
            raise AssertionError(f"LoRA hotload: {hot}")
        return pipe, launches
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def time_sdpa_bwd(torch, q, k, v, g, reps: int = 5):
    """Median time of PyTorch's SDPA backward alone: torch.autograd.grad after
    an untimed forward, L2 flushed before each (the K3 yardstick); the
    first timed backward of LONG_RUN_MS or more is the time (as in
    time_ms)."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    gt = g.transpose(1, 2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = []
    for i in range(reps + 1):
        out = F.scaled_dot_product_attention(qt, kt, vt)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(out, (qt, kt, vt), gt)
        end.record()
        torch.cuda.synchronize()
        del out
        if i:  # the first is warm-up
            times.append(start.elapsed_time(end))
            if times[-1] >= LONG_RUN_MS:
                break
    return statistics.median(times)


def check_attention_training(torch, s, sk, tag, kind, mag=1.0, check_heads=None,
                             heads: int = 40):
    """K1 with its stats output and K3 at `heads` heads of 128 (40 unless
    given), through `flash_attention` on tensors that require grad (the
    autograd Function of the training path: K1 with stats forward, K3
    backward): q (1, s, heads, 128) scaled by `mag`, k/v (1, sk, heads,
    128). The plain check covers every
    row of the first `check_heads` heads (a head-sliced view: for dK/dV
    every query row contributes), all heads when None. K3's dq-only twin
    (no dK/dV wanted) is checked and timed on the same inputs."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa

    n, d = heads, 128
    scale = d ** -0.5
    gen = torch.Generator("cuda").manual_seed(1)

    def randn(*shape, m=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * m).to(torch.bfloat16)

    q, k, v = randn(1, s, n, d, m=mag), randn(1, sk, n, d), randn(1, sk, n, d)
    g = randn(1, s, n, d)
    hs = slice(0, check_heads or n)
    heads = check_heads or n
    label = f"{kind} S={s} Sk={sk} N={n} D={d} [{tag}]"
    rows = []

    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention(qr, kr, vr, scale)
    if not isinstance(o.grad_fn, fa.FlashAttentionFunction._backward_cls):
        raise AssertionError(f"flash_attention under grad ran {o.grad_fn}")
    l2 = o.grad_fn.saved_tensors[4]
    o = o.detach()
    po, pl2 = fa.flash_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs],
                                       scale, return_stats=True)
    err_o, scale_o = max_err(torch, o[:, :, hs], po)
    err_l2 = (l2[:, hs] - pl2).abs().max().item()
    # L2 is fp32 on both sides: m2 from the same rounded q, l summed in
    # another order
    tol_l2 = 1e-4 * max(1.0, pl2.abs().max().item())
    del po, pl2
    flops = 4.0 * n * s * sk * d
    b_ms, b_by = bound(flops, 2.0 * n * d * (2 * s + 2 * sk) + 4.0 * n * s)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows.append(dict(
        name=f"K1 flash_attention with stats {label}", kernel="K1s", route="cuda",
        source="video_styler_tpu_torch/csrc/flash_attention.cu",
        replaces="video_styler_tpu/ops/flash_attention.py:213",
        max_abs_err=err_o, max_rel_err=err_o / scale_o, tol=TOL_ULPS * scale_o,
        l2_max_abs_err=err_l2, l2_tol=tol_l2, checked_heads=heads,
        ms=time_ms(torch, lambda: fa.flash_attention(qr, kr, vr, scale), 10),
        ms_without_stats=time_ms(torch, lambda: fa.flash_attention(q, k, v, scale), 10),
        plain_ms=time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, scale, return_stats=True), reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 10),
        ptxas=kernel_usage("flash_fwd_capped_kernel"), clocks=gpu_clocks()))
    rows[-1]["ratio_to_library"] = rows[-1]["ms"] / rows[-1]["library_ms"]

    out = fa.flash_attention(qr, kr, vr, scale)
    dq, dk, dv = torch.autograd.grad(out, (qr, kr, vr), g)
    del out, qr, kr, vr
    want = fa.flash_attention_bwd_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs],
                                        o[:, :, hs], l2[:, hs].contiguous(),
                                        g[:, :, hs], scale)
    errs = {}
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        err, sc = max_err(torch, got[:, :, hs], w)
        errs[name] = (err, TOL_ULPS * sc, sc)
    del dq, dk, dv
    got_q = fa.flash_attention_bwd(q, k, v, o, l2, g, scale, need_kv=False)[0]
    err, sc = max_err(torch, got_q[:, :, hs], want[0])
    errs["dq (dq-only)"] = (err, TOL_ULPS * sc, sc)
    del got_q, want
    plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, l2, g, scale), reps=2, warmup=1)
    lib_ms = time_sdpa_bwd(torch, q, k, v, g)
    # the function needs five products of 2*s*sk*d flop per head: S, dP
    # (then P and dS), dV, dK and dQ; it reads q, k, v, o, dO and L2 and
    # writes dq, dk, dv. Without dK/dV: three products, no dk/dv written.
    # Beyond those bytes the design adds the fp32 dQ accumulator: one
    # s x d x 4-byte add per head for every block of 128 keys (bulk
    # reduce-adds that L2 resolves), a zeroing and a read to round it
    work = 2.0 * n * s * sk * d
    in_bytes = 2.0 * n * d * (3 * s + 2 * sk) + 4.0 * n * s
    acc_bytes = 4.0 * n * s * d
    for kern, need_kv, flop_k, nbytes, outs in (
            ("K3", True, 5, in_bytes + 2.0 * n * d * (s + 2 * sk), ("dq", "dk", "dv")),
            ("K3q", False, 3, in_bytes + 2.0 * n * d * s, ("dq (dq-only)",))):
        launch = fa._BwdLaunch(q, k, v, o, l2, g, scale, need_kv=need_kv)
        b_ms, b_by = bound(flop_k * work, nbytes)
        worst = max(outs, key=lambda o_: errs[o_][0] / errs[o_][1])
        ms = time_ms(torch, launch.run, reps=5)
        rows.append(dict(
            name=f"K3 flash_attention_bwd {'dq dk dv' if need_kv else 'dq only'} {label}",
            kernel=kern, route="cuda",
            source="video_styler_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="video_styler_tpu/ops/flash_attention.py:582 and :624",
            max_abs_err=errs[worst][0], tol=errs[worst][1],
            errors={o_: dict(max_abs_err=errs[o_][0], tol=errs[o_][1],
                             max_rel_err=errs[o_][0] / errs[o_][2]) for o_ in outs},
            checked_heads=heads, ms=ms,
            # the plain version and SDPA's backward compute dq, dk and dv
            # together: the same number in both rows
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            ratio_to_library=ms / lib_ms, tflops=flop_k * work / ms / 1e9,
            dq_accumulator_gb=(acc_bytes * math.ceil(sk / 128) + 2 * acc_bytes) / 1e9,
            ptxas=kernel_usage("fa_bwd_kernelILb1" if need_kv else "fa_bwd_kernelILb0"),
            clocks=gpu_clocks()))
        del launch
    for r in rows:
        emit({"phase": "kernel", **r, **CARD})
    failed = [o_ for o_, (e, t, _) in errs.items() if not e <= t]
    if not (rows[0]["max_abs_err"] <= rows[0]["tol"] and err_l2 <= tol_l2):
        failed.append("o/L2")
    if failed:
        raise AssertionError(f"{label}: {failed} beyond tolerance")
    return rows


# K1f and K3f against the float64 function: 2^-19 of its largest magnitude
# (three-pass TF32 products and compensated sums along the sequence keep
# them 2^-20 to 2^-21 from it at 4,680 and 29,640 tokens). Against their
# plain versions: 2^-17 of the output's largest magnitude (the two sum in
# other orders), plus the plain version's own largest distance from the
# float64 function, measured in the same call: the plain version's fp32
# GEMM sums each output over all the keys in one chain, which put it
# 2^-16.7 (o) and 2^-17.0 (dq) from float64 at 29,640 tokens on the heads
# held, where the kernels lie 2^-20.8 and 2^-20.4 from it. K4f and K5f:
# 2^-20 (fp64 and fp32 sums of squares put r a few fp32 ULPs apart)
TOL_ATTN_F32 = 2.0 ** -17
TOL_ATTN_F64 = 2.0 ** -19
TOL_NORM_F32 = 2.0 ** -20
F32_SRC = "video_styler_tpu_torch/csrc/flash_attention_f32.cu"


def f32_bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_TF32X3_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_f64(torch, q, k, v, g, scale: float):
    """K1f's and K3f's function in float64 from float32 q, k, v (1, S, n,
    128) and the cotangent g: (o, dq, dk, dv), the capped softmax taken
    exactly (its m2 cancels), query rows in chunks of at most 2^27 logits.
    The yardstick that the kernels and the plain versions are each
    measured against."""
    q64, k64, v64, g64 = (t.double().permute(0, 2, 1, 3) for t in (q, k, v, g))
    o, dq = torch.empty_like(q64), torch.empty_like(q64)
    dk, dv = torch.zeros_like(k64), torch.zeros_like(v64)
    kt, vt = k64.transpose(-1, -2), v64.transpose(-1, -2)
    rows = max(1, (1 << 27) // (q64.shape[1] * k64.shape[2]))
    for i0 in range(0, q64.shape[2], rows):
        qc, gc = q64[:, :, i0:i0 + rows], g64[:, :, i0:i0 + rows]
        p = torch.softmax(qc @ kt * scale, dim=-1)
        oc = p @ v64
        o[:, :, i0:i0 + rows] = oc
        ds = p * (gc @ vt - (gc * oc).sum(-1, keepdim=True)) * scale
        dv += p.transpose(-1, -2) @ gc
        dk += ds.transpose(-1, -2) @ qc
        dq[:, :, i0:i0 + rows] = ds @ k64
        del p, ds
    return tuple(t.permute(0, 2, 1, 3) for t in (o, dq, dk, dv))


def f64_distance(got, ref):
    """(max |got - ref|, max |ref|) against the float64 `ref`."""
    return (got.double() - ref).abs().max().item(), ref.abs().max().item()


def f64_report(kernel, plain):
    """A kernel's and its plain version's f64_distance as log2 of the
    relative distance, with the kernel's gate."""
    return dict(kernel=math.log2(max(kernel[0], 1e-300) / kernel[1]),
                plain=math.log2(max(plain[0], 1e-300) / plain[1]),
                kernel_within_tol=kernel[0] <= TOL_ATTN_F64 * kernel[1])


def check_f32_attention(torch, s, sk, tag, kind, check_heads=None, heads: int = 40):
    """K1f (without and with stats), K3f and K3q-f, the float32 instantiations
    the Ditto recipe's fp32 activations run (examples/train.py:281), at
    `heads` heads of 128 on q (1, s, heads, 128) and k/v (1, sk, heads, 128).
    The plain check covers every row of the first `check_heads` heads (all
    when None), and on those heads the kernels and the plain versions are
    each measured against the float64 function (`f64_log2`: log2 of max
    |x - f64| over max |f64|; the kernel within TOL_ATTN_F64, and within
    TOL_ATTN_F32 of the plain version plus the plain version's distance
    from float64). The library calls are SDPA on fp32 with TF32 off
    (forward, and its backward for K3f/K3q-f)."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa

    n, d = heads, 128
    scale = d ** -0.5
    gen = torch.Generator("cuda").manual_seed(2)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                  for shape in ((1, s, n, d), (1, sk, n, d), (1, sk, n, d), (1, s, n, d)))
    hs = slice(0, check_heads or n)
    label = f"{kind} S={s} Sk={sk} N={n} D={d} fp32 [{tag}]"
    o, l2 = fa._flash_cuda(q, k, v, scale, with_stats=True)
    o_nostats = fa._flash_cuda(q, k, v, scale)
    po, pl2 = fa.flash_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs], scale,
                                       return_stats=True)
    ref = attention_f64(torch, q[:, :, hs], k[:, :, hs], v[:, :, hs], g[:, :, hs], scale)
    f64_o = dict(plain=f64_distance(po, ref[0]), K1f=f64_distance(o_nostats[:, :, hs], ref[0]),
                 K1fs=f64_distance(o[:, :, hs], ref[0]))
    tol_o = TOL_ATTN_F32 * po.abs().max().item() + f64_o["plain"][0]
    err_o, scale_o = max_err(torch, o[:, :, hs], po)
    err_ns, _ = max_err(torch, o_nostats[:, :, hs], po)
    err_l2 = (l2[:, hs] - pl2).abs().max().item()
    tol_l2 = 1e-5 * max(1.0, pl2.abs().max().item())
    del po, pl2, o_nostats
    flops = 4.0 * n * s * sk * d
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 2,
                     warmup=1)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, scale, return_stats=True),
                       reps=2, warmup=1)
    rows = []
    for name, with_stats, err in (("K1f", False, err_ns), ("K1fs", True, err_o)):
        b_ms, b_by = f32_bound(flops, 4.0 * n * d * (2 * s + 2 * sk)
                               + (4.0 * n * s if with_stats else 0.0))
        # warm: the same call ran above
        ms = time_ms(torch, lambda: fa._flash_cuda(q, k, v, scale, with_stats=with_stats),
                     5, warmup=0)
        rows.append(dict(
            name=f"{name} flash_attention{' with stats' if with_stats else ''} {label}",
            kernel=name, route="cuda", source=F32_SRC,
            replaces="video_styler_tpu/ops/flash_attention.py:213",
            max_abs_err=err, max_rel_err=err / scale_o, tol=tol_o,
            l2_max_abs_err=err_l2 if with_stats else None, l2_tol=tol_l2,
            checked_heads=check_heads or n,
            f64_log2=f64_report(f64_o[name], f64_o["plain"]),
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, ratio_to_library=ms / lib_ms,
            tflops=flops / ms / 1e9, ptxas=kernel_usage("flash_fwd_f32_kernel"),
            clocks=gpu_clocks()))

    want = fa.flash_attention_bwd_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs], o[:, :, hs],
                                        l2[:, hs].contiguous(), g[:, :, hs], scale)
    f64_plain = {nm: f64_distance(w, r) for nm, w, r in zip(("dq", "dk", "dv"), want, ref[1:])}
    work = 2.0 * n * s * sk * d
    in_bytes = 4.0 * n * d * (3 * s + 2 * sk) + 4.0 * n * s
    plain_bwd_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(q, k, v, o, l2, g, scale),
                           reps=2, warmup=1)
    lib_bwd_ms = time_sdpa_bwd(torch, q, k, v, g, reps=2)
    for name, need_kv, flop_k, nbytes in (
            ("K3f", True, 5, in_bytes + 4.0 * n * d * (s + 2 * sk)),
            ("K3q-f", False, 3, in_bytes + 4.0 * n * d * s)):
        got = fa.flash_attention_bwd(q, k, v, o, l2, g, scale, need_kv=need_kv)
        errs = {}
        for out_name, t, w, r in zip(("dq", "dk", "dv"), got, want, ref[1:]):
            if t is not None:
                err, sc = max_err(torch, t[:, :, hs], w)
                errs[out_name] = dict(max_abs_err=err,
                                      tol=TOL_ATTN_F32 * sc + f64_plain[out_name][0],
                                      max_rel_err=err / sc,
                                      f64_log2=f64_report(f64_distance(t[:, :, hs], r),
                                                          f64_plain[out_name]))
        del got
        worst = max(errs.values(), key=lambda e: e["max_abs_err"] / e["tol"])
        launch = fa._BwdLaunch(q, k, v, o, l2, g, scale, need_kv=need_kv)
        b_ms, b_by = f32_bound(flop_k * work, nbytes)
        ms = time_ms(torch, launch.run, reps=5, warmup=0)  # warm: the same call ran above
        del launch
        rows.append(dict(
            name=f"{name} flash_attention_bwd {'dq dk dv' if need_kv else 'dq only'} {label}",
            kernel=name, route="cuda", source=F32_SRC,
            replaces="video_styler_tpu/ops/flash_attention.py:582 and :624",
            max_abs_err=worst["max_abs_err"], tol=worst["tol"], errors=errs,
            f64_within_tol=all(e["f64_log2"]["kernel_within_tol"] for e in errs.values()),
            checked_heads=check_heads or n, ms=ms,
            # the plain version and SDPA's backward compute dq, dk and dv
            # together: the same number in both rows
            plain_ms=plain_bwd_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_bwd_ms,
            ratio_to_library=ms / lib_bwd_ms, tflops=flop_k * work / ms / 1e9,
            ptxas=kernel_usage("fa_bwd_dkv_f32" if need_kv else "fa_bwd_dq_f32"),
            clocks=gpu_clocks()))
    del want, ref
    for r in rows:
        emit({"phase": "kernel", **r, **CARD})
    bad = [r["name"] for r in rows if not r["max_abs_err"] <= r["tol"]]
    bad += [f"{r['name']} (float64)" for r in rows
            if not r.get("f64_within_tol", r.get("f64_log2", {}).get("kernel_within_tol"))]
    if not err_l2 <= tol_l2:
        bad.append(f"L2 {err_l2} > {tol_l2}")
    if bad:
        raise AssertionError(f"fp32 kernels beyond tolerance: {bad}")
    return rows


def check_f32_norms(torch, grid, tag, heads: int = 40):
    """K4f and K5f on float32 rows at `heads` heads of 128 over the grid's
    tokens, with the bf16 weights the recipe keeps (the wrappers cast them
    to float32, as the JAX norm does); K5f's library call is `F.rms_norm`
    on fp32."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr
    from video_styler_tpu_torch.ops.rope import assemble_freqs_grid

    f, h, w = grid
    s, dm = f * h * w, heads * 128
    gen = torch.Generator("cuda").manual_seed(3)
    xq = torch.randn((1, s, dm), generator=gen, device="cuda")
    xk = torch.randn((1, s, dm), generator=gen, device="cuda") * 0.7
    wq, wk = ((1.0 + 0.1 * torch.randn(dm, generator=gen, device="cuda")).to(torch.bfloat16)
              for _ in range(2))
    cos, sin = assemble_freqs_grid(128, f, h, w, device="cuda")
    oq, ok = fnr.fused_rmsnorm_rope(xq, xk, wq, wk, cos, sin)
    pq, pk = fnr.fused_rmsnorm_rope_plain(xq, xk, wq, wk, cos, sin)
    (eq, sq_), (ek, sk_) = max_err(torch, oq, pq), max_err(torch, ok, pk)
    del oq, ok, pq, pk
    err, scale = max(eq, ek), max(sq_, sk_)
    b_ms, b_by = f32_bound(0.0, 4.0 * 4 * s * dm + 4.0 * 2 * s * 64 + 2.0 * 2 * dm)
    rows = [dict(
        name=f"K4f fused_rmsnorm_rope S={s} Dm={dm} fp32 [{tag}]", kernel="K4f",
        route="cuda", source="video_styler_tpu_torch/csrc/fused_norm_rope.cu",
        replaces="video_styler_tpu/ops/fused_norm_rope.py:51",
        max_abs_err=err, max_rel_err=err / scale, tol=TOL_NORM_F32 * scale,
        ms=time_ms(torch, lambda: fnr.fused_rmsnorm_rope(xq, xk, wq, wk, cos, sin), 10),
        plain_ms=time_ms(torch, lambda: fnr.fused_rmsnorm_rope_plain(
            xq, xk, wq, wk, cos, sin), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ptxas=kernel_usage("rmsnorm_rope_f32_kernel"), clocks=gpu_clocks())]
    err, scale = max_err(torch, fnr.fused_rmsnorm(xq, wq), fnr.fused_rmsnorm_plain(xq, wq))
    wq32 = wq.float()
    b_ms, b_by = f32_bound(0.0, 4.0 * 2 * s * dm + 2.0 * dm)
    rows.append(dict(
        name=f"K5f fused_rmsnorm S={s} Dm={dm} fp32 [{tag}]", kernel="K5f",
        route="cuda", source="video_styler_tpu_torch/csrc/fused_norm_rope.cu",
        replaces="video_styler_tpu/ops/fused_norm_rope.py:154",
        max_abs_err=err, max_rel_err=err / scale, tol=TOL_NORM_F32 * scale,
        ms=time_ms(torch, lambda: fnr.fused_rmsnorm(xq, wq), 10),
        plain_ms=time_ms(torch, lambda: fnr.fused_rmsnorm_plain(xq, wq), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: F.rms_norm(xq, (dm,), wq32, 1e-6), 10),
        ptxas=kernel_usage("rmsnorm_f32_kernel"), clocks=gpu_clocks()))
    rows[-1]["ratio_to_library"] = rows[-1]["ms"] / rows[-1]["library_ms"]
    return emit_rows(rows)


def edge_rows(torch, s: int, count: int = 1024):
    """The first and last `count` query rows: full tiles and the ragged tail."""
    return torch.cat([torch.arange(0, min(count, s)),
                      torch.arange(max(0, s - count), s)]).unique().cuda()


def kernel_row(torch, *, name, kernel, source, replaces, got, want, run, plain,
               library, flops, nbytes, int8_ops=0.0, reps=10, **extra):
    """One `kernel` row: error against the plain version on the rows
    compared, median times, and the bound from this call's work (bf16 flops
    at the bf16 peak plus int8 operations at the int8 peak, against bytes)."""
    err, scale = max_err(torch, got, want)
    t_ops = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    ms = time_ms(torch, run, reps=reps)
    lib_ms = None if library is None else time_ms(torch, library, reps=10)
    return dict(name=name, kernel=kernel, route="cuda", source=source,
                replaces=replaces, max_abs_err=err, max_rel_err=err / scale,
                tol=TOL_ULPS * scale, ms=ms,
                plain_ms=time_ms(torch, plain, reps=2, warmup=1),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=lib_ms, ratio_to_library=None if lib_ms is None else ms / lib_ms,
                tflops=(flops + int8_ops) / ms / 1e9, clocks=gpu_clocks(), **extra)


ONLINE_SRC = "video_styler_tpu_torch/csrc/flash_attention_online.cu"
INT8_SRC = "video_styler_tpu_torch/csrc/flash_attention_int8.cu"
JAX_FA = "video_styler_tpu/ops/flash_attention.py"


def check_online_kernels(torch, s, tag, cross: bool, mag: float = 1.0):
    """K2 (with and without stats, and on its 3-D entry) and K8 at 40 heads
    of 128 on `s` query tokens: self-attention, and with `cross` K2 and K8
    against the 512 text tokens too. `mag` scales q (the magnitude stress
    runs K2's self row alone). Each row carries the kernel's registers and
    spills from the build log."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa

    n, d = 40, 128
    scale = d ** -0.5
    gen = torch.Generator("cuda").manual_seed(2)

    def randn(*shape, m=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * m).to(torch.bfloat16)

    q = randn(1, s, n, d, m=mag)
    sub = edge_rows(torch, s)
    rows = []
    for kind, sk in (("self", s),) + ((("cross", TEXT_LEN),) if cross else ()):
        k, v = randn(1, sk, n, d), randn(1, sk, n, d)
        label = f"{kind}{'' if mag == 1.0 else f' q x{mag:g} (magnitude stress)'} " \
                f"S={s} Sk={sk} N={n} D={d} [{tag}]"
        flops = 4.0 * n * s * sk * d
        nbytes = 2.0 * n * d * (2 * s + 2 * sk)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        want, want_l2 = fa.flash_attention_online_plain(q[:, sub], k, v, scale,
                                                        return_stats=True)
        common = dict(source=ONLINE_SRC, library=sdpa, flops=flops, checked_rows=int(sub.numel()))
        k2 = dict(common, ptxas=kernel_usage("flash_fwd_online_kernel"))
        rows.append(kernel_row(
            torch, name=f"K2 flash_attention online {label}", kernel="K2",
            replaces=f"{JAX_FA}:150", got=fa.flash_attention(q, k, v, scale, capped=False)[:, sub],
            want=want, run=lambda: fa.flash_attention(q, k, v, scale, capped=False),
            plain=lambda: fa.flash_attention_online_plain(q, k, v, scale),
            nbytes=nbytes, **k2))
        if mag != 1.0:
            continue
        out, l2 = fa._flash_forward(q, k, v, scale, with_stats=True, capped=False)
        err_l2 = (l2[:, :, sub] - want_l2).abs().max().item()
        tol_l2 = 1e-4 * max(1.0, want_l2.abs().max().item())
        rows.append(kernel_row(
            torch, name=f"K2 flash_attention online with stats {label}", kernel="K2",
            replaces=f"{JAX_FA}:150", got=out[:, sub], want=want,
            run=lambda: fa._flash_forward(q, k, v, scale, with_stats=True, capped=False),
            plain=lambda: fa.flash_attention_online_plain(q, k, v, scale, return_stats=True),
            nbytes=nbytes + 4.0 * n * s, l2_max_abs_err=err_l2, l2_tol=tol_l2, **k2))
        if not err_l2 <= tol_l2:
            raise AssertionError(f"K2 L2 {label}: {err_l2} > {tol_l2}")
        del out, l2
        want8 = fa.flash_attention_online_plain(q[:, sub], k, v, scale, dual=True)
        rows.append(kernel_row(
            torch, name=f"K8 flash_attention online dual {label}", kernel="K8",
            replaces=f"{JAX_FA}:288",
            got=fa.flash_attention(q, k, v, scale, capped=False, dual=True)[:, sub],
            want=want8,
            run=lambda: fa.flash_attention(q, k, v, scale, capped=False, dual=True),
            plain=lambda: fa.flash_attention_online_plain(q, k, v, scale, dual=True),
            nbytes=nbytes, ptxas=kernel_usage("flash_fwd_online_dual_kernel"), **common))
        del want8
        del k, v, want, want_l2
    if mag == 1.0 and cross:
        # the 3-D entry on (heads, S, D): the same memory as a batch of
        # one-head problems; q is scaled beforehand, the kernel takes it as is
        q3, k3, v3 = randn(n, s, d), randn(n, s, d), randn(n, s, d)
        want = fa.flash_attention_online_plain(q3[:, sub, None], k3[:, :, None],
                                               v3[:, :, None], scale)[:, :, 0]
        rows.append(kernel_row(
            torch, name=f"K2 flash_attention_3d BH={n} S={s} D={d} [{tag}]", kernel="K2",
            source=ONLINE_SRC, replaces=f"{JAX_FA}:54",
            got=fa.flash_attention_3d(q3, k3, v3, scale)[:, sub], want=want,
            run=lambda: fa.flash_attention_3d(q3, k3, v3, scale),
            plain=lambda: fa.flash_attention_online_plain(
                q3[:, :, None], k3[:, :, None], v3[:, :, None], scale),
            library=lambda: F.scaled_dot_product_attention(q3[None], k3[None], v3[None]),
            flops=4.0 * n * s * s * d, nbytes=2.0 * n * d * 4 * s,
            checked_rows=int(sub.numel()), ptxas=kernel_usage("flash_fwd_online_kernel")))
    for r in rows:
        emit({"phase": "kernel", **r, **CARD})
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{r['name']}: max abs err {r['max_abs_err']} "
                                 f"> tolerance {r['tol']}")
    return rows


def check_online_training(torch, s, tag):
    """K2 with stats feeding K3 under autograd (`flash_attention(...,
    capped=False)` on tensors that require grad) against the plain pair."""
    from video_styler_tpu_torch.ops import flash_attention as fa
    n, d = 40, 128
    scale = d ** -0.5
    gen = torch.Generator("cuda").manual_seed(3)
    q, k, v, g = ((torch.randn((1, s, n, d), generator=gen, device="cuda")
                   ).to(torch.bfloat16) for _ in range(4))
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (fa.ONLINE_KERNEL.launches, fa.BWD_KERNEL.launches,
              fa.BWD_DQ_KERNEL.launches, fa.KERNEL.launches)
    out = fa.flash_attention(*ins, scale, capped=False)
    l2 = out.grad_fn.saved_tensors[4]
    got = torch.autograd.grad(out, ins, g)
    after = (fa.ONLINE_KERNEL.launches, fa.BWD_KERNEL.launches,
             fa.BWD_DQ_KERNEL.launches, fa.KERNEL.launches)
    po, pl2 = fa.flash_attention_online_plain(q, k, v, scale, return_stats=True)
    want = fa.flash_attention_bwd_plain(q, k, v, out.detach(), l2, g, scale)
    errs = {}
    for name, t, w in zip(("o", "dq", "dk", "dv"), (out,) + got, (po,) + want):
        err, sc = max_err(torch, t, w)
        errs[name] = dict(max_abs_err=err, tol=TOL_ULPS * sc)
    err_l2 = (l2 - pl2).abs().max().item()
    res = dict(phase="kernel", name=f"K2 with stats -> K3 under autograd S={s} N={n} "
               f"D={d} [{tag}]", kernel="K2+K3", errors=errs, l2_max_abs_err=err_l2,
               l2_tol=1e-4 * max(1.0, pl2.abs().max().item()),
               launches=dict(zip(("K2", "K3", "K3q", "K1"),
                                 (a - b for a, b in zip(after, before)))))
    emit(res)
    if (res["launches"] != {"K2": 1, "K3": 1, "K3q": 0, "K1": 0}
            or not err_l2 <= res["l2_tol"]
            or any(not e["max_abs_err"] <= e["tol"] for e in errs.values())):
        raise AssertionError(f"online route under autograd: {res}")


def check_int8_kernels(torch, s, tag, cross: bool, three_d: bool, mag: float = 1.0):
    """K6 (capped and online bodies) at 40 heads of 128 on `s` query tokens,
    K carrying a +0.7 mean offset for the token-mean smoothing to absorb;
    with `three_d` K7 on (40, s, 128). Kernel and plain version read the
    same pre-pass outputs (the same integers); the pre-pass is timed on its
    own, and so is the bf16 kernel of the same body on the same q, k, v
    (`bf16_ms`: K1 for the capped rows, K2 for the online ones), whether
    int8 attention pays. Each row carries the kernel's registers and spills."""
    from video_styler_tpu_torch.ops import flash_attention as fa

    n, d = 40, 128
    scale = d ** -0.5
    gen = torch.Generator("cuda").manual_seed(4)

    def randn(*shape, m=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * m).to(torch.bfloat16)

    def pick(pre, sub):
        q8, k8, v, qs, ks, m2 = pre
        return (q8[:, sub], k8, v, qs[:, :, sub].contiguous(), ks,
                None if m2 is None else m2[:, :, sub].contiguous())

    q = randn(1, s, n, d, m=mag)
    sub = edge_rows(torch, s)
    rows = []
    # the capped and online instantiations of K6 (K7 is the online one)
    ptxas = {"capped": kernel_usage("flash_fwd_int8_kernelILb1"),
             "online": kernel_usage("flash_fwd_int8_kernelILb0")}
    for kind, sk in (("self", s),) + ((("cross", TEXT_LEN),) if cross else ()):
        k, v = randn(1, sk, n, d) + 0.7, randn(1, sk, n, d)
        label = f"{kind}{'' if mag == 1.0 else f' q x{mag:g} (magnitude stress)'} " \
                f"S={s} Sk={sk} N={n} D={d} [{tag}]"
        prepass_ms = time_ms(torch, lambda: fa.int8_prepass(q, k, v, scale, True), reps=5)
        for body, replaces in (("capped", f"{JAX_FA}:1025"), ("online", f"{JAX_FA}:980")):
            pre = fa.int8_prepass(q, k, v, scale, body == "capped")
            # q8, k8 (1 byte), v, o (2 bytes), the row scales (and bounds)
            nbytes = n * d * (s + sk) + 2.0 * n * d * (s + sk) \
                + 4.0 * n * (s + sk) + (4.0 * n * s if body == "capped" else 0.0)
            rows.append(kernel_row(
                torch, name=f"K6 flash_attention_int8 {body} {label}",
                kernel="K6" if body == "capped" else "K6o", source=INT8_SRC,
                replaces=replaces, got=fa._flash_int8_cuda(*pre)[:, sub],
                want=fa.flash_attention_int8_core_plain(*pick(pre, sub)),
                run=lambda: fa._flash_int8_cuda(*pre),
                plain=lambda: fa.flash_attention_int8_core_plain(*pre), library=None,
                flops=2.0 * n * s * sk * d, int8_ops=2.0 * n * s * sk * d, nbytes=nbytes,
                checked_rows=int(sub.numel()), prepass_ms=prepass_ms,
                bf16_ms=time_ms(torch, lambda: fa.flash_attention(
                    q, k, v, scale, capped=body == "capped"), reps=10), ptxas=ptxas[body]))
            del pre
        del k, v
    if three_d:
        q3, k3, v3 = randn(n, s, d), randn(n, s, d) + 0.7, randn(n, s, d)
        pre = fa.int8_prepass(q3[:, :, None], k3[:, :, None], v3[:, :, None], scale, False)
        rows.append(kernel_row(
            torch, name=f"K7 flash_attention_int8_3d BH={n} S={s} D={d} [{tag}]",
            kernel="K7", source=INT8_SRC, replaces=f"{JAX_FA}:862",
            got=fa._flash_int8_cuda(*pre, three_d=True)[:, sub],
            want=fa.flash_attention_int8_core_plain(*pick(pre, sub)),
            run=lambda: fa._flash_int8_cuda(*pre, three_d=True),
            plain=lambda: fa.flash_attention_int8_core_plain(*pre), library=None,
            flops=2.0 * n * s * s * d, int8_ops=2.0 * n * s * s * d,
            nbytes=n * d * 2 * s + 2.0 * n * d * 2 * s + 4.0 * n * 2 * s,
            checked_rows=int(sub.numel()), ptxas=ptxas["online"],
            bf16_ms=time_ms(torch, lambda: fa.flash_attention_3d(q3, k3, v3, scale), reps=10)))
        # the public entry runs the same pre-pass and kernel
        if not torch.equal(fa.flash_attention_int8_3d(q3, k3, v3, scale),
                           fa._flash_int8_cuda(*pre, three_d=True)[:, :, 0]):
            raise AssertionError("flash_attention_int8_3d differs from its parts")
    for r in rows:
        emit({"phase": "kernel", **r, **CARD})
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{r['name']}: max abs err {r['max_abs_err']} "
                                 f"> tolerance {r['tol']}")
    return rows


def check_train_reference(torch):
    """Two LoRA steps of the smoke-size model on the card (kernels) and on
    the CPU (plain versions), from the same weights, LoRA, inputs, tid and
    noise (all made on the CPU); fp32 inputs on the bf16 weights, as the
    train CLI hands its step (K1f, K3f, K3q-f, K4f, K5f on the card)."""
    from torch import nn
    from video_styler_tpu_torch.infer_ditto import build_smoke_pipeline, smoke_frames
    from video_styler_tpu_torch.trainers.lora_train import (
        apply_lora, init_lora, lora_parameters, lora_targets)
    from video_styler_tpu_torch.trainers.training import (
        adamw, make_train_step, training_scheduler)

    cpu = build_smoke_pipeline(device="cpu", seed=0)
    f, h, w = 9, 64, 64
    with torch.no_grad():
        context = cpu.encode_prompt("a watercolor city at dusk")
        vctx = cpu.build_vace_context(smoke_frames(f, h, w), None, None, h, w, f,
                                      tiled=False)
    latents = torch.randn((1, 4, 3, 8, 8), generator=torch.Generator().manual_seed(1))
    context, vctx = context.float(), vctx.float()
    for m in (cpu.dit, cpu.vace):
        m.requires_grad_(False)
    dit_g, vace_g = copy.deepcopy(cpu.dit).to("cuda"), copy.deepcopy(cpu.vace).to("cuda")
    lora_c = init_lora(cpu.vace, rank=32,
                       targets=lora_targets("q,k,v,o,ffn.0,ffn.2", "vace"),
                       generator=torch.Generator().manual_seed(0))
    lora_g = {k: {n: nn.Parameter(p.detach().to("cuda")) for n, p in ab.items()}
              for k, ab in lora_c.items()}
    steps = []
    for dit, vace, lora in ((cpu.dit, cpu.vace, lora_c), (dit_g, vace_g, lora_g)):
        apply_lora(vace, lora)
        params = lora_parameters(lora)
        steps.append((make_train_step(dit, adamw(params, 1e-4), training_scheduler(),
                                      vace=vace), params))
    draws = torch.Generator().manual_seed(2)
    res = dict(phase="train_reference", frames=f, height=h, width=w, lora_rank=32,
               loss_cpu=[], loss_gpu=[], grads_rel_l2=[], lora_rel_l2=[],
               loss_rel_tol=5e-2, grads_tol=5e-2, lora_tol=1e-3)

    def cat(ts):
        return torch.cat([t.detach().float().reshape(-1).cpu() for t in ts])

    for _ in range(2):
        tid = int(torch.randint(0, 1000, (), generator=draws))
        noise = torch.randn(latents.shape, generator=draws)
        out = []
        for (step, params), dev in zip(steps, ("cpu", "cuda")):
            loss = step(latents.to(dev), context.to(dev), vctx.to(dev), tid=tid,
                        noise=noise)
            out.append((float(loss), cat(p.grad for p in params), cat(params)))
        (lc, gc, pc), (lg, gg, pg) = out
        res["loss_cpu"].append(lc)
        res["loss_gpu"].append(lg)
        res["grads_rel_l2"].append(((gg - gc).norm() / gc.norm()).item())
        res["lora_rel_l2"].append(((pg - pc).norm() / pc.norm()).item())
    emit(res)
    # tolerance: the bf16 model rounds at other points on the two devices
    # (cuBLAS vs CPU GEMMs, kernels vs plain); AdamW's step moves each entry
    # by about lr, so the updated LoRA stays within ~lr of the CPU's
    ok = all(abs(g - c) <= 5e-2 * abs(c) for g, c in zip(res["loss_gpu"], res["loss_cpu"]))
    ok = ok and max(res["grads_rel_l2"]) <= 5e-2 and max(res["lora_rel_l2"]) <= 1e-3
    if not ok or not all(map(math.isfinite, res["loss_gpu"])):
        raise AssertionError(f"LoRA steps on the card and the CPU disagree: {res}")


def expected_train_launches(dit_cfg, vace_cfg, targets, steps: int, f32: bool = False):
    """Kernel launches of `steps` LoRA steps on the VACE branch, from the
    configuration (f32: the float32 instantiations, which the recipe's fp32
    activations launch). Trunk blocks up to the first VACE layer see no input that
    needs a gradient: they run forward only, unrecorded. The others and
    every VACE block are rematerialised (one more forward each) and
    differentiated. Self-attention backward needs dq and dK/dV (K3); the
    trunk's cross-attention keys come from the frozen text path, so only dq
    (K3q), while the VACE cross-attention's k/v carry the LoRA when it
    targets them."""
    n_trunk, n_vace = dit_cfg.num_layers, len(vace_cfg.vace_layers)
    trunk_bwd = n_trunk - 1 - vace_cfg.vace_layers[0]
    fwd = n_trunk + n_vace
    recompute = trunk_bwd + n_vace
    cross_kv = bool({"blocks.cross_attn.k", "blocks.cross_attn.v"} & set(targets))
    per_step = {"K1": 2 * (fwd + recompute), "K4": fwd + recompute,
                "K5": fwd + recompute,
                "K3": trunk_bwd + n_vace + (n_vace if cross_kv else 0),
                "K3q": trunk_bwd + (0 if cross_kv else n_vace)}
    names = F32_NAMES if f32 else {k: k for k in per_step}
    return {names[k]: v * steps for k, v in per_step.items()}


# a bf16 kernel's float32 instantiation, by the names of the kernels dict
F32_NAMES = {"K1": "K1f", "K3": "K3f", "K3q": "K3q-f", "K4": "K4f", "K5": "K5f"}


def run_train(torch, pipe, kernels, frames: int, steps: int = 2):
    """The Ditto LoRA recipe at 14B width on the loaded pipeline, through the
    training CLI's data path (`video_styler_tpu_torch.train`): its
    `preprocess` of the train clip with umT5 parked on the host between
    encodes (`park_encoders`, as the CLI trains from a dataset), written by
    `launch_data_process_task` and read back by `CachedLatentDataset` and
    `cached_inputs`; then umT5 and the VAE parked as the CLI parks them
    when it trains from a cache. The inputs are fp32 on the bf16 weights,
    as examples/train.py:281 casts them: the steps launch K1f, K3f, K3q-f,
    K4f and K5f and no bf16 kernel. A step that runs out of the card's
    memory is reported (`oom`) and ends the phase."""
    from video_styler_tpu_torch import train as cli
    from video_styler_tpu_torch.trainers.latent_cache import (
        CachedLatentDataset, launch_data_process_task)
    from video_styler_tpu_torch.trainers.lora_train import (
        apply_lora, init_lora, lora_parameters, lora_targets)
    from video_styler_tpu_torch.trainers.training import (
        adamw, flow_match_loss, make_train_step, training_scheduler)

    f, h, w = frames, 480, 832
    args = cli.parse_args(["--height", str(h), "--width", str(w), "--num_frames", str(f),
                           "--lora_base_model", "vace", "--lora_rank", "128",
                           "--extra_inputs", "vace_video"])[1]
    keys = ("latents", "context", "vace_context")
    for m in (pipe.dit, pipe.vace, pipe.vae, pipe.prompter.text_encoder):
        m.requires_grad_(False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    text_encoder = cli.park_encoders(pipe, cache_fed=False)
    torch.cuda.synchronize()
    park_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with text_encoder:
        torch.cuda.synchronize()
        borrow_s = time.perf_counter() - t0
    in_memory = {}

    def preprocess(row):
        """train.py's preprocess, its result cast as the CLI's loop casts it
        (`fp32_inputs`) kept as the in-memory inputs."""
        in_memory.update(cli.fp32_inputs(cli.preprocess(pipe, row, args, text_encoder)))
        return dict(in_memory)

    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    try:
        t0 = time.perf_counter()
        written = launch_data_process_task(
            [{"prompt": "turn the scene into a watercolor painting",
              "video": synthetic_clip(f)}], preprocess, cache)
        torch.cuda.synchronize()
        data_process_s = (time.perf_counter() - t0) / len(written)
        data_process_peak = torch.cuda.max_memory_allocated()
        cache_mb = sum(os.path.getsize(p) for p in written) / 1e6
        sample = cli.fp32_inputs(cli.cached_inputs(pipe, CachedLatentDataset(cache)[0]))
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    latents, context, vace_context = (sample[k] for k in keys)
    cache_bit_equal = {k: bool(torch.equal(in_memory[k], sample[k])) for k in keys}
    input_dtypes = {k: str(sample[k].dtype) for k in keys}
    cli.park_encoders(pipe, cache_fed=True)
    torch.cuda.synchronize()

    targets = lora_targets("q,k,v,o,ffn.0,ffn.2", "vace")
    gen = torch.Generator().manual_seed(0)
    lora = init_lora(pipe.vace, rank=128, targets=targets, generator=gen)
    apply_lora(pipe.vace, lora)
    params = lora_parameters(lora)
    sched = training_scheduler()
    step = make_train_step(pipe.dit, adamw(params, 1e-4), sched,
                           vace=pipe.vace, remat=True)
    # one loss from the in-memory inputs and one from the cached ones, with
    # the same tid and noise
    noise = torch.randn(latents.shape, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        same_loss = [float(flow_match_loss(
            pipe.dit, inputs["latents"], inputs["context"], sched.sigmas, sched.timesteps,
            sched.linear_timesteps_weights, tid=500, noise=noise, vace=pipe.vace,
            vace_context=inputs["vace_context"]))
            for inputs in (in_memory, sample)]
    del in_memory, sample
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    losses, step_s, oom = [], [], None
    for _ in range(steps):
        t0 = time.perf_counter()
        try:
            loss = step(latents, context, vace_context, generator=gen)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            oom = str(e).split(". ")[0]
            break
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {name: kern.launches for name, kern in kernels.items()}
    expected = expected_train_launches(pipe.dit.cfg, pipe.vace.cfg, targets,
                                       steps, f32=True)
    res = dict(phase="train", dit_layers=pipe.dit.cfg.num_layers,
               vace_layers=list(pipe.vace.cfg.vace_layers), frames=f,
               tokens=int(math.prod(token_grid(f))), latents=list(latents.shape),
               lora_rank=128, lora_targets=list(targets),
               lora_params=sum(p.numel() for p in params), remat="trunk and VACE",
               encoders="umT5 on the host between encodes, then umT5 and the VAE "
                        "on the host for the cache-fed steps (train.park_encoders)",
               inputs="train.preprocess (streaming VAE encodes) -> latent cache "
                      "(launch_data_process_task, CachedLatentDataset, "
                      "train.cached_inputs)",
               park_umt5_s=park_s, umt5_to_card_s=borrow_s,
               data_process_s_per_sample=data_process_s,
               data_process_peak_gib=data_process_peak / 2**30,
               cache_mb_per_sample=cache_mb,
               cache_bit_equal_to_in_memory=cache_bit_equal,
               loss_in_memory_vs_cached=same_loss, input_dtypes=input_dtypes,
               activations="fp32 (examples/train.py:281) on bf16 weights, TF32 off",
               losses=losses, step_s=step_s, oom=oom,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, expected_launches=expected, **CARD)
    emit(res)
    if oom is not None:
        return launches, None
    if set(input_dtypes.values()) != {"torch.float32"}:
        raise AssertionError(f"the train CLI handed the step {input_dtypes}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not all(cache_bit_equal.values()) or same_loss[0] != same_loss[1]:
        raise AssertionError("the cached inputs differ from the in-memory ones")
    check_launches(launches, expected, "train")
    emit({"phase": "train_profile", **profile_request(
        torch, lambda: step(latents, context, vace_context, generator=gen),
        step_s[-1])})
    return launches, (latents, context, vace_context, params)


@contextlib.contextmanager
def plain_versions():
    """Send the DiT's attention, RMSNorm+RoPE and RMSNorm through their plain
    PyTorch versions on the card, for activations the kernels do not take
    (fp32). A measurement device of this script: the port itself never runs
    a plain version on a CUDA tensor."""
    from video_styler_tpu_torch.models import wan_dit
    from video_styler_tpu_torch.ops import attention
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr
    saved = (attention.flash_attention, wan_dit.fused_rmsnorm_rope, wan_dit.fused_rmsnorm)
    attention.flash_attention = fa.flash_attention_plain
    wan_dit.fused_rmsnorm_rope = fnr.fused_rmsnorm_rope_plain
    wan_dit.fused_rmsnorm = fnr.fused_rmsnorm_plain
    try:
        yield
    finally:
        attention.flash_attention, wan_dit.fused_rmsnorm_rope, wan_dit.fused_rmsnorm = saved


def run_train_precision(torch, pipe, kernels, inputs, frames: int, plain_oom_ok: bool = False):
    """One LoRA loss and gradient at 14B width and full depth on the train
    clip, twice from the same tid and noise, both at the recipe's fp32
    activations on the bf16 weights (examples/train.py:281): through the
    float32 kernels (what the port's trainer runs) and through the plain
    versions. Targets: loss within 1e-5 relative, LoRA gradients within
    1e-3 relative L2 (the kernels and the plain versions lie within 2^-17
    of each other per call; 48 blocks of forward and backward compound
    that). Either run running out of the card's memory fails the phase,
    unless `plain_oom_ok`: then the plain run's OOM is reported (`--only
    train` at a frame count where only the kernels fit)."""
    from video_styler_tpu_torch.trainers.training import (flow_match_loss,
                                                          training_scheduler)
    latents, context, vace_context, params = inputs
    sched = training_scheduler()
    tables = (sched.sigmas, sched.timesteps, sched.linear_timesteps_weights)
    tid = 500
    noise = torch.randn(latents.shape, generator=torch.Generator().manual_seed(5))

    def loss_and_grads(oom_ok=False):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels.values():
            kern.launches = 0
        t0 = time.perf_counter()
        try:
            loss = flow_match_loss(pipe.dit, latents.float(), context.float(), *tables,
                                   tid=tid, noise=noise, vace=pipe.vace,
                                   vace_context=vace_context.float(), remat=True)
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            if not oom_ok:
                raise
            loss = grads = None
            gc.collect()
            torch.cuda.empty_cache()
            return dict(oom=str(e).split(". ")[0],
                        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30), None
        return dict(loss=float(loss), seconds=time.perf_counter() - t0,
                    max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                    launches={n: k.launches for n, k in kernels.items() if k.launches}), \
            torch.cat([g.float().reshape(-1) for g in grads])

    kern, gk = loss_and_grads()
    with plain_versions():
        plain, gp = loss_and_grads(oom_ok=plain_oom_ok)
    res = dict(phase="train_precision", frames=frames,
               tokens=int(math.prod(token_grid(frames))),
               dit_layers=pipe.dit.cfg.num_layers,
               vace_layers=list(pipe.vace.cfg.vace_layers), tid=tid,
               activations="fp32 on bf16 weights, TF32 off", fp32_kernels=kern,
               fp32_plain=plain, loss_rel_tol=1e-5, grads_rel_l2_tol=1e-3, **CARD)
    if gp is not None:
        res.update(lora_params=int(gp.numel()),
                   loss_rel_err=abs(kern["loss"] - plain["loss"]) / abs(plain["loss"]),
                   lora_grads_rel_l2=((gk - gp).norm() / gp.norm()).item(),
                   lora_grads_cosine=(torch.dot(gk, gp) / (gk.norm() * gp.norm())).item())
    emit(res)
    expected = {F32_NAMES[k] for k in ("K1", "K3", "K4", "K5")}
    if not expected <= set(kern["launches"]) or set(kern["launches"]) - set(F32_NAMES.values()):
        raise AssertionError(f"train_precision: the kernel run launched {kern['launches']}")
    if plain.get("launches"):
        raise AssertionError(f"train_precision: the plain run launched {plain['launches']}")
    if gp is not None and not (res["loss_rel_err"] <= 1e-5
                               and res["lora_grads_rel_l2"] <= 1e-3):
        raise AssertionError(f"train_precision: kernels and plain versions disagree: {res}")


# ------------------------------------------------- editor and enhancer phases

def check_card_against_cpu(torch, phase, cpu, gpu, run, **extra):
    """run(pipe) -> latents on the CPU pipeline and on its card copy, within
    the 5% relative L2 of `reference`."""
    lat_c = run(cpu).float()
    lat_g = run(gpu).float().cpu()
    rel = ((lat_g - lat_c).norm() / lat_c.norm()).item()
    res = dict(phase=phase, latents_shape=list(lat_c.shape), latents_rel_l2=rel,
               latents_tol=5e-2, finite=bool(torch.isfinite(lat_g).all()), **extra)
    return res, rel <= 5e-2 and res["finite"]


def check_editor_reference(torch):
    """The smoke-size editor (9 frames of 32x32, keyframes at frames 0 and
    8, CFG 5 two-pass, 2 steps, no TeaCache), card against CPU."""
    from video_styler_tpu_torch.infer_ditto import smoke_frames
    from video_styler_tpu_torch.pipelines.wan_video_editor import WanVideoEditorPipeline
    from video_styler_tpu_torch.step2_video_editing import build_smoke_pipeline
    cpu = build_smoke_pipeline(device="cpu", seed=0)
    gpu = card_copy(torch, cpu, WanVideoEditorPipeline)
    video = smoke_frames(9, 32, 32)
    kw = dict(prompt="a watercolor city at dusk", source_video=video,
              edited_keyframes=255 - video[[0, 8]], keyframe_indices=[0, 8],
              num_frames=9, height=32, width=32, seed=42, cfg_scale=5.0,
              num_inference_steps=2, alpha=10.0, tiled=True, verbose=False,
              return_latents=True)
    res, ok = check_card_against_cpu(torch, "editor_reference", cpu, gpu,
                                     lambda pipe: pipe(**kw), keyframes=[0, 8],
                                     steps=2, cfg="two-pass 5.0")
    emit(res)
    if not ok:
        raise AssertionError(f"editor, card vs CPU disagree: {res}")


ENHANCE_WINDOW = dict(sampling_steps=8, forward_step=6, skip_backward_step=6, shift=5.0,
                      guide_scale=(3.0, 4.0), boundary=0.875, seed=42)


def check_enhance_reference(torch):
    """The smoke-size enhancer with two distinct tiny experts on a window
    that crosses the boundary (timesteps 937, 892 on the high-noise expert;
    833, 749, 624, 416 on the low-noise one), card against CPU."""
    from video_styler_tpu_torch.enhance_video import build_smoke_pipeline
    from video_styler_tpu_torch.infer_ditto import smoke_frames
    from video_styler_tpu_torch.pipelines.wan_enhancer import WanEnhancerPipeline
    cpu = build_smoke_pipeline(device="cpu", seed=0)
    gpu = card_copy(torch, cpu, WanEnhancerPipeline)
    video = smoke_frames(9, 32, 32)
    res, ok = check_card_against_cpu(
        torch, "enhance_reference", cpu, gpu,
        lambda pipe: pipe.enhance(video, prompt="sharp and clean", return_latents=True,
                                  **ENHANCE_WINDOW), window=ENHANCE_WINDOW)
    res["experts"] = gpu.experts
    emit(res)
    if not ok or {w for _, w in gpu.experts} != {"dit", "dit2"}:
        raise AssertionError(f"enhancer, card vs CPU disagree: {res}")


def step_times(pipe):
    return [s for name, s in pipe.stage_times if name.startswith("denoise_step_")]


def editor_keyframes(frames: int):
    """Pixel frames of the editor phase's keyframes: the first and the last,
    and the middle one from 73 frames on."""
    return [0, frames - 1] if frames < DITTO_FRAMES else [0, (frames - 1) // 2, frames - 1]


def run_editor(torch, pipe, kernels, frames: int, steps: int):
    """The keyframe-guided editor on the loaded 14B pipeline's DiT (no
    VACE): a 480x832 clip, keyframes from `editor_keyframes`, CFG 5 two-pass,
    alpha 10, streaming VAE; launches counted from 0."""
    import numpy as np
    from video_styler_tpu_torch.pipelines.wan_video_editor import WanVideoEditorPipeline
    ed = WanVideoEditorPipeline(device="cuda")
    ed.__dict__.update(pipe.__dict__)
    video = synthetic_clip(frames)
    kf = editor_keyframes(frames)
    t_lat = (frames - 1) // 4 + 1
    kf_lat = ed.latent_keyframe_indices(kf, t_lat)
    grid = (t_lat + len(kf_lat), 30, 52)
    n_layers = ed.dit.cfg.num_layers

    def request():
        return ed(prompt="turn the scene into a watercolor painting", source_video=video,
                  edited_keyframes=255 - video[kf], keyframe_indices=kf, seed=42,
                  height=480, width=832, num_frames=frames, cfg_scale=5.0,
                  num_inference_steps=steps, alpha=10.0, tiled=True, verbose=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    out = request()
    total_s = time.perf_counter() - t0
    forwards = 2 * steps
    expected = {"K1": 2 * n_layers * forwards, "K4": n_layers * forwards,
                "K5": n_layers * forwards}
    launches = {name: kern.launches for name, kern in kernels.items()}
    res = dict(phase="editor", frames=frames, keyframes=kf, latent_keyframes=kf_lat,
               joint_tokens=int(np.prod(grid)), dit_layers=n_layers, steps=steps,
               cfg="two-pass 5.0", alpha=10.0, total_s=total_s,
               stages=dict(ed.stage_times), step_s=step_times(ed),
               stage_peak_gib={k: v / 2**30 for k, v in ed.stage_peak_bytes},
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               metrics=ed.metrics, output_shape=list(out.shape),
               decoded_video_finite=True, launches=launches,
               expected_launches=expected)
    emit(res)
    check_launches(launches, expected, "editor")
    if out.shape != (frames, 480, 832, 3):
        raise AssertionError(f"editor output shape {out.shape}")
    emit({"phase": "editor_profile", **profile_request(torch, request, total_s)})
    return launches, grid, ed.construct_rope_ids(t_lat, kf_lat)


def run_enhance(torch, pipe, kernels, frames: int):
    """The Wan2.2 enhancer at A14B width: the loaded DiT as the low-noise
    expert and a second WAN_T2V_14B DiT from a seed as the high-noise one,
    both resident; umT5 and VACE parked on the host (`train.HostParked`)
    with umT5 brought back for each prompt encode. A 480x832 clip, the
    boundary-crossing window, guide scales (3, 4), streaming VAE."""
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_14B, WanDiT, init_weights_
    from video_styler_tpu_torch.pipelines.wan_enhancer import WanEnhancerPipeline
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.train import HostParked
    enh = WanEnhancerPipeline(device="cuda")
    enh.__dict__.update(pipe.__dict__)
    enh.vace = None
    parked_t5 = HostParked(pipe.prompter.text_encoder)
    parked_vace = HostParked(pipe.vace)

    def encode_prompt(prompt):
        with parked_t5:
            return WanVideoPipeline.encode_prompt(enh, prompt)
    enh.encode_prompt = encode_prompt

    t0 = time.perf_counter()
    with torch.device("meta"):
        dit2 = WanDiT(WAN_T2V_14B, dtype=torch.bfloat16)
    enh.dit2 = init_weights_(dit2.to_empty(device="cuda"),
                             torch.Generator("cuda").manual_seed(1)).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_layers = enh.dit.cfg.num_layers
    steps = ENHANCE_WINDOW["skip_backward_step"]
    res = dict(phase="enhance", frames=frames,
               tokens=int(math.prod(token_grid(frames))), dit_layers=n_layers,
               window=ENHANCE_WINDOW, dit2_build_s=build_s,
               weights_on_card_gib=torch.cuda.memory_allocated() / 2**30,
               parked_on_host=["umT5", "VACE"])
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels.values():
            kern.launches = 0
        video = synthetic_clip(frames)

        def request():
            return enh.enhance(video, prompt="sharp, clean, detailed",
                               negative_prompt="blurry, noisy", tiled=True,
                               **ENHANCE_WINDOW)
        t0 = time.perf_counter()
        try:
            out = request()
        except torch.cuda.OutOfMemoryError as e:
            if frames <= RUN_FRAMES:
                raise
            res.update(fits=False, error=str(e).splitlines()[0],
                       max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
            emit(res)
            return {}
        total_s = time.perf_counter() - t0
        expected = {"K1": 2 * n_layers * 2 * steps, "K4": n_layers * 2 * steps,
                    "K5": n_layers * 2 * steps}
        launches = {name: kern.launches for name, kern in kernels.items()}
        res.update(fits=True, total_s=total_s, stages=dict(enh.stage_times),
                   steps=[dict(timestep=t, expert=w, seconds=s) for (t, w), s
                          in zip(enh.experts, step_times(enh))],
                   stage_peak_gib={k: v / 2**30 for k, v in enh.stage_peak_bytes},
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                   output_shape=list(out.shape), decoded_video_finite=True,
                   launches=launches, expected_launches=expected)
        emit(res)
        check_launches(launches, expected, "enhance")
        if out.shape != (frames, 480, 832, 3) or \
                {w for _, w in enh.experts} != {"dit", "dit2"}:
            raise AssertionError(f"enhance: {res}")
        emit({"phase": "enhance_profile", **profile_request(torch, request, total_s)})
        return launches
    finally:
        enh.dit2 = dit2 = None
        del enh
        parked_t5.__enter__()    # back on the card for the later phases
        parked_vace.__enter__()
        gc.collect()
        torch.cuda.empty_cache()


def run_entry_3d(torch, kernels, s: int):
    """The (BH, S, D) entry points, as a caller of them would drive them:
    `flash_attention_3d` without and with grad (K2, then K2 with stats and
    K3) and `flash_attention_int8_3d` (K7), at 40 heads of 128."""
    from video_styler_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator("cuda").manual_seed(6)
    q, k, v = ((torch.randn((40, s, 128), generator=gen, device="cuda")
                ).to(torch.bfloat16) for _ in range(3))
    for kern in kernels.values():
        kern.launches = 0
    out = fa.flash_attention_3d(q, k, v)
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(fa.flash_attention_3d(*ins), ins, out)
    out8 = fa.flash_attention_int8_3d(q, k, v)
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    expected = {"K2": 2, "K3": 1, "K7": 1}
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, out8) + grads)
    # the exact softmax and its int8 approximation on the same inputs
    cosine = torch.nn.functional.cosine_similarity(
        out.float().reshape(1, -1), out8.float().reshape(1, -1)).item()
    emit(dict(phase="entry_3d", shape=[40, s, 128], launches=launches,
              expected_launches=expected, finite=finite, int8_vs_bf16_cosine=cosine))
    if not finite or cosine < 0.99 or any(
            count != expected.get(name, 0) for name, count in launches.items()):
        raise AssertionError("entry_3d: launches, finiteness or int8 agreement")
    return launches


# ------------------------------------------------ image-conditioned phases

def check_image_references(torch):
    """`i2v_reference`: the FLF2V smoke recipe of `wan_video_gen` (a tiny
    CLIP tower, y, both images); `ti2v_reference`: the TI2V smoke recipe
    (the fused first frame on a tiny Wan2.2-family VAE). 9 frames, CFG 5
    two-pass, 2 steps, card against CPU on the same weights."""
    from video_styler_tpu_torch import wan_video_gen as G
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    for phase, name in (("i2v_reference", "Wan2.1-FLF2V-14B-720P"),
                        ("ti2v_reference", "Wan2.2-TI2V-5B")):
        recipe = G.RECIPES[name]
        cpu = G.build_smoke_pipeline(recipe, device="cpu", seed=0)
        gpu = card_copy(torch, cpu, WanVideoPipeline)
        h, w, _ = G.smoke_size(recipe)
        images = G.smoke_inputs(recipe, h, w, 9)
        kw = dict(prompt="a lighthouse in a storm", negative_prompt="blurry",
                  num_frames=9, height=h, width=w, seed=42, cfg_scale=5.0,
                  num_inference_steps=2, tiled=True, return_latents=True, **images)
        res, ok = check_card_against_cpu(torch, phase, cpu, gpu, lambda pipe: pipe(**kw),
                                         recipe=name, images=sorted(images), steps=2,
                                         cfg="two-pass 5.0")
        emit(res)
        if not ok:
            raise AssertionError(f"{name} smoke, card vs CPU disagree: {res}")


def check_fun_references(torch):
    """`fun_reference`: the Fun V1.1 Control (control video, reference
    image), V1.1 Control-Camera and speed-control smoke recipes of
    `wan_video_gen`; `animate_reference`: its Animate smoke recipe. 9
    frames of 32x32, CFG 5 two-pass, 2 steps, the recipe's smoke inputs,
    card against CPU on the same weights."""
    from video_styler_tpu_torch import wan_video_gen as G
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    for phase, name in (("fun_reference", "Wan2.1-Fun-V1.1-14B-Control"),
                        ("fun_reference", "Wan2.1-Fun-V1.1-14B-Control-Camera"),
                        ("fun_reference", "Wan2.1-1.3b-speedcontrol-v1"),
                        ("animate_reference", "Wan2.2-Animate-14B")):
        recipe = G.RECIPES[name]
        cpu = G.build_smoke_pipeline(recipe, device="cpu", seed=0)
        gpu = card_copy(torch, cpu, WanVideoPipeline)
        h, w, _ = G.smoke_size(recipe)
        inputs = G.smoke_inputs(recipe, h, w, 9)
        kw = dict(prompt="a lighthouse in a storm", negative_prompt="blurry",
                  num_frames=9, height=h, width=w, seed=42, cfg_scale=5.0,
                  num_inference_steps=2, tiled=True, return_latents=True, **inputs)
        res, ok = check_card_against_cpu(torch, phase, cpu, gpu, lambda pipe: pipe(**kw),
                                         recipe=name, inputs=sorted(inputs), steps=2,
                                         cfg="two-pass 5.0")
        emit(res)
        if not ok:
            raise AssertionError(f"{name} smoke, card vs CPU disagree: {res}")


def random_module(torch, cls, cfg, init, seed: int, dtype):
    """`cls(cfg)` on the card with random weights from `init` and a seed."""
    with torch.device("meta"):
        module = cls(cfg, dtype=dtype)
    return init(module.to_empty(device="cuda"),
                torch.Generator("cuda").manual_seed(seed)).eval()


def gib(modules) -> float:
    return sum(t.numel() * t.element_size() for m in modules
               for t in list(m.parameters()) + list(m.buffers())) / 2**30


def run_image_request(torch, pipe, kernels, phase: str, steps: int, request: dict,
                      profile: bool = False, **extra):
    """One request of `pipe` with every launch count set to 0 just before
    and read just after; K1 runs per block and CFG pass once for
    self-attention, once for the text and once more for an image branch,
    K4 and K5 once. Returns (result, output, launches)."""
    cfg = pipe.dit.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    out = pipe(**request)
    total_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    forwards = 2 * steps
    expected = {"K1": (3 if cfg.has_image_input else 2) * cfg.num_layers * forwards,
                "K4": cfg.num_layers * forwards, "K5": cfg.num_layers * forwards}
    res = dict(phase=phase, dit_dim=cfg.dim, dit_heads=cfg.num_heads,
               dit_layers=cfg.num_layers, frames=request["num_frames"],
               height=request["height"], width=request["width"], steps=steps,
               cfg="two-pass 5.0", total_s=total_s, stages=dict(pipe.stage_times),
               step_s=step_times(pipe),
               stage_peak_gib={k: v / 2**30 for k, v in pipe.stage_peak_bytes},
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               output_shape=list(out.shape), launches=launches, expected_launches=expected,
               launches_per_two_pass_step={k: v / steps for k, v in launches.items() if v},
               **extra)
    emit(res)
    check_launches(launches, expected, phase)
    if profile:
        emit({"phase": f"{phase}_profile",
              **profile_request(torch, lambda: pipe(**request), total_s)})
    return res, out, launches


def run_i2v(torch, pipe, kernels, frames: int, steps: int):
    """Wan2.1-I2V-14B-480P at full width on the card: a random
    `WAN_I2V_14B` DiT (seed 2) and `CLIP_VIT_H_14` tower (seed 3) beside
    the loaded umT5-XXL and Wan2.1 VAE; the --frames 480x832 clip's first
    frame as the image, --steps steps, CFG 5 two-pass; profiled. Then an
    FLF2V request (a random 514-row position table, the clip's last frame
    as the end image), the Fun and Animate requests on the same trunk
    (`run_fun`, `run_animate`), and a dual-expert request of 2 steps (t =
    1000 on `dit`, 833 on a second I2V expert from seed 5 below
    switch_DiT_boundary 0.875; its latents, not decoded) with umT5 and CLIP
    parked on the host. The caller has freed the VACE pipeline's DiT and
    VACE. Returns the launches of the I2V request and of the Fun and the
    Animate runs by path."""
    import dataclasses
    from video_styler_tpu_torch.models.clip_vit import CLIP_VIT_H_14, ClipVit, init_clip_vit_
    from video_styler_tpu_torch.models.wan_dit import WAN_I2V_14B, WanDiT, init_weights_
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.train import HostParked

    before_gib = torch.cuda.memory_allocated() / 2**30
    ip = WanVideoPipeline(device="cuda")
    ip.vae, ip.prompter = pipe.vae, pipe.prompter
    t0 = time.perf_counter()
    ip.dit = random_module(torch, WanDiT, WAN_I2V_14B, init_weights_, 2, torch.bfloat16)
    ip.image_encoder = random_module(torch, ClipVit, CLIP_VIT_H_14, init_clip_vit_, 3,
                                     torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    video = synthetic_clip(frames)
    base = dict(prompt="the camera slowly pushes in as the light changes",
                negative_prompt="blurry, static", height=480, width=832, num_frames=frames,
                seed=42, cfg_scale=5.0, num_inference_steps=steps, tiled=True)
    path = {}
    params_b = sum(p.numel() for p in ip.dit.parameters()) / 1e9
    res, out, path["i2v"] = run_image_request(
        torch, ip, kernels, "i2v", steps, dict(base, input_image=video[0]), profile=True,
        tokens=int(math.prod(token_grid(frames))), dit_params_b=params_b,
        dit_gib=gib([ip.dit]), clip_gib=gib([ip.image_encoder]),
        allocated_before_build_gib=before_gib, build_s=build_s,
        weights_on_card_gib=torch.cuda.memory_allocated() / 2**30)
    if out.shape != (frames, 480, 832, 3):
        raise AssertionError(f"i2v output shape {out.shape}")

    # FLF2V: the same trunk with the CLIP position table of two images
    gen = torch.Generator("cuda").manual_seed(4)
    ip.dit.img_emb.emb_pos = torch.nn.Parameter(
        (torch.randn((1, 2 * CLIP_ROWS, 1280), generator=gen, device="cuda")
         / math.sqrt(1280)).to(torch.bfloat16))
    ip.dit.cfg = dataclasses.replace(WAN_I2V_14B, has_image_pos_emb=True)
    try:
        _, out, _ = run_image_request(
            torch, ip, kernels, "i2v_flf2v", steps,
            dict(base, input_image=video[0], end_image=video[-1]),
            text_branch_keys=FLF2V_TEXT_ROWS, image_branch_keys=CLIP_ROWS)
    finally:
        del ip.dit.img_emb.emb_pos
        ip.dit.cfg = WAN_I2V_14B
    if out.shape != (frames, 480, 832, 3):
        raise AssertionError(f"flf2v output shape {out.shape}")

    # the Fun and Animate models on the same trunk
    path["fun"] = run_fun(torch, ip, kernels, video, base, steps)
    path["animate"] = run_animate(torch, ip, kernels, video, base, steps)

    # two I2V experts resident: umT5 and CLIP wait on the host between uses
    parked_t5 = HostParked(ip.prompter.text_encoder)
    parked_clip = HostParked(ip.image_encoder)

    def encode_prompt(prompt):
        with parked_t5:
            return WanVideoPipeline.encode_prompt(ip, prompt)

    def encode_clip(image_np):
        with parked_clip:
            return WanVideoPipeline.encode_clip(ip, image_np)
    ip.encode_prompt, ip.encode_clip = encode_prompt, encode_clip
    experts = []

    def expert(which):
        experts.append(which)
        return WanVideoPipeline._expert(ip, which)
    ip._expert = expert
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ip.dit2 = random_module(torch, WanDiT, WAN_I2V_14B, init_weights_, 5, torch.bfloat16)
        torch.cuda.synchronize()
        dit2_s = time.perf_counter() - t0
        res, out, _ = run_image_request(
            torch, ip, kernels, "i2v_dual_expert", 2,
            dict(base, input_image=video[0], num_inference_steps=2, return_latents=True),
            parked_on_host=["umT5", "CLIP"], dit2_build_s=dit2_s,
            weights_on_card_gib=torch.cuda.memory_allocated() / 2**30,
            experts_per_forward=experts, switch_DiT_boundary=0.875,
            timesteps=[float(t) for t in ip.scheduler.timesteps])
        if experts != ["dit", "dit", "dit2", "dit2"] or not torch.isfinite(out.float()).all():
            raise AssertionError(f"dual-expert I2V: experts {experts}, shape {out.shape}")
    finally:
        ip.dit = ip.dit2 = ip.image_encoder = None
        parked_t5.__enter__()    # umT5 back on the card for the TI2V phase
        del ip, parked_clip
        gc.collect()
        torch.cuda.empty_cache()
    return path


def _summed(total: dict, launches: dict):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def run_fun(torch, ip, kernels, video, base: dict, steps: int):
    """Wan2.1-Fun-14B on the I2V pipeline's `WAN_I2V_14B` trunk (random
    weights): InP with the clip's first and last frames; V1.1 Control with
    a random 48-channel patch embedding (16 latent + 16 control + 16 y
    channels) and `ref_conv` (seed 8), the clip as the control video and
    its first frame as the reference image (CLIP features of the
    reference); V1.1 Control-Camera with a random SimpleAdapter (24 ->
    5120, seed 9), the camera moving left (the DiT takes 36 channels, so
    the camera unit builds the I2V y). The trunk is restored after each.
    Returns the three requests' launches summed."""
    import dataclasses
    from video_styler_tpu_torch.models.wan_controllers import (SimpleAdapter,
                                                               init_simple_adapter_)
    from video_styler_tpu_torch.models.wan_dit import WAN_I2V_14B, Linear, init_weights_
    dit = ip.dit
    frames = base["num_frames"]
    f, h, w = token_grid(frames)
    total = {}

    def check(out, name):
        if out.shape != (frames, 480, 832, 3):
            raise AssertionError(f"{name} output shape {out.shape}")

    _, out, launches = run_image_request(
        torch, ip, kernels, "fun_inp", steps,
        dict(base, input_image=video[0], end_image=video[-1]),
        recipe="Wan2.1-Fun-14B-InP", tokens=f * h * w)
    check(out, "fun_inp")
    _summed(total, launches)

    gen = torch.Generator("cuda").manual_seed(8)

    def linear(cin, cout):
        with torch.device("meta"):
            lin = Linear(cin, cout, dtype=torch.bfloat16)
        return init_weights_(lin.to_empty(device="cuda"), gen)
    patch36 = dit.patch_embedding
    dit.patch_embedding = linear(48 * 4, dit.cfg.dim)
    dit.ref_conv = linear(16 * 4, dit.cfg.dim)
    dit.cfg = dataclasses.replace(WAN_I2V_14B, in_dim=48, has_ref_conv=True)
    try:
        _, out, launches = run_image_request(
            torch, ip, kernels, "fun_control_reference", steps,
            dict(base, control_video=video, reference_image=video[0]),
            recipe="Wan2.1-Fun-V1.1-14B-Control", tokens=(f + 1) * h * w,
            patch_embedding_in=48 * 4)
    finally:
        dit.patch_embedding = patch36
        del dit.ref_conv
        dit.cfg = WAN_I2V_14B
    check(out, "fun_control_reference")
    _summed(total, launches)

    adapter = random_module(torch, lambda cfg, dtype: SimpleAdapter(24, cfg, dtype=dtype),
                            dit.cfg.dim, init_simple_adapter_, 9, torch.bfloat16)
    dit.control_adapter = adapter
    dit.cfg = dataclasses.replace(WAN_I2V_14B, has_control_adapter=True)
    try:
        _, out, launches = run_image_request(
            torch, ip, kernels, "fun_camera", steps,
            dict(base, input_image=video[0], camera_control_direction="Left"),
            recipe="Wan2.1-Fun-V1.1-14B-Control-Camera", tokens=f * h * w,
            adapter_gib=gib([adapter]))
    finally:
        del dit.control_adapter
        dit.cfg = WAN_I2V_14B
        del adapter
        torch.cuda.empty_cache()
    check(out, "fun_camera")
    _summed(total, launches)
    return total


def run_animate(torch, ip, kernels, video, base: dict, steps: int):
    """Wan2.2-Animate-14B on the I2V trunk: a random `WAN_ANIMATE_14B`
    adapter (seed 10), the clip's last 4k - 3 frames as the pose video and
    the same frames rendered at 512x512 as the face video (one pose latent
    and one motion frame per latent frame after the first). Before the request,
    the adapter's stage (pose tokens, the motion encoder on the faces, the
    face encoder) and one face block are timed apart, synchronised."""
    from video_styler_tpu_torch import wan_video_gen as G
    from video_styler_tpu_torch.models import wan_animate as A
    frames = base["num_frames"]
    f, h, w = token_grid(frames)
    t0 = time.perf_counter()
    ip.animate = random_module(torch, A.WanAnimateAdapter, A.WAN_ANIMATE_14B,
                               A.init_wan_animate_, 10, torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pose = G.animate_clip(video)
    faces = G.animate_clip(synthetic_clip(frames, 512, 512))
    try:
        pose_lat, face_values = ip.build_animate_inputs(pose, faces, tiled=True)
        gen = torch.Generator("cuda").manual_seed(11)
        tokens = torch.randn((1, f * h * w, ip.dit.cfg.dim), generator=gen,
                             device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            _, motion_vec = A.animate_after_patch_embedding(ip.animate, tokens, (f, h, w),
                                                            pose_lat, face_values)
            adapter_ms = time_ms(torch, lambda: A.animate_after_patch_embedding(
                ip.animate, tokens, (f, h, w), pose_lat, face_values), reps=3, warmup=1)
            face_block_ms = time_ms(torch, lambda: A.face_block(
                ip.animate.face_adapter.fuser_blocks[0], tokens, motion_vec,
                ip.dit.cfg.num_heads), reps=5, warmup=1)
        del tokens
        _, out, launches = run_image_request(
            torch, ip, kernels, "animate", steps,
            dict(base, input_image=video[0], animate_pose_video=pose,
                 animate_face_video=faces),
            recipe="Wan2.2-Animate-14B", tokens=f * h * w, adapter_build_s=build_s,
            adapter_gib=gib([ip.animate]), adapter_stage_ms=adapter_ms,
            face_block_ms=face_block_ms, face_blocks=len(ip.animate.face_adapter.fuser_blocks),
            pose_latents_shape=list(pose_lat.shape), face_frames=len(faces),
            motion_tokens_shape=list(motion_vec.shape))
        if out.shape != (frames, 480, 832, 3):
            raise AssertionError(f"animate output shape {out.shape}")
        return launches
    finally:
        ip.animate = None
        gc.collect()
        torch.cuda.empty_cache()


def run_speed(torch, pipe, kernels, frames: int, steps: int):
    """Wan2.1-T2V-1.3B with the speed controller at full width: a random
    `WAN_T2V_1_3B` DiT (seed 12) and controller (seed 13; its last layer
    drawn N(0, 1/dim), not the reference's zeros, so the id acts) beside the
    loaded umT5 and VAE; the --frames clip's request, motion id 50,
    counted and profiled; then the latents of ids 50 and 10 must differ."""
    from video_styler_tpu_torch.models.wan_controllers import (MotionController,
                                                               init_motion_controller_)
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_1_3B, WanDiT, init_weights_
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    sp = WanVideoPipeline(device="cuda")
    sp.vae, sp.prompter = pipe.vae, pipe.prompter
    t0 = time.perf_counter()
    sp.dit = random_module(torch, WanDiT, WAN_T2V_1_3B, init_weights_, 12, torch.bfloat16)
    mc = random_module(torch, lambda cfg, dtype: MotionController(*cfg, dtype=dtype),
                       (WAN_T2V_1_3B.dim, WAN_T2V_1_3B.freq_dim), init_motion_controller_,
                       13, torch.bfloat16)
    with torch.no_grad():
        mc.fc3.weight.normal_(0.0, WAN_T2V_1_3B.dim ** -0.5,
                              generator=torch.Generator("cuda").manual_seed(14))
    sp.motion_controller = mc
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    request = dict(prompt="a train rushes through a snowy valley",
                   negative_prompt="blurry, static", height=480, width=832,
                   num_frames=frames, seed=42, cfg_scale=5.0, num_inference_steps=steps,
                   tiled=True, motion_bucket_id=50.0)
    try:
        _, out, launches = run_image_request(
            torch, sp, kernels, "speed", steps, request, profile=True,
            recipe="Wan2.1-1.3b-speedcontrol-v1",
            tokens=int(math.prod(token_grid(frames))), build_s=build_s,
            dit_params_b=sum(p.numel() for p in sp.dit.parameters()) / 1e9,
            dit_gib=gib([sp.dit]), controller_gib=gib([mc]))
        if out.shape != (frames, 480, 832, 3):
            raise AssertionError(f"speed output shape {out.shape}")
        lat = {mid: sp(**dict(request, motion_bucket_id=mid, return_latents=True)).float()
               for mid in (50.0, 10.0)}
        rel = ((lat[50.0] - lat[10.0]).norm() / lat[50.0].norm()).item()
        res = dict(phase="speed_check", motion_ids=[50.0, 10.0], latents_rel_l2_between=rel,
                   finite=all(bool(torch.isfinite(v).all()) for v in lat.values()))
        emit(res)
        if not (res["finite"] and rel > 1e-3):
            raise AssertionError(f"speed control: {res}")
        return launches
    finally:
        sp.dit = sp.motion_controller = None
        del sp, mc
        gc.collect()
        torch.cuda.empty_cache()


def run_ti2v(torch, pipe, kernels, steps: int):
    """Wan2.2-TI2V-5B at full width: a random `WAN_TI2V_5B` DiT (seed 6)
    and `WAN22_VAE` (seed 7, fp32) with the loaded umT5-XXL; the recipe's
    49 frames of 480x832 (5,070 tokens), the first frame as the image,
    `steps` steps, CFG 5 two-pass, streaming encode and decode. The image's
    latent (the pipeline's own encode, captured) must equal the first latent
    frame bit for bit after the loop."""
    from video_styler_tpu_torch.models import wan_vae as V
    from video_styler_tpu_torch.models.wan_dit import WAN_TI2V_5B, WanDiT, init_weights_
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline, _preprocess_images

    tp = WanVideoPipeline(device="cuda")
    tp.prompter = pipe.prompter
    t0 = time.perf_counter()
    tp.dit = random_module(torch, WanDiT, WAN_TI2V_5B, init_weights_, 6, torch.bfloat16)
    tp.vae = random_module(torch, V.WanVAE38, V.WAN22_VAE, V.init_wan_vae_, 7, torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    encodes = []

    def encode_video(video_np, **tiler):
        encodes.append(WanVideoPipeline.encode_video(tp, video_np, **tiler))
        return encodes[-1]
    tp.encode_video = encode_video
    image = synthetic_clip(TI2V_FRAMES)[0]
    request = dict(prompt="a paper boat drifts down a rainy street",
                   negative_prompt="blurry, static", input_image=image, height=480,
                   width=832, num_frames=TI2V_FRAMES, seed=42, cfg_scale=5.0,
                   num_inference_steps=steps, tiled=True, return_latents=True)
    try:
        res, lat, launches = run_image_request(
            torch, tp, kernels, "ti2v", steps, request,
            tokens=int(math.prod(TI2V_GRID)), build_s=build_s,
            dit_params_b=sum(p.numel() for p in tp.dit.parameters()) / 1e9,
            dit_gib=gib([tp.dit]), vae_gib=gib([tp.vae]))
        first = encodes[0]
        again = tp.encode_video(_preprocess_images([image]), tiled=True)
        with tp._stage("vae_decode"):
            frames = tp.vae_output_to_video(tp.decode_video(lat))
        check = dict(phase="ti2v_check", latents_shape=list(lat.shape),
                     first_frame_bit_equal_to_image_encode=bool(torch.equal(lat[:, :, :1],
                                                                            first)),
                     image_encode_repeats_bit_equal=bool(torch.equal(again, first)),
                     latents_finite=bool(torch.isfinite(lat.float()).all()),
                     decode_s=tp.stage_times[-1][1], frames_shape=list(frames.shape),
                     max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
        emit(check)
        if not (check["first_frame_bit_equal_to_image_encode"] and check["latents_finite"]
                and lat.shape == (1, 48, 13, 30, 52)
                and frames.shape == (TI2V_FRAMES, 480, 832, 3)):
            raise AssertionError(f"ti2v: {check}")
        return launches
    finally:
        tp.dit = tp.vae = None
        del tp, encodes
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------------ speech to video

def check_s2v_reference(torch):
    """`s2v_reference`: the S2V smoke recipe of `wan_video_gen` (a tiny S2V
    model, a tiny wav2vec2 tower from seed 5), a synthetic 16 kHz waveform
    through `extract_audio_features` on each device, 12 frames of 32x32
    with a 12-frame pose video, CFG 4.5 two-pass, 2 steps, whole-clip VAE:
    the audio features and the latents, card against CPU on the same
    weights."""
    import numpy as np
    from video_styler_tpu_torch import wan_video_gen as G
    from video_styler_tpu_torch.models import wav2vec as W
    from video_styler_tpu_torch.models.audio_features import extract_audio_features
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    recipe = G.RECIPES["Wan2.2-S2V-14B"]
    cpu = G.build_smoke_pipeline(recipe, device="cpu", seed=0)
    gpu = card_copy(torch, cpu, WanVideoPipeline)
    w2v_cpu = random_module(torch, W.Wav2Vec2, G.smoke_s2v_configs()[1], W.init_wav2vec_, 5,
                            torch.float32).cpu()
    w2v_gpu = copy.deepcopy(w2v_cpu).cuda()
    frames = S2V_RUN_FRAMES
    wav = G.smoke_waveform(frames)
    audio = {"cpu": extract_audio_features(wav, num_frames=frames, model=w2v_cpu),
             "cuda": extract_audio_features(wav, num_frames=frames, model=w2v_gpu)}
    audio_rel = float(np.linalg.norm(audio["cuda"] - audio["cpu"])
                      / np.linalg.norm(audio["cpu"]))
    clip = G.smoke_inputs(G.RECIPES["Wan2.1-VACE-14B"], 32, 32, frames)["vace_video"]
    # the pipeline's whole-clip VAE (`s2v`'s default): the streaming encoder
    # takes 4k + 1 frames, the 12-frame pose video is not
    kw = dict(negative_prompt="blurry", num_frames=frames, height=32, width=32, seed=42,
              cfg_scale=4.5, num_inference_steps=2, tiled=False, return_latents=True,
              pose_video=clip)
    res, ok = check_card_against_cpu(
        torch, "s2v_reference", cpu, gpu,
        lambda pipe: pipe.s2v("a woman sings on a rooftop", clip[0],
                              audio[pipe.device.type], **kw),
        recipe=recipe.name, frames=frames, steps=2, cfg="two-pass 4.5",
        audio_shape=list(audio["cpu"].shape), audio_rel_l2=audio_rel)
    emit(res)
    if not ok or not audio_rel <= 5e-2:
        raise AssertionError(f"S2V smoke, card vs CPU disagree: {res}")


def run_s2v(torch, pipe, kernels, steps: int):
    """Wan2.2-S2V-14B at full width on the card: a random `WAN_S2V_14B`
    (seed 20: the 40-block trunk, 12 audio injectors with their AdaLN, the
    audio encoder, the frame packer, `cond_encoder`) and `WAV2VEC2_XLSR_53`
    tower (seed 21, fp32) beside the loaded umT5-XXL and Wan2.1 VAE; 5 s of
    synthetic 16 kHz audio through the tower; a 12-frame 448x832 request
    (5,824 tokens; the reference image cut from `synthetic_clip`), `steps`
    steps, CFG 4.5 two-pass, counted and profiled; then one step at the
    recipe's 80 frames (30,576 tokens), latents only, counted. Returns the
    launches of both runs, summed."""
    import numpy as np
    from video_styler_tpu_torch import wan_video_gen as G
    from video_styler_tpu_torch.models import wan_s2v as S
    from video_styler_tpu_torch.models import wav2vec as W
    from video_styler_tpu_torch.models.audio_features import extract_audio_features
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    sp = WanVideoPipeline(device="cuda")
    sp.vae, sp.prompter = pipe.vae, pipe.prompter
    torch.cuda.synchronize()
    before_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    sp.s2v_model = random_module(torch, S.WanS2V, S.WAN_S2V_14B, S.init_wan_s2v_, 20,
                                 torch.bfloat16)
    w2v = random_module(torch, W.Wav2Vec2, W.WAV2VEC2_XLSR_53, W.init_wav2vec_, 21,
                        torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = sp.s2v_model
    trunk = ("patch_embedding", "text_embedding", "time_embedding", "time_projection",
             "head", "blocks")
    s2v_params = sum(p.numel() for n, p in model.named_parameters()
                     if n.split(".")[0] not in trunk)
    wav = G.smoke_waveform(64)          # 5 s: (64 / 16 + 1) s at 16 kHz
    cfg = S.WAN_S2V_14B
    per_step = {"K1": 2 * (2 * cfg.num_layers + len(cfg.audio_inject_layers)),
                "K4": 2 * cfg.num_layers,
                "K5": 2 * (cfg.num_layers + len(cfg.audio_inject_layers))}
    total = {}
    try:
        audio, wav2vec_s = {}, {}
        for frames in (S2V_RUN_FRAMES, S2V_RECIPE_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio[frames] = extract_audio_features(wav, num_frames=frames, model=w2v)
            torch.cuda.synchronize()
            wav2vec_s[frames] = time.perf_counter() - t0
        with torch.no_grad():
            states_ms = time_ms(torch, lambda: W.wav2vec_forward(
                w2v, torch.from_numpy(W.normalize_waveform(wav)[None]).cuda()), reps=3)
            a12 = torch.from_numpy(audio[S2V_RUN_FRAMES]).cuda().to(torch.bfloat16)
            encoder_ms = time_ms(torch, lambda: S.cal_audio_emb(
                model.casual_audio_encoder, a12, cfg.num_audio_token, cfg.enable_adain),
                reps=5)
        image = synthetic_clip(S2V_RUN_FRAMES, 448, 832)[0]
        request = dict(prompt="a woman sings on a rooftop at dusk", ref_image=image,
                       negative_prompt="blurry, static", num_frames=S2V_RUN_FRAMES,
                       height=448, width=832, seed=42, cfg_scale=4.5,
                       num_inference_steps=steps, tiled=True)
        runs = [("s2v", S2V_RUN_FRAMES, steps, False),
                ("s2v_recipe_frames", S2V_RECIPE_FRAMES, 1, True)]
        for phase, frames, n_steps, latents_only in runs:
            kw = dict(request, audio_input=audio[frames], num_frames=frames,
                      num_inference_steps=n_steps, return_latents=latents_only)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kern in kernels.values():
                kern.launches = 0
            t0 = time.perf_counter()
            out = sp.s2v(**kw)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            launches = {name: kern.launches for name, kern in kernels.items()}
            expected = {k: v * n_steps for k, v in per_step.items()}
            f_lat = (frames - 1) // 4 + 1
            res = dict(phase=phase, recipe="Wan2.2-S2V-14B", dim=cfg.dim,
                       heads=cfg.num_heads, layers=cfg.num_layers,
                       audio_injections=len(cfg.audio_inject_layers), frames=frames,
                       height=448, width=832, tokens=int(math.prod(s2v_grid(frames))),
                       steps=n_steps, cfg="two-pass 4.5", total_s=total_s,
                       stages=dict(sp.stage_times), step_s=step_times(sp),
                       stage_peak_gib={k: v / 2**30 for k, v in sp.stage_peak_bytes},
                       max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                       output_shape=list(out.shape), launches=launches,
                       expected_launches=expected,
                       launches_per_two_pass_step={k: v / n_steps for k, v in launches.items()
                                                   if v},
                       finite=bool(np.isfinite(out).all()) if isinstance(out, np.ndarray)
                       else bool(torch.isfinite(out.float()).all()),
                       wav2vec_s=wav2vec_s[frames], wav2vec_forward_ms=states_ms,
                       audio_shape=list(audio[frames].shape), audio_seconds=len(wav) / 16000,
                       audio_encoder_ms=encoder_ms, build_s=build_s,
                       s2v_params_b=s2v_params / 1e9, model_gib=gib([model]),
                       wav2vec_gib=gib([w2v]), allocated_before_build_gib=before_gib)
            emit(res)
            check_launches(launches, expected, phase)
            want = ((1, 16, f_lat, 56, 104) if latents_only
                    else (1 + (f_lat - 1) * 4, 448, 832, 3))
            if tuple(out.shape) != want or not res["finite"]:
                raise AssertionError(f"{phase}: output {tuple(out.shape)}, want {want}")
            _summed(total, launches)
            if phase == "s2v":
                emit({"phase": "s2v_profile",
                      **profile_request(torch, lambda: sp.s2v(**kw), total_s)})
        return total
    finally:
        sp.s2v_model = None
        del sp, model, w2v
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------------- post-processing

FASTBLEND_SRC = "video_styler_tpu_torch/csrc/fastblend.cu"
JAX_FASTBLEND = "video_styler_tpu/extensions/fastblend/kernels.py"
# fp32, summed in the plain versions' order without FMA contraction: the
# kernels agree bit for bit; 2^-20 of the largest magnitude is the bound
FASTBLEND_TOL = 2.0 ** -20
POST_FRAMES = 9              # synthetic_clip(9) at 480x832
POST_PROMPT = "a watercolor city at dusk"
# OpenAI CLIP ViT-L/14 (the aesthetic head's 768-wide features, CLIP score)
CLIP_VIT_L_14 = dict(vision_dim=1024, vision_layers=24, vision_heads=16, text_dim=768,
                     text_layers=12, text_heads=12, proj_dim=768, quick_gelu=True)


def coherent_nnf(torch, gen, b: int, h: int, w: int, spread: int = 4):
    """A field like PatchMatch's: identity plus offsets up to +-spread,
    clamped to the image."""
    ii, jj = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"),
                            indexing="ij")
    off = torch.randint(-spread, spread + 1, (b, h, w, 2), generator=gen, device="cuda")
    return torch.stack([(ii + off[..., 0]).clamp(0, h - 1),
                        (jj + off[..., 1]).clamp(0, w - 1)], -1).to(torch.int32).contiguous()


def remap_votes(torch, nnf, h: int, w: int, r: int) -> int:
    """F1's data-dependent work: the votes that fall inside the image."""
    xx = torch.arange(h, device=nnf.device)[None, :, None]
    yy = torch.arange(w, device=nnf.device)[None, None, :]
    total = 0
    for px in range(-r, r + 1):
        for py in range(-r, r + 1):
            xn, yn = xx + px, yy + py
            inside = (xn >= 0) & (xn < h) & (yn >= 0) & (yn < w)
            m = nnf[:, xn.clamp(0, h - 1)[0, :, 0]][:, :, yn.clamp(0, w - 1)[0, 0]]
            xs, ys = m[..., 0] - px, m[..., 1] - py
            total += int((inside & (xs >= 0) & (ys >= 0) & (xs < h) & (ys < w)).sum())
    return total


def check_fastblend_kernels(torch, b: int = 8, h: int = 480, w: int = 832, c: int = 3,
                            pad: int = 6):
    """F1-F3 at the main path's top pyramid level (a batch of 8 pairs,
    480x832, pad 6; F3 on the even and odd halves of the batch, B = 4, as
    `PatchMatcher.get_pairwise_patch_error` passes them) with patch 13 (the
    first iteration) and 5 (the last), on a coherent field, against their
    plain versions. The bound: fp32
    operations (a sub, a mul and an add per channel and patch tap; F1 an
    add per channel and vote) at the card's fp32 rate without the tensor
    cores, against each input read once and the output written once."""
    from torch.nn.functional import pad as fpad
    from video_styler_tpu_torch.extensions.fastblend import kernels as fk
    gen = torch.Generator("cuda").manual_seed(11)
    imgs = [fpad(torch.rand((b, h, w, c), generator=gen, device="cuda") * 255,
                 (0, 0, pad, pad, pad, pad)) for _ in range(2)]
    src, tgt = imgs
    nnf = coherent_nnf(torch, gen, b, h, w)
    pair = (src[0::2].contiguous(), nnf[0::2].contiguous(), src[1::2].contiguous(),
            nnf[1::2].contiguous())
    img_bytes, nnf_bytes, err_bytes = src.numel() * 4, nnf.numel() * 4, b * h * w * 4
    rows = []
    for ps in (13, 5):
        r, args = (ps - 1) // 2, (h, w, c, ps, pad)
        ssd_flops = b * h * w * ps * ps * 3 * c
        cases = (
            ("F1", "remap", b, "12remap_kernel", 104, lambda: fk.remap(*args, src, nnf),
             lambda: fk.remap_plain(*args, src, nnf),
             remap_votes(torch, nnf, h, w, r) * c + b * h * w * c, 2 * img_bytes + nnf_bytes),
            ("F2", "patch_error", b, "18patch_error_kernel", 139,
             lambda: fk.patch_error(*args, src, nnf, tgt),
             lambda: fk.patch_error_plain(*args, src, nnf, tgt), ssd_flops,
             2 * img_bytes + nnf_bytes + err_bytes),
            ("F3", "pairwise_patch_error", b // 2, "pairwise_patch_error_kernel", 156,
             lambda: fk.pairwise_patch_error(*args, *pair),
             lambda: fk.pairwise_patch_error_plain(*args, *pair), ssd_flops // 2,
             img_bytes + nnf_bytes + err_bytes // 2))
        for kid, fn, batch, sym, line, run, plain, flops, nbytes in cases:
            err, scale = max_err(torch, run(), plain())
            t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            rows.append(dict(
                name=f"{kid} {fn} B={batch} {h}x{w} C={c} patch={ps} pad={pad}", kernel=kid,
                route="cuda", source=FASTBLEND_SRC, replaces=f"{JAX_FASTBLEND}:{line}",
                max_abs_err=err, max_rel_err=err / scale, tol=FASTBLEND_TOL * scale,
                ms=time_ms(torch, run, 10), plain_ms=time_ms(torch, plain, reps=2, warmup=1),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None,
                fp32_gflop=flops / 1e9, mbytes=nbytes / 1e6, ptxas=kernel_usage(sym),
                clocks=gpu_clocks()))
    return emit_rows(rows)


class StubMetricTokenizer:
    """Token ids from a seed of the text (crc32): `length` ids, the EOS id
    last; no vocabulary is on the machine."""

    def __init__(self, vocab: int, eos: int, length: int):
        self.vocab, self.eos, self.length = vocab, eos, length

    def __call__(self, texts, max_length=None, **kw):
        import zlib
        import numpy as np
        n = min(self.length, max_length or self.length)
        rng = np.random.default_rng(zlib.crc32(texts[0].encode()))
        ids = rng.integers(2, self.vocab - 1, (len(texts), n)).astype(np.int64)
        ids[:, -1] = self.eos
        return {"input_ids": ids, "attention_mask": np.ones_like(ids)}


def random_tower(torch, cls, cfg, seed: int, device: str):
    """`cls(cfg)` in fp32 with random weights: matrices N(0, 1/in), norms 1,
    biases 0, embeddings and tokens N(0, 0.02^2), logit_scale log 100."""
    with torch.device("meta"):
        module = cls(cfg)
    module = module.to_empty(device=device)
    gen = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("scale",)):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif p.dim() == 2 and name.endswith("weight"):
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
            else:
                p.normal_(0.0, 0.02, generator=gen)
        if hasattr(module, "logit_scale"):
            module.logit_scale.fill_(math.log(100.0))
    return module.eval()


def random_conv_weights(shapes, seed: int):
    """A checkpoint's tensors from a numpy seed: convolutions N(0, 1/fan_in),
    PReLU slopes 0.25, biases N(0, 0.01^2)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in shapes.items():
        if len(shape) > 1:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith(".1.weight"):
            v = np.full(shape, 0.25)
        else:
            v = 0.01 * rng.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    return sd


def post_models(torch, device: str, full: bool):
    """The chain's random weights on `device`: full IFNet width (c=90)
    always; RRDBNet with 23 blocks (full) or 2; the metric towers at their
    published widths (full) or the tiny configs."""
    from video_styler_tpu_torch.extensions import esrgan, rife
    from video_styler_tpu_torch.models import blip_reward as B
    from video_styler_tpu_torch.models import clip_dual as C
    blocks = 23 if full else 2
    cfg_h = C.CLIP_VIT_H_14_DUAL if full else C.CLIP_DUAL_TINY
    cfg_l = C.CLIPDualConfig(**CLIP_VIT_L_14) if full else C.CLIP_DUAL_TINY
    cfg_b = B.IMAGE_REWARD if full else B.BLIP_REWARD_TINY
    cross = C.MPS_CROSS if full else C.CrossModelConfig(dim=cfg_h.proj_dim, heads=2)
    import numpy as np
    rng = np.random.default_rng(30)
    dims = (cfg_l.proj_dim, 1024, 128, 64, 16, 1)
    aes = {str(i): {"w": torch.from_numpy((rng.standard_normal((b, a)) / np.sqrt(a))
                                          .astype(np.float32)).to(device),
                    "b": torch.zeros(b, device=device)}
           for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    return dict(
        ifnet=rife.convert_ifnet(random_conv_weights(rife.ifnet_shapes(), 31), device),
        rrdb=esrgan.convert_rrdbnet(random_conv_weights(esrgan.rrdbnet_shapes(blocks), 32),
                                    device),
        rrdb_blocks=blocks, aes=aes,
        clip_l=random_tower(torch, C.ClipDual, cfg_l, 33, device),
        clip_h=random_tower(torch, C.ClipDual, cfg_h, 34, device),
        cross=random_tower(torch, C.CrossModel, cross, 35, device),
        blip=random_tower(torch, B.BlipReward, cfg_b, 36, device),
        cfg_l=cfg_l, cfg_h=cfg_h, cfg_b=cfg_b, cross_heads=cross.heads)


def score_metrics(torch, m, images, seconds: dict):
    """The six metrics of `extensions.image_quality_metric` on `images`
    (uint8 frames) with `m`'s towers and stub token ids; `seconds` gets
    each metric's wall time."""
    import numpy as np
    from video_styler_tpu_torch.extensions import image_quality_metric as Q
    from video_styler_tpu_torch.models import clip_dual as C
    dev = m["clip_h"].logit_scale.device
    cfg_l, cfg_h, cfg_b = m["cfg_l"], m["cfg_h"], m["cfg_b"]
    tok_l = StubMetricTokenizer(cfg_l.vocab_size, cfg_l.eos_token_id, cfg_l.max_len)
    tok_h = StubMetricTokenizer(cfg_h.vocab_size, cfg_h.eos_token_id, cfg_h.max_len)
    tok_b = StubMetricTokenizer(cfg_b.vocab_size, cfg_b.vocab_size - 1, min(35, cfg_b.max_pos))

    def image_l(ims):
        pix = np.stack([Q.preprocess_metric_image(im, cfg_l.image_size) for im in ims])
        return C.clip_image_features(m["clip_l"], cfg_l, torch.from_numpy(pix).to(dev))

    def text_l(texts):
        return C.clip_text_features(m["clip_l"], cfg_l, tok_l(texts)["input_ids"]).cpu()

    metrics = {
        "aesthetic": lambda: Q.AestheticPredictor(m["aes"], image_l).score(images),
        "clip": lambda: Q.CLIPScore(lambda ims: image_l(ims).cpu(), text_l).score(
            images, POST_PROMPT),
        "pickscore": lambda: Q.PickScore(m["clip_h"], cfg_h, tok_h).score(images, POST_PROMPT),
        "hps": lambda: Q.HPScore(m["clip_h"], cfg_h, tok_h).score(images, POST_PROMPT),
        "mps": lambda: Q.MPScore(m["clip_h"], m["cross"], cfg_h, tok_h,
                                 cross_heads=m["cross_heads"]).score(images, POST_PROMPT),
        "imagereward": lambda: Q.ImageRewardScore(m["blip"], cfg_b, tok_b).score(
            images, POST_PROMPT)}
    scores = {}
    with torch.no_grad():
        for name, fn in metrics.items():
            t0 = time.perf_counter()
            scores[name] = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
    return scores


def run_chain(torch, m, frames, device: str, seconds: dict, peaks: dict,
              kernels=None, counts=None):
    """FastBlend balanced (FastBlendSmoother's defaults) -> RIFE 2x -> ESRGAN
    x4 -> the six metrics, through the extensions' entry points on
    `device`, stage by stage: `seconds` and `peaks` (device GiB) get each
    stage's; with `kernels`, every count is set to 0 before a stage and
    read after it into `counts`."""
    from video_styler_tpu_torch.extensions import esrgan, rife
    from video_styler_tpu_torch.extensions.fastblend import FastBlendSmoother
    cuda = device == "cuda"
    stages = (
        ("fastblend", lambda x: FastBlendSmoother(device=device)(x)),
        ("rife", lambda x: rife.RIFEInterpolater(m["ifnet"], device=device).interpolate(x)),
        ("esrgan", lambda x: esrgan.ESRGANUpscaler(m["rrdb"], m["rrdb_blocks"],
                                                   device=device)(x)))
    outputs, x = {}, list(frames)
    for name, fn in stages + (("metrics", None),):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for kern in (kernels or {}).values():
            kern.launches = 0
        t0 = time.perf_counter()
        if fn is None:
            metric_s = {}
            outputs["scores"] = score_metrics(torch, m, x, metric_s)
            seconds["metric_s"] = metric_s
        else:
            x = outputs[name] = fn(x)
        if cuda:
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        seconds[name] = time.perf_counter() - t0
        if kernels is not None:
            counts[name] = {k: kern.launches for k, kern in kernels.items()}
    return outputs


def _rel_l2(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def check_postprocess_reference(torch):
    """`postprocess_reference`: the chain on 4 frames of 64x64 (FastBlend
    balanced with its defaults, RIFE at full IFNet width, ESRGAN with 2
    blocks, the six metrics at their tiny configs) on the card and on the
    CPU with the same weights: each stage's frames and the scores within 5%
    relative L2; and one pyramid estimate's share of NNF entries that differ
    between the card and the CPU."""
    import numpy as np
    from video_styler_tpu_torch.extensions.fastblend import (DEFAULT_EBSYNTH_CONFIG,
                                                             PyramidPatchMatcher)
    frames = synthetic_clip(4, 64, 64)
    cpu = post_models(torch, "cpu", full=False)
    gpu = {k: copy.deepcopy(v).to("cuda") if isinstance(v, torch.nn.Module)
           else _tree_to(v, "cuda") if isinstance(v, dict) else v for k, v in cpu.items()}
    runs = {}
    for dev, m in (("cpu", cpu), ("cuda", gpu)):
        seconds = {}
        runs[dev] = (run_chain(torch, m, frames, dev, seconds, {}), seconds)
    (c, c_s), (g, g_s) = runs["cpu"], runs["cuda"]
    rel = {k: _rel_l2(np.stack(g[k]), np.stack(c[k])) for k in ("fastblend", "rife", "esrgan")}
    rel.update({f"score_{k}": _rel_l2(g["scores"][k], v) for k, v in c["scores"].items()})
    nnf = {}
    for dev in ("cpu", "cuda"):
        pm = PyramidPatchMatcher(64, 64, 3, device=dev, **DEFAULT_EBSYNTH_CONFIG)
        nnf[dev] = pm.estimate_nnf(frames[:3], frames[1:], frames[:3])[0].cpu().numpy()
    res = dict(phase="postprocess_reference", frames=4, height=64, width=64,
               rel_l2=rel, tol=5e-2, cpu_s=c_s, cuda_s=g_s,
               nnf_entries_differ_share=float((nnf["cpu"] != nnf["cuda"]).any(-1).mean()),
               output_shapes={k: list(np.stack(g[k]).shape)
                              for k in ("fastblend", "rife", "esrgan")},
               scores_cuda=g["scores"])
    emit(res)
    finite = all(np.isfinite(v).all() for v in g["scores"].values())
    if not (finite and all(v <= 5e-2 for v in rel.values())):
        raise AssertionError(f"postprocess, card vs CPU disagree: {res}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def fastblend_launches(estimates: int, cfg: dict, pairwise: bool = False, levels: int = 5):
    """F1/F2/F3 launches of `estimates` pyramid estimates, derived from the
    config: per level and iteration one remap and a guide and a style error
    for the start and for each update (4 propagation directions, 3 random
    steps, no tracking); one more remap per level. With the pairwise flag
    the style error is F3's."""
    errors = estimates * levels * cfg["num_iter"] * (1 + 4 + 3)
    out = {"F1": estimates * levels * (cfg["num_iter"] + 1),
           "F2": errors * (1 if pairwise else 2)}
    if pairwise:
        out["F3"] = errors
    return out


def balanced_tasks(n: int, window: int = 15) -> int:
    """Source -> target pairs of FastBlend balanced over n frames."""
    return sum(1 for t in range(n) for s in range(t - window, t + window + 1)
               if 0 <= s < n and s != t)


def frame_change(frames) -> float:
    """Mean absolute change between consecutive frames (flicker)."""
    import numpy as np
    f = np.stack(frames).astype(np.float32)
    return float(np.abs(f[1:] - f[:-1]).mean())


def run_postprocess(torch, kernels):
    """`postprocess`: the chain at the published widths on synthetic_clip(9)
    at 480x832, counted stage by stage: FastBlend balanced (window 15,
    batch 8, patch 5..13 over 5 iterations, 5 pyramid levels: 72 pairs in 9
    batches) with its F1/F2 launches against the derived counts; RIFE 2x
    (9 -> 17 frames) with random full-width IFNet weights; ESRGAN x4 (23
    RRDBs, fp32) to 1920x3328 on all 17 frames; the six metrics on them at
    full width (CLIP ViT-H/14 dual for PickScore, HPS and MPS with the
    4-layer cross model, ViT-L/14 for the 768-wide aesthetic head and the
    CLIP score, BLIP ViT-L + BERT-base for ImageReward). Then one FastBlend
    batch profiled, and one pyramid estimate with use_pairwise_patch_error
    (F3) counted. Returns the F1-F3 launches of the counted runs."""
    import numpy as np
    from video_styler_tpu_torch.extensions.fastblend import (DEFAULT_EBSYNTH_CONFIG,
                                                             PyramidPatchMatcher)
    from video_styler_tpu_torch.extensions.fastblend import patch_match as pm_mod
    frames = list(synthetic_clip(POST_FRAMES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    models = post_models(torch, "cuda", full=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model_gib = gib([models[k] for k in ("clip_l", "clip_h", "cross", "blip")])
    # host time of the random-search draws (numpy, then pinned, then copied)
    draw = {"calls": 0, "s": 0.0}
    original_draw = pm_mod._draw_to

    def timed_draw(*a, **k):
        t = time.perf_counter()
        out = original_draw(*a, **k)
        draw["s"] += time.perf_counter() - t
        draw["calls"] += 1
        return out

    seconds, peaks, counts = {}, {}, {}
    pm_mod._draw_to = timed_draw
    try:
        out = run_chain(torch, models, frames, "cuda", seconds, peaks, kernels, counts)
    finally:
        pm_mod._draw_to = original_draw
    tasks = balanced_tasks(POST_FRAMES)
    batches = -(-tasks // 8)
    expected = fastblend_launches(batches, DEFAULT_EBSYNTH_CONFIG)
    shapes = {k: list(np.stack(out[k]).shape) for k in ("fastblend", "rife", "esrgan")}
    res = dict(phase="postprocess", frames=POST_FRAMES, height=480, width=832,
               fastblend=dict(window=15, batch=8, **DEFAULT_EBSYNTH_CONFIG, tasks=tasks,
                              batches=batches, pyramid_levels=5),
               rife_ifnet_width=90, esrgan_blocks=23, esrgan_frames=len(out["rife"]),
               stage_s=seconds, stage_peak_gib=peaks, build_s=build_s,
               metric_model_gib=model_gib, output_shapes=shapes,
               frame_change_before=frame_change(frames),
               frame_change_after_fastblend=frame_change(out["fastblend"]),
               random_draws=draw["calls"], random_draw_host_s=draw["s"],
               scores=out["scores"], launches=counts, expected_fastblend_launches=expected)
    emit(res)
    check_launches(counts["fastblend"], expected, "postprocess fastblend")
    for stage in ("rife", "esrgan", "metrics"):
        check_launches(counts[stage], {}, f"postprocess {stage}")
    want = {"fastblend": [POST_FRAMES, 480, 832, 3], "rife": [2 * POST_FRAMES - 1, 480, 832, 3],
            "esrgan": [2 * POST_FRAMES - 1, 1920, 3328, 3]}
    finite = all(np.isfinite(v).all() and len(v) == want["esrgan"][0]
                 for v in out["scores"].values())
    if shapes != want or not finite:
        raise AssertionError(f"postprocess outputs {shapes}, want {want}; finite {finite}")
    launches = {k: counts["fastblend"][k] for k in ("F1", "F2")}
    del out, models
    gc.collect()
    torch.cuda.empty_cache()

    # one batch of 8 pairs, profiled: the FastBlend stage's device share
    # (the frames already on the card, as the runner holds them)
    engine = PyramidPatchMatcher(480, 832, 3, device="cuda", **DEFAULT_EBSYNTH_CONFIG)
    clip = torch.from_numpy(np.stack(frames)).cuda().float()
    sg, tg = clip[:8], clip[1:]

    def one_batch():
        engine.estimate_nnf(sg, tg, sg)
        torch.cuda.synchronize()

    one_batch()
    t0 = time.perf_counter()
    one_batch()
    batch_s = time.perf_counter() - t0
    emit({"phase": "postprocess_profile", "batch_s": batch_s,
          **profile_request(torch, one_batch, batch_s)})
    # the pairwise flag, the one path to F3
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nnf, _ = PyramidPatchMatcher(480, 832, 3, use_pairwise_patch_error=True, device="cuda",
                                 **DEFAULT_EBSYNTH_CONFIG).estimate_nnf(sg, tg, sg)
    torch.cuda.synchronize()
    pair_s = time.perf_counter() - t0
    counted = {k: kern.launches for k, kern in kernels.items()}
    want_pair = fastblend_launches(1, DEFAULT_EBSYNTH_CONFIG, pairwise=True)
    emit(dict(phase="postprocess_pairwise", pairs=8, height=480, width=832, seconds=pair_s,
              nnf_shape=list(nnf.shape), launches=counted, expected_launches=want_pair))
    check_launches(counted, want_pair, "postprocess pairwise")
    launches["F3"] = counted["F3"]
    return launches


# ---------------------------------------------------------------- streaming

STREAM_BUDGET_GB = 13.5      # the JAX package's defaults (models/wan_streaming.py)
STREAM_DEPTH = 3


def check_streaming_reference(torch):
    """The smoke VACE pipeline streamed (`enable_block_streaming("int8",
    resident_blocks=1)`: one trunk block resident, the other and both VACE
    blocks through the ring) on the card against the same on the CPU; then
    the card's serial walk (overlap=False), bit-equal to its overlapped one."""
    from video_styler_tpu_torch.infer_ditto import build_smoke_pipeline, smoke_frames
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    cpu = build_smoke_pipeline(device="cpu", seed=0)
    gpu = card_copy(torch, cpu, WanVideoPipeline)
    plans = [p.enable_block_streaming("int8", resident_blocks=1) for p in (cpu, gpu)]
    kw = dict(prompt="a watercolor city at dusk", vace_video=smoke_frames(9, 32, 32),
              num_frames=9, height=32, width=32, seed=42, cfg_scale=5.0,
              num_inference_steps=2, tiled=True, return_latents=True)
    res, ok = check_card_against_cpu(torch, "streaming_reference", cpu, gpu,
                                     lambda pipe: pipe(**kw), plan=plans[1],
                                     steps=2, cfg="two-pass 5.0")
    streamer = gpu._streamers["dit"]
    overlapped = gpu(**kw)
    streamer.overlap = False
    try:
        serial = gpu(**kw)
    finally:
        streamer.overlap = True
    res.update(serial_bit_equal_to_overlapped=bool(torch.equal(serial, overlapped)),
               ring_copies=streamer.ring.copies)
    emit(res)
    if not (ok and res["serial_bit_equal_to_overlapped"]):
        raise AssertionError(f"streamed smoke pipeline: {res}")


def h2d_rate(torch, nbytes: int, reps: int = 5) -> dict:
    """Seconds to pin a host buffer of `nbytes` (`pinned_empty`), and the
    host-to-device rate from it alone (median of CUDA-event timed copies)."""
    from video_styler_tpu_torch.parallel.streaming import pinned_empty
    t0 = time.perf_counter()
    host = pinned_empty(nbytes)
    pin_s = time.perf_counter() - t0
    host.fill_(1)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(reps + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    del host, dev
    return dict(pin_s=pin_s, gb_per_s=nbytes / statistics.median(times[1:]) / 1e9)


def hidden_share(copies, kernels) -> float:
    """The share of the copies' device time (start, end) intervals that
    falls inside the union of the kernels' intervals."""
    merged = []
    for start, end in sorted(kernels):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    total = sum(end - start for start, end in copies)
    inside = sum(max(0, min(end, b) - max(start, a))
                 for start, end in copies for a, b in merged)
    return inside / total if total else 0.0


def copy_overlap(torch, run) -> dict:
    """`run()` under torch.profiler: the host-to-device copies' device time,
    the kernels' (their union), and the share of the copies' time spent
    while a kernel ran (the copy stream hidden under the compute)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    copies, kernels = [], []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (evt.time_range.start, evt.time_range.end)
        (copies if evt.name.startswith("Memcpy HtoD") else kernels).append(span)
    return dict(copies=len(copies),
                copy_ms=sum(e - s for s, e in copies) / 1e3,
                kernel_ms=sum(e - s for s, e in kernels) / 1e3,
                copy_hidden_share=hidden_share(copies, kernels))


def loop_peak(torch, pipe) -> dict:
    """Resets the peak memory at the denoise loop's first forward (after
    the encodes) for each request; the caller reads it after the request."""
    box = {}
    forward = pipe._forward_all_branches

    def first_forward_resets(*args, **kwargs):
        if not box.get("reset"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            box["reset"] = True
        return forward(*args, **kwargs)
    pipe._forward_all_branches = first_forward_resets
    return box


def run_streaming(torch, kernels, frames: int, steps: int, smi: str):
    """`streaming`: the e2e edit's models at full width (WAN_T2V_14B +
    VACE_14B, umT5-XXL parked on the host between encodes, the Wan2.1
    VAE), quantize("int8") (linears only), the request resident, then
    enable_block_streaming("int8", 13.5 GB, depth 3) on the same int8
    weights and the request streamed (overlapped, --steps steps, counted),
    then 1 step serial; one forward each way on the same inputs, bit-equal;
    then `streaming_train` on the same store. Returns the overlapped run's
    launches and the streamed LoRA step's."""
    import numpy as np
    pipe, init_s = build_pipeline(torch)
    park_text_encoder(pipe)
    t0 = time.perf_counter()
    pipe.quantize("int8")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    quantize_s = time.perf_counter() - t0
    request = dict(edit_request(frames, steps), return_latents=True)
    box = loop_peak(torch, pipe)
    lat_res = pipe(**request)
    resident = dict(step_s=step_times(pipe),
                    loop_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    weights_gb=sum(t.numel() * t.element_size() for m in (pipe.dit, pipe.vace)
                                   for t in list(m.parameters()) + list(m.buffers())) / 1e9)
    vae_bytes = sum(t.numel() * t.element_size() for t in pipe.vae.parameters())
    t5_bytes = sum(t.numel() * t.element_size()
                   for t in pipe.prompter.text_encoder.parameters())

    from video_styler_tpu_torch.probe_pinning import counters_delta, host_counters
    host_before = host_counters()
    t0 = time.perf_counter()
    plan = pipe.enable_block_streaming("int8", hbm_budget_gb=STREAM_BUDGET_GB,
                                       prefetch_depth=STREAM_DEPTH)
    enable_s = time.perf_counter() - t0
    host_delta = counters_delta(host_counters(), host_before)
    streamer = pipe._streamers["dit"]
    store = streamer.streamed_host + (streamer.vace_streamed_host or [])
    pinned_bytes = sum(b.buf.numel() for b in store)
    block_bytes = streamer.streamed_host[0].buf.numel()
    link = h2d_rate(torch, block_bytes)
    allocated_gb = torch.cuda.memory_allocated() / 1e9

    for kern in kernels.values():
        kern.launches = 0
    copied0 = streamer.ring.bytes_copied
    box.clear()
    lat_st = pipe(**request)
    launches = {name: kern.launches for name, kern in kernels.items()}
    loop_peak_bytes = torch.cuda.max_memory_allocated()
    streamed_gb_per_step = (streamer.ring.bytes_copied - copied0) / 1e9 / steps
    overlapped_step_s = step_times(pipe)

    streamer.overlap = False
    try:
        pipe(**dict(request, num_inference_steps=1))
        serial_step_s = step_times(pipe)
        # one forward each way on the same inputs
        gen = torch.Generator("cuda").manual_seed(3)
        f_lat = (frames - 1) // 4 + 1
        inputs = (torch.randn((1, 16, f_lat, 60, 104), generator=gen, device="cuda"
                              ).to(torch.bfloat16),
                  torch.tensor([900.0], device="cuda"),
                  torch.randn((1, TEXT_LEN, 4096), generator=gen, device="cuda"
                              ).to(torch.bfloat16),
                  torch.randn((1, 96, f_lat, 60, 104), generator=gen, device="cuda"
                              ).to(torch.bfloat16))
        forward_s = {}
        outs = {}
        for name, overlap in (("serial", False), ("overlapped", True)):
            streamer.overlap = overlap
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = streamer.forward(*inputs)[0]
            torch.cuda.synchronize()
            forward_s[name] = time.perf_counter() - t0
        # the same forwards traced: how much of the copy ran under compute
        overlap_trace = {}
        for name, overlap in (("serial", False), ("overlapped", True)):
            streamer.overlap = overlap
            overlap_trace[name] = copy_overlap(torch, lambda: streamer.forward(*inputs))
    finally:
        streamer.overlap = True
        del pipe._forward_all_branches

    diff = (lat_st.float() - lat_res.float())
    rel = (diff.norm() / lat_res.float().norm()).item()
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_14B
    from video_styler_tpu_torch.models.wan_vace import VACE_14B
    layers = WAN_T2V_14B.num_layers + len(VACE_14B.vace_layers)
    expected = {"K1": 2 * layers * 2 * steps, "K4": layers * 2 * steps,
                "K5": layers * 2 * steps}
    outside = dict(vae=vae_bytes, umt5_parked_on_host_during_the_loop=t5_bytes)
    res = dict(phase="streaming", card=smi, frames=frames,
               tokens=int(np.prod(token_grid(frames))), steps=steps, cfg="two-pass 5.0",
               mode="int8", hbm_budget_gb=STREAM_BUDGET_GB, prefetch_depth=STREAM_DEPTH,
               plan=plan, init_s=init_s, quantize_s=quantize_s,
               enable_streaming_s=enable_s, store_seconds=streamer.store_seconds,
               streamed_block_bytes=block_bytes, h2d_pinned=link,
               store_pinned_bytes=pinned_bytes, store_tensor_bytes=sum(b.nbytes for b in store),
               host_counters_delta_over_enable=host_delta,
               memory_allocated_after_enable_gb=allocated_gb,
               streamed_gb_per_step=streamed_gb_per_step,
               step_s=dict(overlapped=overlapped_step_s, serial=serial_step_s,
                           resident_int8=resident["step_s"]),
               forward_s=forward_s, copy_overlap=overlap_trace,
               loop_peak_gib=dict(streamed=loop_peak_bytes / 2**30,
                                  resident_int8=resident["loop_peak_gib"]),
               resident_int8_weights_gb=resident["weights_gb"],
               outside_budget_bytes=outside,
               latents_bit_equal_to_resident_int8=bool(torch.equal(lat_st, lat_res)),
               latents_max_abs_diff=diff.abs().max().item(), latents_rel_l2=rel,
               latents_tol=5e-2,
               serial_forward_bit_equal_to_overlapped=bool(torch.equal(outs["serial"],
                                                                       outs["overlapped"])),
               launches=launches, expected_launches=expected)
    emit(res)
    del outs, inputs
    gc.collect()
    torch.cuda.empty_cache()
    # the streamed LoRA step on the same int8 store
    train_launches = run_streaming_train(torch, kernels, pipe, frames, smi)
    del pipe, streamer
    gc.collect()
    torch.cuda.empty_cache()
    check_launches(launches, expected, "streaming")
    failures = []
    if loop_peak_bytes > STREAM_BUDGET_GB * 1e9 + vae_bytes:
        failures.append(f"loop peak {loop_peak_bytes} B over the budget + the VAE")
    if not rel <= 5e-2:
        failures.append(f"latents {rel} from the resident int8 run")
    if not res["serial_forward_bit_equal_to_overlapped"]:
        failures.append("serial and overlapped forwards differ")
    if failures:
        raise AssertionError("streaming: " + "; ".join(failures))
    return launches, train_launches


WORKFLOW_GRAPH = {"nodes": [  # the node types of the reference's Ditto workflow
    {"type": "WanVideoSampler", "widgets_values": [4, 1.2, 2.0, 7, "randomize", True, "unipc"]},
    {"type": "WanVideoTextEncode", "widgets_values": ["Make it a Pixel Art video.", "bad"]},
    {"type": "WanVideoVACEEncode", "widgets_values": [832, 480, 33, 0.975, 0, 1, False]},
    {"type": "WanVideoModelLoader", "widgets_values": [
        "Wan2_1-T2V-14B_fp8_e4m3fn.safetensors", "fp16", "disabled", "offload_device", "sdpa"]},
    {"type": "WanVideoBlockSwap", "widgets_values": [20, False, False]},
    {"type": "WanVideoDecode", "widgets_values": [False, 272, 272, 144, 128, "default"]},
    {"type": "WanVideoSLG", "widgets_values": ["1", 0.2, 0.7]},
]}


def run_workflow_smokes(torch, kernels):
    """`workflow_smokes`: `run_comfyui_workflow --smoke` (a graph of the
    reference workflow's node types) and `video_editing_with_agent --smoke`
    (the mock image provider, a synthetic clip) on the card. The workflow's
    block swap must stream: its plan and the blocks its ring copied."""
    import numpy as np
    from video_styler_tpu_torch import run_comfyui_workflow, video_editing_with_agent
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    out_dir = tempfile.mkdtemp(prefix="workflows-")
    enable = WanVideoPipeline.enable_block_streaming
    streamers = []

    def recorded(pipe, *args, **kwargs):
        plan = enable(pipe, *args, **kwargs)
        streamers.append((plan, pipe._streamers["dit"]))
        return plan
    WanVideoPipeline.enable_block_streaming = recorded
    try:
        graph = os.path.join(out_dir, "workflow.json")
        with open(graph, "w") as f:
            json.dump(WORKFLOW_GRAPH, f)
        res = dict(phase="workflow_smokes")
        for name, run in (
                ("run_comfyui_workflow", lambda: run_comfyui_workflow.main(
                    ["--workflow", graph, "--smoke",
                     "--output_path", os.path.join(out_dir, "wf.mp4")])),
                ("video_editing_with_agent", lambda: video_editing_with_agent.main(
                    ["--smoke", "--style", "pixel art", "--max_frames", "3",
                     "--output_dir", os.path.join(out_dir, "agent"),
                     "--output_path", os.path.join(out_dir, "agent.mp4")]))):
            for kern in kernels.values():
                kern.launches = 0
            t0 = time.perf_counter()
            frames = np.asarray(run())
            res[name] = dict(seconds=time.perf_counter() - t0, frames_shape=list(frames.shape),
                             launches={k: v.launches for k, v in kernels.items()
                                       if v.launches})
            if name == "run_comfyui_workflow":
                res[name]["block_streaming"] = [dict(plan=plan, blocks_copied=st.ring.copies)
                                                for plan, st in streamers]
        emit(res)
        for name in ("run_comfyui_workflow", "video_editing_with_agent"):
            if not res[name]["launches"].get("K1"):
                raise AssertionError(f"{name} --smoke launched no attention kernel: {res}")
        swap = res["run_comfyui_workflow"]["block_streaming"]
        if len(swap) != 1 or not swap[0]["blocks_copied"]:
            raise AssertionError(f"the workflow's block swap streamed nothing: {res}")
    finally:
        WanVideoPipeline.enable_block_streaming = enable
        shutil.rmtree(out_dir, ignore_errors=True)


KERNEL_CATEGORIES = (  # (category, substrings of the device kernel's name)
    ("K1", ("flash_fwd_capped_kernel",)),
    ("K2", ("flash_fwd_online_kernel",)),
    ("K8", ("flash_fwd_online_dual_kernel",)),
    ("K6", ("flash_fwd_int8_kernel",)),
    ("K3", ("fa_bwd_kernel<true>",)),
    ("K3q", ("fa_bwd_kernel<false>",)),
    ("K3 stats/convert", ("fa_bwd_stats_kernel", "fa_bwd_convert_kernel")),
    ("K4", ("rmsnorm_rope_kernel",)),
    ("K5", ("rmsnorm_kernel",)),
    ("K1f", ("flash_fwd_f32_kernel",)),
    ("K3f dK dV", ("fa_bwd_dkv_f32_kernel", "fa_delta_f32_kernel")),
    ("K3f dQ", ("fa_bwd_dq_f32_kernel",)),
    ("K4f", ("rmsnorm_rope_f32_kernel",)),
    ("K5f", ("rmsnorm_f32_kernel",)),
    ("F3", ("pairwise_patch_error_kernel",)),
    ("F2", ("patch_error_kernel",)),
    ("F1", ("remap_kernel",)),
    ("conv", ("fprop", "dgrad", "wgrad", "cudnn", "convolve", "conv2d", "conv3d")),
    ("int8 gemm", ("i8i8", "_s8_", "int8", "imma", "igemm", "i8816", "i16832")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
)


# ---------------------------------------------------------------------------
# FLUX.1-dev text-to-image
# ---------------------------------------------------------------------------

FLUX_TEXT = 512             # T5 tokens of a request (t5_sequence_length)
FLUX_HEADS = 24             # FLUX.1: 24 heads of 128
FLUX_PROMPT = "a lighthouse on a cliff at dawn, oil painting"
FLUX_RECIPE_STEPS = 30      # the image CLI's default for FLUX.1-dev
FLUX_REF_SIZE = 256         # flux_reference: 256x256 (256 image tokens)
FLUX_CATEGORIES = (  # one DiT step's device time, by category
    ("K1", ("flash_fwd_capped_kernel",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("elementwise", ("elementwise", "reduce_kernel", "CatArrayBatchedCopy", "layer_norm",
                     "copy_kernel", "index", "fill", "softmax")),
)


def flux_tokens(size: int) -> int:
    """[text | image] tokens of a size x size request: 512 + (size / 16)^2."""
    return FLUX_TEXT + (size // 16) ** 2


def check_flux_kernels(torch):
    """`flux_kernels`: K1 at the FLUX DiT's joint self-attention, 24 heads
    of 128 over [512 text | image] tokens at 1024x1024 (4,608) and 512x512
    (1,536), held against its plain version (two bf16 ULPs)."""
    rows = []
    for size in (1024, 512):
        rows += check_kernels(torch, (1, 1, flux_tokens(size)), f"flux-{size}px",
                              heads=FLUX_HEADS, cross_lens=(), norms=False)
    return rows


def flux_reference_configs():
    """A small FLUX with head dim 128 (dim 256, 2 heads, FLUX's RoPE axes,
    2 + 2 blocks), tiny CLIP-L and T5 v1.1 towers, the release-width VAE."""
    import dataclasses
    from video_styler_tpu_torch.models.flux_dit import FLUX_DIT_TINY
    from video_styler_tpu_torch.models.sd3_text_encoder import CLIP_L_TINY
    from video_styler_tpu_torch.models.sd3_vae import FLUX_VAE
    from video_styler_tpu_torch.models.t5 import T5_V11_TINY
    dit = dataclasses.replace(FLUX_DIT_TINY, dim=256, num_heads=2, axes_dim=(16, 56, 56),
                              context_dim=T5_V11_TINY.dim, pooled_dim=CLIP_L_TINY.dim)
    return dit, CLIP_L_TINY, T5_V11_TINY, FLUX_VAE


def flux_pipeline(torch, configs, device: str, seed: int = 0):
    from video_styler_tpu_torch.pipelines.flux_image import FluxImagePipeline
    from video_styler_tpu_torch.prompters.flux_prompter import (StubClipTokenizer,
                                                                StubT5Tokenizer)
    dit, clip, t5, vae = configs
    return FluxImagePipeline.from_configs(dit, clip, t5, vae, StubClipTokenizer(clip.vocab),
                                          StubT5Tokenizer(t5.vocab), seed=seed,
                                          device=device, dtype=torch.bfloat16)


def check_flux_reference(torch):
    """`flux_reference`: the small FLUX pipeline of `flux_reference_configs`
    on the card (K1) against the same weights on the CPU (plain versions):
    256x256, 2 steps, CFG 1 and CFG 2 two-pass, latents within 5% relative
    L2; the fp32 decode of the CPU's CFG-1 latents on both devices within 2
    levels."""
    import numpy as np
    cpu = flux_pipeline(torch, flux_reference_configs(), "cpu")
    gpu = copy.copy(cpu)
    gpu.device = torch.device("cuda")
    gpu.prompter = copy.copy(cpu.prompter)
    gpu.dit, gpu.vae_encoder, gpu.vae_decoder, gpu.prompter.clip, gpu.prompter.t5 = (
        copy.deepcopy(m).to("cuda") for m in (cpu.dit, cpu.vae_encoder, cpu.vae_decoder,
                                              cpu.prompter.clip, cpu.prompter.t5))
    res = dict(phase="flux_reference", size=FLUX_REF_SIZE, steps=2,
               dit_dim=cpu.dit_cfg.dim, dit_heads=cpu.dit_cfg.num_heads,
               tokens=flux_tokens(FLUX_REF_SIZE), latents_rel_l2={}, latents_tol=5e-2)
    lat_cpu = None
    for cfg_scale in (1.0, 2.0):
        kw = dict(prompt=FLUX_PROMPT, negative_prompt="blurry", cfg_scale=cfg_scale,
                  height=FLUX_REF_SIZE, width=FLUX_REF_SIZE, seed=42,
                  num_inference_steps=2, return_latents=True)
        lat_c = cpu(**kw).float()
        lat_g = gpu(**kw).float().cpu()
        res["latents_rel_l2"][f"cfg {cfg_scale}"] = ((lat_g - lat_c).norm()
                                                      / lat_c.norm()).item()
        if lat_cpu is None:
            lat_cpu = lat_c
    img_c = np.asarray(cpu.vae_output_to_image(cpu.decode_image(lat_cpu)), np.int16)
    img_g = np.asarray(gpu.vae_output_to_image(gpu.decode_image(lat_cpu.cuda())), np.int16)
    res.update(image_max_abs_diff=float(np.abs(img_g - img_c).max()), image_tol=2.0)
    emit(res)
    if not (all(v <= 5e-2 for v in res["latents_rel_l2"].values())
            and res["image_max_abs_diff"] <= 2.0):
        raise AssertionError(f"FLUX, card vs CPU disagree: {res}")


def run_flux(torch, kernels, steps: int):
    """`flux`: FLUX.1-dev at full width and depth on a free card (dim 3072,
    24 heads, 19 + 38 blocks, T5 v1.1-XXL, CLIP-L, the FLUX VAE; random
    weights from seed 0, bf16, the VAE fp32): a 1024x1024 request through
    `FluxImagePipeline` at the recipe's embedded guidance 3.5 and CFG 1,
    --steps steps, then the decode: stage times, peak memory, K1's launches
    against 57 a step; then one DiT step profiled by category; the
    recipe's 30-step request composed; then the `flux_adapters` and
    `flux_lora` phases on the same resident model. Returns the launches,
    the adapters' and the LoRA steps' launches and the modules the sd3
    phase shares."""
    from video_styler_tpu_torch.models.flux_dit import FLUX_DEV
    from video_styler_tpu_torch.models.sd3_text_encoder import CLIP_L
    from video_styler_tpu_torch.models.sd3_vae import FLUX_VAE
    from video_styler_tpu_torch.models.t5 import T5_V11_XXL
    from video_styler_tpu_torch.pipelines.wan_video import generate_noise
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = flux_pipeline(torch, (FLUX_DEV, CLIP_L, T5_V11_XXL, FLUX_VAE), "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = pipe.dit_cfg
    try:
        weights = {"dit": gib([pipe.dit]), "t5": gib([pipe.prompter.t5]),
                   "clip": gib([pipe.prompter.clip]),
                   "vae": gib([pipe.vae_encoder, pipe.vae_decoder])}
        request = dict(prompt=FLUX_PROMPT, height=1024, width=1024, seed=42,
                       embedded_guidance=3.5, num_inference_steps=steps)
        for kern in kernels.values():
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        image = pipe(**request)
        total_s = time.perf_counter() - t0
        launches = {name: kern.launches for name, kern in kernels.items()}
        blocks = cfg.num_joint_blocks + cfg.num_single_blocks
        expected = {"K1": blocks * steps}
        res = dict(phase="flux", model="FLUX.1-dev", dit_dim=cfg.dim, dit_heads=cfg.num_heads,
                   joint_blocks=cfg.num_joint_blocks, single_blocks=cfg.num_single_blocks,
                   size=1024, tokens=flux_tokens(1024), steps=steps, cfg="1 (embedded 3.5)",
                   build_s=build_s, weights_gib=weights, total_s=total_s,
                   stages=dict(pipe.stage_times), step_s=step_times(pipe),
                   stage_peak_gib={k: v / 2**30 for k, v in pipe.stage_peak_bytes},
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                   image_size=list(image.size), launches=launches,
                   expected_launches=expected,
                   k1_launches_per_30_step_request=blocks * 30, **CARD)
        emit(res)
        check_launches(launches, expected, "flux")
        if image.size != (1024, 1024):
            raise AssertionError(f"flux: image {image.size}")
        # one DiT step (CFG 1: one forward) under the profiler, on this
        # request's inputs; its idle share against the unprofiled step
        emb, pooled, _ = pipe.encode_prompt(FLUX_PROMPT)
        latents = generate_noise((1, 16, 128, 128), seed=42).to("cuda", torch.bfloat16)
        t = torch.tensor([float(pipe.scheduler.timesteps[0])], device="cuda")
        g = torch.tensor([3.5], device="cuda")
        with torch.no_grad():
            def one_step():
                return pipe._branch(latents, t, emb, pooled, g, None, None)
            prof = profile_request(torch, one_step, min(step_times(pipe)),
                                   categories=FLUX_CATEGORIES)
        emit({"phase": "flux_profile", "forwards": 1, **prof, **CARD})
        composed_request("flux_image", res["stages"], res["step_s"], FLUX_RECIPE_STEPS,
                         size=1024, cfg="1 (embedded 3.5)")
        adapter_launches = run_flux_adapters(torch, pipe, kernels, steps)
        # the LoRA steps on the same DiT (last: they put a LoRA on its linears)
        lora_launches = run_flux_lora(torch, pipe, kernels, steps)
        # what the sd3 phase shares: CLIP-L, T5 v1.1-XXL and the VAE's modules
        shared = (pipe.prompter.clip, pipe.prompter.t5, pipe.vae_encoder, pipe.vae_decoder)
        return launches, adapter_launches, lora_launches, shared
    finally:
        del pipe
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# FLUX's adapters and the SD3 family
# ---------------------------------------------------------------------------

FLUX_IP_TOKENS = 128        # IP-Adapter tokens a picture (InstantX FLUX.1-dev-IP-Adapter)
FLUX_UNION_MODES = 10       # the union ControlNet's mode table (FLUX.1-dev-Controlnet-Union)
FLEX_CHANNELS = 33          # Flex.2's extra latent channels: 16 inpaint + 1 mask + 16 control
SIGLIP_DIM = 1152           # SigLIP so400m's pooled width
FLUX_VALUE_TOKENS = 4       # a value encoder's tokens (the JAX init's widths)
SD3_T5_LEN = 77             # the SD3 prompter's T5 rows (the JAX default)
SD3_CFG = 7.5
SD3_RECIPE_STEPS = 20       # the JAX pipeline's default
SD3_CATEGORIES = (  # one two-pass SD3 step's device time, by category
    ("attention fp32 GEMM", ("f32f32_f32f32", "sgemm", "simt", "gemm_f32")),
    ("softmax", ("SoftMax", "softmax")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("elementwise", ("elementwise", "reduce_kernel", "CatArrayBatchedCopy", "layer_norm",
                     "copy_kernel", "index", "fill")),
)


def flux_adapter_self_lens(size: int) -> dict:
    """K1's self-attention lengths on `flux_adapters`' requests beyond the
    DiT's own [text | image] (`flux_kernels`): the union ControlNet's trunk
    (its mode token ahead of the text; the LoRA encoder's one token after
    the text gives the DiT the same length), InfiniteYou's trunk (its id
    tokens and the mode token in place of the text), the value encoder's
    tokens after the text, and Kontext's reference image after the image."""
    from video_styler_tpu_torch.models.flux_adapters import FLUX_LORA_ENCODER, INFINITEYOU
    img = (size // 16) ** 2
    return {"controlnet": FLUX_TEXT + 1 + img,
            "lora_encoder": FLUX_TEXT + FLUX_LORA_ENCODER.num_special_embeds + img,
            "infiniteyou": INFINITEYOU.num_queries + 1 + img,
            "value": FLUX_TEXT + FLUX_VALUE_TOKENS + img,
            "kontext": FLUX_TEXT + 2 * img}


def check_flux_adapter_kernels(torch):
    """`flux_adapter_kernels`: K1 at the adapters' new shapes, 24 heads of
    128, against its plain version (two bf16 ULPs): the IP-Adapter's cross
    from the joint blocks' 4,096 image rows and the single blocks' 4,608
    [text | image] rows to 128 and 256 keys (one and two pictures: one and
    two key tiles), and every self-attention length of
    `flux_adapter_self_lens` (4,609, 4,105, 4,612 and 8,704: the first
    three no multiple of 8)."""
    rows = []
    for s in (flux_tokens(1024) - FLUX_TEXT, flux_tokens(1024)):
        rows += check_kernels(torch, (1, 1, s), f"flux-ip-{s}q", heads=FLUX_HEADS,
                              cross_lens=(FLUX_IP_TOKENS, 2 * FLUX_IP_TOKENS),
                              self_attn=False, norms=False)
    for s in sorted(set(flux_adapter_self_lens(1024).values())):
        rows += check_kernels(torch, (1, 1, s), f"flux-adapter-{s}", heads=FLUX_HEADS,
                              cross_lens=(), norms=False)
    return rows


def siglip_standin(images):
    """A seeded stand-in for the SigLIP tower the caller passes: (B, 1152)
    from each picture's mean colour through a fixed random projection."""
    import numpy as np
    arr = np.stack([np.asarray(im, np.float32).reshape(-1, 3).mean(axis=0) for im in images])
    w = np.random.default_rng(31).standard_normal((3, SIGLIP_DIM)).astype(np.float32)
    return (arr / 255.0 - 0.5) @ w


def synthetic_image(seed: int, size: int):
    import numpy as np
    from PIL import Image
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    rgb = np.stack([np.sin(6 * x + seed), np.cos(5 * y - seed), np.sin(4 * (x + y))], -1)
    return Image.fromarray(((rgb + 1) * 127.5).astype(np.uint8))


def entity_mask(size: int, top: float, left: float, bottom: float, right: float):
    import numpy as np
    from PIL import Image
    arr = np.zeros((size, size, 3), np.uint8)
    arr[int(top * size):int(bottom * size), int(left * size):int(right * size)] = 255
    return Image.fromarray(arr)


def random_flux_lora(rank: int, seed: int):
    """A FLUX LoRA over every projection the LoRA encoder probes (native
    names, numpy), rank `rank`, factors N(0, 0.02^2)."""
    import numpy as np
    from video_styler_tpu_torch.models.flux_adapters import default_lora_patterns
    rng = np.random.default_rng(seed)
    lora = {}
    for pat in default_lora_patterns():
        din, dout = pat["dim"]
        lora[pat["name"] + ".lora_A.weight"] = (
            0.02 * rng.standard_normal((rank, din), dtype=np.float32))
        lora[pat["name"] + ".lora_B.weight"] = (
            0.02 * rng.standard_normal((dout, rank), dtype=np.float32))
    return lora


def attach_adapter(torch, pipe, name: str, seed: int, full: bool):
    """A random adapter drawn on the pipeline's device in its dtype, at the
    published checkpoints' widths for `pipe.dit_cfg` (`full`: the union
    ControlNet's 5 + 10 blocks; else 2 + 2)."""
    import dataclasses
    from video_styler_tpu_torch.models import flux_adapters as FA
    from video_styler_tpu_torch.models import flux_controlnet as FC
    d = pipe.dit_cfg
    gen = torch.Generator(pipe.device).manual_seed(seed)

    def draw(make, init):
        with torch.device("meta"):
            module = make()
        return init(module.to_empty(device=pipe.device), gen).eval()

    if name == "controlnet":
        cfg = FC.FluxControlNetConfig(dit=d, num_joint_blocks=5 if full else 2,
                                      num_single_blocks=10 if full else 2,
                                      num_mode=FLUX_UNION_MODES)
        pipe.controlnet = draw(lambda: FC.FluxControlNet(cfg, dtype=pipe.dtype),
                               FC.init_flux_controlnet_)
        return pipe.controlnet
    if name == "ipadapter":
        cfg = FC.FluxIpAdapterConfig(dit=d, image_dim=SIGLIP_DIM, num_tokens=FLUX_IP_TOKENS,
                                     num_blocks=d.num_joint_blocks + d.num_single_blocks)
        pipe.ipadapter = draw(lambda: FC.FluxIpAdapter(cfg, dtype=pipe.dtype),
                              FC.init_flux_ipadapter_)
        pipe.ipadapter_image_encoder = siglip_standin
        return pipe.ipadapter
    if name == "infiniteyou":
        cfg = FA.InfiniteYouConfig(output_dim=d.context_dim)
        pipe.infiniteyou_projector = draw(lambda: FA.InfiniteYouProjector(cfg, dtype=pipe.dtype),
                                          FA.init_infiniteyou_projector_)
        return pipe.infiniteyou_projector
    if name == "value":
        # the JAX init's widths (16 in, 4 tokens) to the DiT's text width
        cfg = FA.ValueEncoderConfig(16, d.context_dim, FLUX_VALUE_TOKENS)
        pipe.value_controllers = [draw(lambda: FA.SingleValueEncoder(cfg, dtype=pipe.dtype),
                                       FA.init_value_encoder_)]
        return pipe.value_controllers[0]
    if name == "lora_encoder":
        cfg = dataclasses.replace(FA.FLUX_LORA_ENCODER, embed_dim=d.context_dim,
                                  intermediate_dim=2 * d.context_dim)
        pipe.lora_encoder = draw(lambda: FA.FluxLoRAEncoder(cfg, dtype=pipe.dtype),
                                 FA.init_flux_lora_encoder_)
        return pipe.lora_encoder
    raise ValueError(name)


def flux_adapter_requests(size: int, lora_rank: int):
    """name -> (the adapters it needs, its request beyond the base one, K1
    launches a step: 57 DiT blocks, + 15 (or the reference's 4) ControlNet
    blocks per branch, + 57 IP-Adapter crosses; none under EliGen's bias)."""
    import numpy as np
    rng = np.random.default_rng(32)
    lat = size // 8
    cond = rng.standard_normal((1, FLEX_CHANNELS, lat, lat)).astype(np.float32)
    return {
        "controlnet": (("controlnet",), dict(controlnet_image=synthetic_image(1, size),
                                             controlnet_processor_id=2)),
        "controlnet_cfg": (("controlnet",), dict(controlnet_image=synthetic_image(1, size),
                                                 controlnet_processor_id=2, cfg_scale=2.0,
                                                 negative_prompt="blurry, dark")),
        "ipadapter": (("ipadapter",), dict(ipadapter_images=[synthetic_image(2, size)])),
        "eligen": ((), dict(eligen_entity_prompts=["a red lighthouse", "a stormy sea"],
                            eligen_entity_masks=[entity_mask(size, 0.0, 0.3, 0.7, 0.7),
                                                 entity_mask(size, 0.6, 0.0, 1.0, 1.0)])),
        "infiniteyou": (("controlnet", "infiniteyou"), dict(
            controlnet_image=synthetic_image(3, size), controlnet_processor_id=5,
            infinityou_id_emb=rng.standard_normal((1, 512)).astype(np.float32),
            infinityou_guidance=1.5)),
        "value": (("value",), dict(value_controller_inputs=[0.7])),
        "lora_encoder": (("lora_encoder",), dict(
            lora_encoder_inputs=[random_flux_lora(lora_rank, 33)], lora_encoder_scale=0.8)),
        "flex": (("flex",), dict(flex_condition=cond, flex_uncondition=np.zeros_like(cond),
                                 flex_control_stop_timestep=500.0)),
    }


def expected_flux_k1(pipe, name: str, request: dict, steps: int) -> dict:
    d = pipe.dit_cfg
    per_forward = d.num_joint_blocks + d.num_single_blocks
    if request.get("eligen_entity_prompts"):
        return {}
    if request.get("ipadapter_images") is not None:
        per_forward *= 2
    if request.get("controlnet_image") is not None:
        cn = pipe.controlnet.cfg
        per_forward += cn.num_joint_blocks + cn.num_single_blocks
    branches = 2 if request.get("cfg_scale", 1.0) != 1.0 else 1
    return {"K1": per_forward * branches * steps}


def flux_flex_dit(torch, pipe, seed: int):
    """The pipeline's DiT with an `x_embedder` of 16 + 33 latent channels
    drawn from a seed (Flex.2's input); every other weight shared."""
    import dataclasses
    from video_styler_tpu_torch.models import flux_dit as F
    from video_styler_tpu_torch.models.wan_dit import Linear
    d = pipe.dit_cfg
    flex = copy.copy(pipe.dit)
    flex._modules = dict(pipe.dit._modules)
    flex.cfg = dataclasses.replace(d, in_dim=(16 + FLEX_CHANNELS) * 4)
    gen = torch.Generator(pipe.device).manual_seed(seed)
    emb = Linear(flex.cfg.in_dim, d.dim, device=pipe.device, dtype=pipe.dtype)
    with torch.no_grad():
        emb.weight.normal_(0.0, flex.cfg.in_dim ** -0.5, generator=gen)
        emb.bias.zero_()
    flex._modules["x_embedder"] = emb
    return flex


def check_flux_adapters_reference(torch):
    """`flux_adapters_reference`: each adapter on the small FLUX of
    `flux_reference_configs` (head dim 128), random weights from seeds:
    the union ControlNet at 2 + 2 blocks (with and without two-pass CFG),
    the IP-Adapter (128 tokens from a 1152-wide embedding, 4 blocks),
    EliGen (two entities), InfiniteYou (on the ControlNet's branch), a
    value encoder, the LoRA encoder (64 wide) on a rank-2 LoRA, Flex (a DiT
    taking 16 + 33 channels); 256x256, 2 steps, card (K1) against the CPU
    (plain versions): latents within 5% relative L2."""
    cpu = flux_pipeline(torch, flux_reference_configs(), "cpu")
    requests = flux_adapter_requests(FLUX_REF_SIZE, lora_rank=2)
    for i, name in enumerate(("controlnet", "ipadapter", "infiniteyou", "value",
                              "lora_encoder")):
        attach_adapter(torch, cpu, name, seed=40 + i, full=False)
    flex_cpu = flux_flex_dit(torch, cpu, 46)
    gpu = copy.copy(cpu)
    gpu.device = torch.device("cuda")
    gpu.prompter = copy.copy(cpu.prompter)
    (gpu.dit, gpu.vae_encoder, gpu.vae_decoder, gpu.prompter.clip, gpu.prompter.t5,
     gpu.controlnet, gpu.ipadapter, gpu.infiniteyou_projector, gpu.lora_encoder, flex_gpu) = (
        copy.deepcopy(m).to("cuda") for m in (
            cpu.dit, cpu.vae_encoder, cpu.vae_decoder, cpu.prompter.clip, cpu.prompter.t5,
            cpu.controlnet, cpu.ipadapter, cpu.infiniteyou_projector, cpu.lora_encoder,
            flex_cpu))
    gpu.value_controllers = [copy.deepcopy(m).to("cuda") for m in cpu.value_controllers]
    res = dict(phase="flux_adapters_reference", size=FLUX_REF_SIZE, steps=2,
               dit_dim=cpu.dit_cfg.dim, dit_heads=cpu.dit_cfg.num_heads, latents_rel_l2={},
               latents_tol=5e-2, **CARD)
    base = dict(prompt=FLUX_PROMPT, height=FLUX_REF_SIZE, width=FLUX_REF_SIZE, seed=42,
                num_inference_steps=2, return_latents=True)
    for name, (_, request) in requests.items():
        pairs = ((cpu, flex_cpu), (gpu, flex_gpu))
        lats = []
        for pipe, flex in pairs:
            dit = pipe.dit
            if name == "flex":
                pipe.dit = flex
            try:
                lats.append(pipe(**base, **request).float().cpu())
            finally:
                pipe.dit = dit
        res["latents_rel_l2"][name] = ((lats[1] - lats[0]).norm() / lats[0].norm()).item()
    emit(res)
    if not all(v <= 5e-2 for v in res["latents_rel_l2"].values()):
        raise AssertionError(f"FLUX adapters, card vs CPU disagree: {res}")


def run_flux_case(torch, pipe, kernels, name: str, request: dict, steps: int,
                  expected: dict, **extra):
    """One request on the resident FLUX.1-dev with every launch count set
    to 0 just before and read just after: step seconds, peak, launches
    against `expected`, finite latents of the request's shape."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    lat = pipe(return_latents=True, **request)
    total_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.items()}
    size = request["height"]
    res = dict(phase="flux_adapters", case=name, size=size, steps=steps, total_s=total_s,
               step_s=step_times(pipe),
               stages={k: v for k, v in pipe.stage_times if not k.startswith("denoise_step_")},
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches={k: v for k, v in launches.items() if v}, expected_launches=expected,
               **extra, **CARD)
    emit(res)
    check_launches(launches, expected, f"flux_adapters {name}")
    if tuple(lat.shape) != (1, 16, size // 8, size // 8) or not bool(torch.isfinite(lat).all()):
        raise AssertionError(f"flux_adapters {name}: latents {tuple(lat.shape)}, not finite")
    return launches


def run_flux_adapters(torch, pipe, kernels, steps: int, size: int = 1024):
    """`flux_adapters`: on the resident FLUX.1-dev (after `flux`), each
    adapter at its published width with random weights from a seed,
    1024x1024, --steps steps (K1's launches against the count from the
    code): the union ControlNet (5 + 10 blocks, 10 modes) with a
    `processor_id`, also under two-pass CFG, then InfiniteYou (1280 wide,
    4 layers, 4096 out) on its branch; the IP-Adapter (SigLIP 1152 -> 128
    tokens, 57 k/v pairs) with the seeded SigLIP stand-in; EliGen with two
    entity masks; a value encoder (16 in, 4 tokens of 4096); the LoRA
    encoder (4096 wide, 304 probes of 16 tokens) on a rank-16 LoRA, its
    encode timed once; Flex (an x_embedder of 16 + 33 channels); then the
    base pipeline's options: img2img, Kontext (a 1024x1024
    reference, 8,704 tokens), TeaCache (4 steps, the middle two skipped at
    a threshold no step reaches), 512x512, schnell (no guidance embedding)
    and a merged rank-16 LoRA (last: it changes the DiT's weights).
    `size`: the requests' height and width."""
    import dataclasses
    import numpy as np
    from video_styler_tpu_torch.pipelines.flux_image import FluxTeaCache
    d = pipe.dit_cfg
    blocks = d.num_joint_blocks + d.num_single_blocks
    base = dict(prompt=FLUX_PROMPT, height=size, width=size, seed=42,
                embedded_guidance=3.5, num_inference_steps=steps)
    requests = flux_adapter_requests(size, lora_rank=16)
    launches = {}
    weights = {}

    def run(name, request, expected=None, n=steps, **extra):
        req = {**base, "num_inference_steps": n, **request}
        if expected is None:
            expected = expected_flux_k1(pipe, name, req, n)
        launches[name] = run_flux_case(torch, pipe, kernels, name, req, n, expected, **extra)

    def drop(*names):
        for attr in names:
            setattr(pipe, attr, None)
        gc.collect()
        torch.cuda.empty_cache()

    weights["controlnet"] = gib([attach_adapter(torch, pipe, "controlnet", 50, full=True)])
    run("controlnet", requests["controlnet"][1], weights_gib=weights["controlnet"])
    run("controlnet_cfg", requests["controlnet_cfg"][1])
    weights["infiniteyou"] = gib([attach_adapter(torch, pipe, "infiniteyou", 51, full=True)])
    run("infiniteyou", requests["infiniteyou"][1], weights_gib=weights["infiniteyou"])
    drop("controlnet", "infiniteyou_projector")
    weights["ipadapter"] = gib([attach_adapter(torch, pipe, "ipadapter", 52, full=True)])
    run("ipadapter", requests["ipadapter"][1], weights_gib=weights["ipadapter"])
    drop("ipadapter")
    run("eligen", requests["eligen"][1], tokens=3 * FLUX_TEXT + flux_tokens(size) - FLUX_TEXT)
    weights["value"] = gib([attach_adapter(torch, pipe, "value", 53, full=True)])
    run("value", requests["value"][1])
    drop("value_controllers")
    weights["lora_encoder"] = gib([attach_adapter(torch, pipe, "lora_encoder", 54, full=True)])
    run("lora_encoder", requests["lora_encoder"][1], weights_gib=weights["lora_encoder"])
    drop("lora_encoder")
    dit = pipe.dit
    pipe.dit = flux_flex_dit(torch, pipe, 55)
    try:
        run("flex", requests["flex"][1])
    finally:
        pipe.dit = dit
    # the base pipeline's options, at full width
    run("img2img", dict(input_image=synthetic_image(6, size), denoising_strength=0.6))
    run("kontext", dict(kontext_images=[synthetic_image(7, size)]),
        tokens=flux_adapter_self_lens(size)["kontext"])
    skips = []
    check = FluxTeaCache.check

    def counted(self, modulated):
        skip = check(self, modulated)
        skips.append(skip)
        return skip
    FluxTeaCache.check = counted
    try:
        run("teacache", dict(tea_cache_l1_thresh=1e9), n=4, expected={"K1": 2 * blocks})
    finally:
        FluxTeaCache.check = check
    if skips != [False, True, True, False]:
        raise AssertionError(f"teacache: skip decisions {skips}")
    run("half_size", dict(height=size // 2, width=size // 2), tokens=flux_tokens(size // 2))
    schnell = dataclasses.replace(pipe.dit.cfg, guidance_embed=False)
    dev_cfg, pipe.dit.cfg = pipe.dit.cfg, schnell
    try:
        run("schnell", {})
    finally:
        pipe.dit.cfg = dev_cfg
    rng = np.random.default_rng(56)
    lora = {}
    for i in range(d.num_joint_blocks):
        lora[f"lora_unet_double_blocks_{i}_img_attn_qkv.lora_down.weight"] = (
            0.01 * rng.standard_normal((16, d.dim), dtype=np.float32))
        lora[f"lora_unet_double_blocks_{i}_img_attn_qkv.lora_up.weight"] = (
            0.01 * rng.standard_normal((3 * d.dim, 16), dtype=np.float32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.load_lora(state_dict={k: torch.from_numpy(v) for k, v in lora.items()}, alpha=1.0)
    torch.cuda.synchronize()
    run("lora", {}, lora_merge_s=time.perf_counter() - t0)
    emit(dict(phase="flux_adapters_summary", steps=steps, adapter_weights_gib=weights,
              k1_launches={k: v.get("K1", 0) for k, v in launches.items()}, **CARD))
    return {"K1": sum(v.get("K1", 0) for v in launches.values())}


def sd3_configs(full: bool):
    """(DiT, CLIP-L, CLIP-G, T5, VAE): SD3.5-Large at its published widths
    and depth with T5 v1.1-XXL, or a small SD3 with a dual block (2 heads
    of 64, 3 layers) on tiny towers and no T5; the SD3 VAE either way."""
    import dataclasses
    from video_styler_tpu_torch.models.sd3_dit import SD35_LARGE, SD3_DIT_TINY
    from video_styler_tpu_torch.models.sd3_text_encoder import CLIP_L, CLIP_L_TINY
    from video_styler_tpu_torch.models.sd3_vae import SD3_VAE
    from video_styler_tpu_torch.models.sdxl import CLIP_G, CLIP_G_TINY
    from video_styler_tpu_torch.models.t5 import T5_V11_XXL
    if full:
        return SD35_LARGE, CLIP_L, CLIP_G, T5_V11_XXL, SD3_VAE
    dit = dataclasses.replace(SD3_DIT_TINY, context_dim=4096,
                              pooled_dim=CLIP_L_TINY.dim + CLIP_G_TINY.dim)
    return dit, CLIP_L_TINY, CLIP_G_TINY, None, SD3_VAE


def sd3_pipeline(torch, configs, device: str, seed: int = 0):
    from video_styler_tpu_torch.pipelines.sd3_image import SD3ImagePipeline
    from video_styler_tpu_torch.prompters.flux_prompter import (StubClipTokenizer,
                                                                StubT5Tokenizer)
    dit, clip_l, clip_g, t5, vae = configs
    toks = (StubClipTokenizer(clip_l.vocab), StubClipTokenizer(clip_g.vocab),
            None if t5 is None else StubT5Tokenizer(t5.vocab))
    return SD3ImagePipeline.from_configs(dit, clip_l, clip_g, t5, vae, toks, seed=seed,
                                         device=device, dtype=torch.bfloat16)


def check_sd3_reference(torch):
    """`sd3_reference`: the small SD3 of `sd3_configs(False)` (a dual
    block, RMS q/k norm) on the card against the same weights on the CPU:
    256x256, 2 steps, CFG 4 two-pass, t2i and a local prompt, latents
    within 5% relative L2 (both devices run the exact `sdpa`)."""
    cpu = sd3_pipeline(torch, sd3_configs(False), "cpu")
    gpu = copy.copy(cpu)
    gpu.device = torch.device("cuda")
    gpu.prompter = copy.copy(cpu.prompter)
    gpu.dit, gpu.vae_encoder, gpu.vae_decoder, gpu.prompter.te1, gpu.prompter.te2 = (
        copy.deepcopy(m).to("cuda") for m in (cpu.dit, cpu.vae_encoder, cpu.vae_decoder,
                                              cpu.prompter.te1, cpu.prompter.te2))
    res = dict(phase="sd3_reference", size=FLUX_REF_SIZE, steps=2, dit_dim=cpu.dit_cfg.dim,
               dit_heads=cpu.dit_cfg.num_heads, dual_blocks=cpu.dit_cfg.num_dual_blocks,
               latents_rel_l2={}, latents_tol=5e-2, **CARD)
    base = dict(prompt=FLUX_PROMPT, negative_prompt="blurry", cfg_scale=4.0,
                height=FLUX_REF_SIZE, width=FLUX_REF_SIZE, seed=42, num_inference_steps=2,
                return_latents=True)
    local = dict(local_prompts=["a red roof"], masks=[entity_mask(FLUX_REF_SIZE, 0, 0, 0.5, 1)],
                 mask_scales=[1.0])
    for name, request in (("t2i", {}), ("local_prompts", local)):
        lat_c = cpu(**base, **request).float()
        lat_g = gpu(**base, **request).float().cpu()
        res["latents_rel_l2"][name] = ((lat_g - lat_c).norm() / lat_c.norm()).item()
    emit(res)
    if not all(v <= 5e-2 for v in res["latents_rel_l2"].values()):
        raise AssertionError(f"SD3, card vs CPU disagree: {res}")


def run_sd3(torch, kernels, steps: int, shared):
    """`sd3`: SD3.5-Large at its published widths and depth (dim 2432, 38
    heads of 64, 38 layers, RMS q/k norm) with CLIP-L, CLIP-G, T5
    v1.1-XXL and the SD3 VAE, random bf16 weights (the VAE fp32) from a
    seed; `shared` (the FLUX phase's CLIP-L and T5 v1.1-XXL towers and
    its VAE's modules, the same shapes: (clip, t5, encoder, decoder))
    stands in for drawing those again. One
    1024x1024 request (4,096 image + 154 text tokens), CFG 7.5 two-pass,
    --steps steps: stage times, peak, no K1 launch (every attention is the
    exact `sdpa`); one step profiled by category (`sd3_profile`); the JAX
    default's 20-step request composed (`sd3_image`). -> (the
    launches, CLIP-G for the SDXL phases)."""
    from video_styler_tpu_torch.models import sd3_dit as D
    from video_styler_tpu_torch.models.sd3_text_encoder import init_clip_text_
    from video_styler_tpu_torch.models.sdxl import SDXLTextEncoder2
    from video_styler_tpu_torch.pipelines.sd3_image import SD3ImagePipeline
    from video_styler_tpu_torch.prompters.flux_prompter import StubClipTokenizer, StubT5Tokenizer
    from video_styler_tpu_torch.prompters.sd3_prompter import SD3Prompter
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dit, clip_l, clip_g, t5, _ = sd3_configs(True)
    # draw the DiT and CLIP-G; CLIP-L, T5 and the VAE's modules are FLUX's
    pipe = SD3ImagePipeline(device="cuda", dtype=torch.bfloat16)
    pipe.dit_cfg = dit
    pipe.dit = random_module(torch, D.SD3DiT, dit, D.init_sd3_dit_, 60, torch.bfloat16)
    te2 = random_module(torch, SDXLTextEncoder2, clip_g, init_clip_text_, 61, torch.bfloat16)
    clip, t5_model, pipe.vae_encoder, pipe.vae_decoder = shared
    pipe.prompter = SD3Prompter(StubClipTokenizer(clip_l.vocab), StubClipTokenizer(clip_g.vocab),
                                StubT5Tokenizer(t5.vocab), te1=clip, te2=te2, t5=t5_model)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    try:
        weights = {"dit": gib([pipe.dit]), "clip_l": gib([pipe.prompter.te1]),
                   "clip_g": gib([pipe.prompter.te2]), "t5": gib([pipe.prompter.t5]),
                   "vae": gib([pipe.vae_encoder, pipe.vae_decoder])}
        request = dict(prompt=FLUX_PROMPT, negative_prompt="blurry, dark", cfg_scale=SD3_CFG,
                       height=1024, width=1024, seed=42, num_inference_steps=steps,
                       t5_sequence_length=SD3_T5_LEN)
        for kern in kernels.values():
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        image = pipe(**request)
        total_s = time.perf_counter() - t0
        launches = {name: kern.launches for name, kern in kernels.items()}
        res = dict(phase="sd3", model="SD3.5-Large", dit_dim=dit.dim, dit_heads=dit.num_heads,
                   layers=dit.num_layers, size=1024, tokens=(1024 // 16) ** 2 + 77 + SD3_T5_LEN,
                   steps=steps, cfg=f"two-pass {SD3_CFG}", build_s=build_s,
                   weights_gib=weights, total_s=total_s, stages=dict(pipe.stage_times),
                   step_s=step_times(pipe),
                   stage_peak_gib={k: v / 2**30 for k, v in pipe.stage_peak_bytes},
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                   image_size=list(image.size), launches={k: v for k, v in launches.items() if v},
                   expected_launches={}, **CARD)
        emit(res)
        check_launches(launches, {}, "sd3")
        measured = {k: launches[k] for k in ("K1", "K4", "K5")}
        if image.size != (1024, 1024):
            raise AssertionError(f"sd3: image {image.size}")
        # one two-pass DiT step under the profiler, on this request's inputs
        from video_styler_tpu_torch.ops.attention import sdpa
        from video_styler_tpu_torch.pipelines.wan_video import generate_noise
        posi = pipe.encode_prompt(FLUX_PROMPT, SD3_T5_LEN)
        nega = pipe.encode_prompt("blurry, dark", SD3_T5_LEN)
        latents = generate_noise((1, 16, 128, 128), seed=42).to("cuda", torch.bfloat16)
        t = torch.tensor([float(pipe.scheduler.timesteps[0])], device="cuda")
        with torch.no_grad():
            def one_step():
                v_p = D.sd3_dit_forward(pipe.dit, latents, t, *posi)
                v_n = D.sd3_dit_forward(pipe.dit, latents, t, *nega)
                return v_n + SD3_CFG * (v_p - v_n)
            prof = profile_request(torch, one_step, min(step_times(pipe)),
                                   categories=SD3_CATEGORIES)
            q = torch.randn(1, res["tokens"], dit.num_heads, 64, device="cuda",
                            dtype=torch.bfloat16)
            sdpa_ms = time_ms(torch, lambda: sdpa(q, q, q), reps=5)
        emit({"phase": "sd3_profile", "forwards": 2, "sdpa_call_ms": sdpa_ms,
              "sdpa_calls_a_step": 2 * dit.num_layers, **prof, **CARD})
        composed_request("sd3_image", res["stages"], res["step_s"], SD3_RECIPE_STEPS,
                         size=1024, cfg=f"two-pass {SD3_CFG}")
        return measured, te2
    finally:
        del pipe
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# SD 1.5 and SDXL (and Kolors), images and video
# ---------------------------------------------------------------------------

SD_PROMPT = "a lighthouse on a cliff at dawn, oil painting"
SD_NEGATIVE = "blurry, dark"
SD_CFG = 7.5
SD_RECIPE_STEPS = 20        # the JAX pipelines' default
SD_REF_SIZE = 128           # the references: 16x16 latents
SD_VIDEO_FRAMES = 16        # one AnimateDiff window
SD_VIDEO_LONG = 24          # two windows of 16 every 8: the triangle blend runs
DIFFUTOON_FRAMES = 8
SD_CATEGORIES = (  # one two-pass UNet step's device time, by category
    ("attention fp32 GEMM", ("f32f32_f32f32", "sgemm", "simt", "gemm_f32")),
    ("softmax", ("SoftMax", "softmax")),
    ("conv", ("fprop", "dgrad", "wgrad", "cudnn", "convolve", "conv2d", "implicit")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("elementwise", ("elementwise", "reduce_kernel", "CatArrayBatchedCopy", "layer_norm",
                     "group_norm", "copy_kernel", "index", "fill")),
)


def sd_attention_calls(torch, program, cfg, passes: int) -> int:
    """Exact-attention calls of `passes` UNet passes: a self and a cross
    attention per transformer of each attention block."""
    from video_styler_tpu_torch.models.sd import unet_blocks
    with torch.device("meta"):
        blocks = unet_blocks(program, cfg)
    return passes * sum(2 * len(b.transformer_blocks) for (kind, _), b in zip(program, blocks)
                        if kind == "attn")


def run_counted(torch, kernels, fn):
    """fn() with every launch count set to 0 just before and read just
    after; the peak memory of the run. -> (result, seconds, launches,
    peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    return out, seconds, launches, torch.cuda.max_memory_allocated() / 2**30


def sd_result(phase: str, pipe, seconds: float, launches: dict, peak: float, **extra) -> dict:
    """A phase's line: stage seconds, step seconds, peaks, K1/K4/K5
    launches (0: the exact `sdpa` is the route, as in JAX)."""
    res = dict(phase=phase, total_s=seconds, stages={k: v for k, v in pipe.stage_times
                                                     if not k.startswith("denoise_step_")},
               step_s=step_times(pipe), max_memory_allocated_gib=peak,
               stage_peak_gib=max((v for _, v in pipe.stage_peak_bytes), default=0) / 2**30,
               launches_k1_k4_k5={k: launches[k] for k in ("K1", "K4", "K5")},
               launches={k: v for k, v in launches.items() if v}, **extra, **CARD)
    emit(res)
    check_launches(launches, {}, phase)
    return res


def sd_profile(torch, phase: str, step, unprofiled_s: float, q_shape, calls: int):
    """One two-pass UNet step under the profiler by category, and one
    exact `sdpa` call at the largest attention's shape."""
    from video_styler_tpu_torch.ops.attention import sdpa
    with torch.no_grad():
        prof = profile_request(torch, step, unprofiled_s, categories=SD_CATEGORIES)
        q = torch.randn(*q_shape, device="cuda", dtype=torch.bfloat16)
        sdpa_ms = time_ms(torch, lambda: sdpa(q, q, q), reps=5)
    cats = prof["device_ms_by_category"]
    attn = cats.get("attention fp32 GEMM", 0.0) + cats.get("softmax", 0.0)
    emit({"phase": phase, "forwards": 2, "sdpa_call_ms": sdpa_ms, "sdpa_call_shape": q_shape,
          "sdpa_calls_a_step": calls,
          "exact_attention_share": attn / prof["device_busy_ms"] if prof["device_busy_ms"]
          else None, **prof, **CARD})


def video_profile(torch, pipe, phase: str, shape, unet, q_shape, calls: int):
    """One two-pass window step of a video pipeline under the profiler (the
    motion modules in the UNet), as `sd_profile` does for an image."""
    from video_styler_tpu_torch.pipelines.wan_video import generate_noise
    posi = pipe.encode_prompt(SD_PROMPT)
    nega = pipe.encode_prompt(SD_NEGATIVE)
    latents = generate_noise(shape, seed=42).to("cuda", torch.bfloat16)
    t = torch.tensor([999.0], device="cuda")

    def one_step():
        e_p, e_n = unet(latents, t, posi), unet(latents, t, nega)
        return e_n + SD_CFG * (e_p - e_n)
    sd_profile(torch, phase, one_step, min(step_times(pipe)), q_shape, calls)


def sd_reference_pipes(torch, kind: str):
    """(CPU, card) pipelines of the tiny SD / SDXL / AnimateDiff / Kolors
    configs on the same fp32 weights."""
    from video_styler_tpu_torch.models import kolors_text_encoder as K
    from video_styler_tpu_torch.models import motion as M
    from video_styler_tpu_torch.models import sd as S
    from video_styler_tpu_torch.models import sdxl as X
    from video_styler_tpu_torch.pipelines.sd_image import SDImagePipeline
    from video_styler_tpu_torch.pipelines.sd_video import SDVideoPipeline
    from video_styler_tpu_torch.pipelines.sdxl_image import SDXLImagePipeline
    from video_styler_tpu_torch.prompters.flux_prompter import StubClipTokenizer
    f32 = torch.float32
    if kind == "sdxl":
        cpu = SDXLImagePipeline.from_configs(X.SDXL_UNET_TINY, X.CLIP_L_TINY_12, X.CLIP_G_TINY,
                                             seed=80, device="cpu", dtype=f32)
        names = ("unet", "te1", "te2", "vae_encoder", "vae_decoder")
    elif kind == "kolors":
        import dataclasses
        cfg = dataclasses.replace(X.SDXL_UNET_TINY, add_embed_dim=32 + 6 * 256,
                                  text_proj_dim=K.CHATGLM_TINY.hidden_size)
        cpu = SDXLImagePipeline.from_configs(cfg, X.CLIP_L_TINY_12, X.CLIP_G_TINY, seed=81,
                                             device="cpu", dtype=f32)
        cpu.fetch_kolors_text_encoder(K.init_chatglm_(
            K.ChatGLM(K.CHATGLM_TINY, dtype=f32), torch.Generator().manual_seed(82)).eval())
        names = ("unet", "vae_encoder", "vae_decoder", "kolors")
    else:
        cls = SDVideoPipeline if kind == "sd_video" else SDImagePipeline
        cpu = cls.from_configs(S.SD_UNET_TINY, X.CLIP_L_TINY_12,
                               StubClipTokenizer(X.CLIP_L_TINY_12.vocab), seed=83,
                               device="cpu", dtype=f32)
        names = ("unet", "text_encoder", "vae_encoder", "vae_decoder")
        if kind == "sd_video":
            with torch.device("meta"):
                mm = M.sd_motion_model(S.SD_UNET_TINY, dtype=f32)
            cpu.motion_modules = S.init_sd_module_(mm.to_empty(device="cpu"),
                                                   torch.Generator().manual_seed(84)).eval()
            names += ("motion_modules",)
    gpu = copy.copy(cpu)
    gpu.device = torch.device("cuda")
    for name in names:
        setattr(gpu, name, copy.deepcopy(getattr(cpu, name)).to("cuda"))
    return cpu, gpu


def check_sd_references(torch):
    """`sd_reference`, `sdxl_reference`, `sd_video_reference`: the tiny SD
    1.5 (t2i, a local prompt), SDXL (t2i, Kolors on a tiny ChatGLM) and
    AnimateDiff (6 frames in windows of 4 every 2: two overlapping) on the
    card against the same weights on the CPU, 128x128, 2 steps, CFG 5
    two-pass: latents within 5% relative L2 (both run the exact `sdpa`).
    In fp32 (the port keeps TF32 off): in bf16 the two devices' roundings
    through a tiny random UNet's 49-67 blocks, amplified by CFG, reach
    4.5-5.5% on an H100, a random walk and not a fault."""
    base = dict(prompt=SD_PROMPT, negative_prompt=SD_NEGATIVE, cfg_scale=5.0,
                height=SD_REF_SIZE, width=SD_REF_SIZE, seed=42, num_inference_steps=2,
                return_latents=True)
    cases = {"sd_reference": [("sd", "t2i", {}),
                              ("sd", "local_prompts", dict(
                                  local_prompts=["a red roof"], mask_scales=[1.0],
                                  masks=[entity_mask(SD_REF_SIZE, 0, 0, 0.5, 1)]))],
             "sdxl_reference": [("sdxl", "t2i", {}), ("kolors", "kolors", {})],
             "sd_video_reference": [("sd_video", "two_windows", dict(
                 num_frames=6, animatediff_batch_size=4, animatediff_stride=2))]}
    for phase, runs in cases.items():
        t0 = time.perf_counter()
        res = dict(phase=phase, size=SD_REF_SIZE, steps=2, latents_rel_l2={},
                   latents_tol=5e-2, **CARD)
        for kind, name, request in runs:
            cpu, gpu = sd_reference_pipes(torch, kind)
            lat_c = cpu(**base, **request).float()
            lat_g = gpu(**base, **request).float().cpu()
            res["latents_rel_l2"][name] = ((lat_g - lat_c).norm() / lat_c.norm()).item()
        res["seconds"] = time.perf_counter() - t0
        emit(res)
        if not all(v <= 5e-2 for v in res["latents_rel_l2"].values()):
            raise AssertionError(f"{phase}: card vs CPU disagree: {res}")


def run_sd(torch, kernels, steps: int, clip_l):
    """`sd`: SD 1.5 at its published widths (the 860 M UNet; CLIP-L, here
    the FLUX phase's tower, the same 12 layers; the SD VAE), random bf16
    weights (the VAE fp32) from a seed. 512x512, CFG 7.5 two-pass, DDIM:
    --steps steps (stage and step seconds, peak, K1/K4/K5 launches: 0),
    one step profiled (`sd_profile`), the 20-step request (`sd_image`),
    and one request with a canny ControlNet unit and the IP-Adapter from a
    picture through the CLIP-H image encoder (`sd_adapters`). -> (the
    launches, the pipeline for `run_sd_video`)."""
    from video_styler_tpu_torch.controlnets import Annotator, ControlNetUnit
    from video_styler_tpu_torch.models import ipadapter as I
    from video_styler_tpu_torch.models import sd as S
    from video_styler_tpu_torch.models import svd as SV
    from video_styler_tpu_torch.models.controlnet import ControlNet, ControlNetConfig
    from video_styler_tpu_torch.pipelines.sd_image import SDImagePipeline
    from video_styler_tpu_torch.pipelines.wan_video import generate_noise
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    pipe = SDImagePipeline(device="cuda", dtype=bf16)
    pipe.unet = random_module(torch, S.SDUNet, S.SD_UNET, S.init_sd_module_, 70, bf16)
    pipe.text_encoder = clip_l
    pipe.vae_encoder = random_module(torch, S.SDVAEEncoder, None, S.init_sd_module_, 71,
                                     torch.float32)
    pipe.vae_decoder = random_module(torch, S.SDVAEDecoder, None, S.init_sd_module_, 72,
                                     torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    request = dict(prompt=SD_PROMPT, negative_prompt=SD_NEGATIVE, cfg_scale=SD_CFG,
                   height=512, width=512, seed=42, num_inference_steps=steps)
    image, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
    sd_result("sd", pipe, seconds, launches, peak, model="SD 1.5", size=512, steps=steps,
              cfg=f"two-pass {SD_CFG}", build_s=build_s,
              weights_gib={"unet": gib([pipe.unet]), "clip_l": gib([clip_l]),
                           "vae": gib([pipe.vae_encoder, pipe.vae_decoder])},
              image_size=list(image.size))
    if image.size != (512, 512):
        raise AssertionError(f"sd: image {image.size}")
    posi = pipe.encode_prompt(SD_PROMPT)
    nega = pipe.encode_prompt(SD_NEGATIVE)
    latents = generate_noise((1, 4, 64, 64), seed=42).to("cuda", bf16)
    t = torch.tensor([999.0], device="cuda")

    def one_step():
        e_p = S.sd_unet_forward(pipe.unet, latents, t, posi)
        e_n = S.sd_unet_forward(pipe.unet, latents, t, nega)
        return e_n + SD_CFG * (e_p - e_n)
    sd_profile(torch, "sd_profile", one_step, min(step_times(pipe)), (1, 4096, 8, 40),
               sd_attention_calls(torch, S.SD_UNET_PROGRAM, S.SD_UNET, 2))
    image, seconds, _, _ = run_counted(
        torch, kernels, lambda: pipe(**{**request, "num_inference_steps": SD_RECIPE_STEPS}))
    steps_20 = step_times(pipe)
    emit(dict(phase="sd_image", steps=SD_RECIPE_STEPS, size=512, image_s=seconds,
              step_s_first=steps_20[0], step_s_rest_mean=sum(steps_20[1:]) / (len(steps_20) - 1),
              step_s_min=min(steps_20), step_s_max=max(steps_20), **CARD))
    if len(steps_20) != SD_RECIPE_STEPS:
        raise AssertionError(f"sd_image: {len(steps_20)} steps")
    cn = random_module(torch, ControlNet, ControlNetConfig(), S.init_sd_module_, 73, bf16)
    ip = random_module(torch, I.IpAdapter, I.ipadapter_config(False), S.init_sd_module_, 74, bf16)
    pipe.image_encoder = random_module(torch, SV.SVDImageEncoder, SV.SVD_IMAGE_ENCODER,
                                       S.init_sd_module_, 75, bf16)
    adapters = dict(controlnet_image=synthetic_image(3, 512),
                    controlnet_units=[ControlNetUnit(Annotator("canny"), cn, 1.0)],
                    ipadapter_images=[synthetic_image(4, 512)], ipadapter_params=ip,
                    ipadapter_scale=0.6)
    image, seconds, launches, peak = run_counted(torch, kernels,
                                                 lambda: pipe(**request, **adapters))
    sd_result("sd_adapters", pipe, seconds, launches, peak, steps=steps,
              units=["canny ControlNet (361 M)", "IP-Adapter (22 M) + CLIP-H (632 M)"],
              weights_gib={"controlnet": gib([cn]), "ipadapter": gib([ip]),
                           "image_encoder": gib([pipe.image_encoder])})
    pipe.image_encoder = None
    del cn, ip
    return {k: launches[k] for k in ("K1", "K4", "K5")}, pipe


def write_frames(folder: str, frames):
    os.makedirs(folder, exist_ok=True)
    for i, f in enumerate(frames):
        f.save(os.path.join(folder, f"{i:03d}.png"))


def run_sd_video(torch, kernels, steps: int, sd_pipe):
    """`sd_video`: AnimateDiff on the `sd` phase's SD 1.5 (mm_sd_v15_v2's 21
    motion modules, 454 M, drawn from a seed): 16 frames at 512x512 in one
    window, CFG 7.5 two-pass, --steps steps, decoded; 24 frames, two
    windows of 16 every 8 blended (`sd_video_long`, latents); the Diffutoon
    runner on a JSON config (8 frames of 512x512 from an image folder,
    a tile ControlNet, denoising 0.7, a contrast pass at the end;
    `diffutoon`)."""
    from video_styler_tpu_torch.controlnets import (Annotator, ControlNetUnit,
                                                    MultiControlNetManager)
    from video_styler_tpu_torch.models import motion as M
    from video_styler_tpu_torch.models import sd as S
    from video_styler_tpu_torch.models.controlnet import ControlNet, ControlNetConfig
    from video_styler_tpu_torch.pipelines.pipeline_runner import SDVideoPipelineRunner
    from video_styler_tpu_torch.pipelines.sd_video import SDVideoPipeline
    from video_styler_tpu_torch.prompters.flux_prompter import StubClipTokenizer
    bf16 = torch.bfloat16
    pipe = SDVideoPipeline(device="cuda", dtype=bf16)
    for name in ("unet", "text_encoder", "vae_encoder", "vae_decoder"):
        setattr(pipe, name, getattr(sd_pipe, name))
    pipe.tokenizer = StubClipTokenizer(pipe.text_encoder.cfg.vocab)
    pipe.motion_modules = random_module(torch, lambda cfg, dtype: M.sd_motion_model(
        cfg, dtype=dtype), S.SD_UNET, S.init_sd_module_, 76, bf16)
    request = dict(prompt=SD_PROMPT, negative_prompt=SD_NEGATIVE, cfg_scale=SD_CFG,
                   height=512, width=512, seed=42, num_inference_steps=steps,
                   num_frames=SD_VIDEO_FRAMES)
    frames, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
    sd_result("sd_video", pipe, seconds, launches, peak, frames=SD_VIDEO_FRAMES, size=512,
              steps=steps, windows=1, cfg=f"two-pass {SD_CFG}",
              weights_gib={"motion_modules": gib([pipe.motion_modules])},
              frame_shape=list(frames[0].shape))
    if len(frames) != SD_VIDEO_FRAMES or frames[0].shape != (512, 512, 3):
        raise AssertionError(f"sd_video: {len(frames)} frames of {frames[0].shape}")
    video_profile(torch, pipe, "sd_video_profile", (SD_VIDEO_FRAMES, 4, 64, 64),
                  lambda lat, t, ctx: S.sd_unet_forward(
                      pipe.unet, lat, t, ctx, motion=(pipe.motion_modules,
                                                      M.SD_MOTION_CALL_BLOCK_ID)),
                  (SD_VIDEO_FRAMES, 4096, 8, 40),
                  sd_attention_calls(torch, S.SD_UNET_PROGRAM, S.SD_UNET, 2))
    lat, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(
        **{**request, "num_frames": SD_VIDEO_LONG}, return_latents=True))
    sd_result("sd_video_long", pipe, seconds, launches, peak, frames=SD_VIDEO_LONG,
              windows=2, overlap=8, finite=bool(torch.isfinite(lat).all()))
    if not torch.isfinite(lat).all():
        raise AssertionError("sd_video_long: non-finite latents")
    cn = random_module(torch, ControlNet, ControlNetConfig(), S.init_sd_module_, 77, bf16)
    pipe.controlnet_manager = MultiControlNetManager([ControlNetUnit(Annotator("tile"), cn,
                                                                     1.0)])
    work = tempfile.mkdtemp(prefix="diffutoon_")
    try:
        src = os.path.join(work, "input")
        write_frames(src, [synthetic_image(10 + i, 512) for i in range(DIFFUTOON_FRAMES)])
        config = {"models": {"model_list": []},
                  "data": {"input_frames": {"image_folder": src, "height": 512, "width": 512},
                           "controlnet_frames": [{"image_folder": src, "height": 512,
                                                  "width": 512}],
                           "output_folder": os.path.join(work, "out"), "fps": 8},
                  "smoother_configs": [{"processor_type": "contrast", "rate": 1.2}],
                  "pipeline": {"seed": 0, "pipeline_inputs": {
                      "prompt": "a toon fox, flat colours", "negative_prompt": SD_NEGATIVE,
                      "cfg_scale": 7.0, "denoising_strength": 0.7, "num_inference_steps": steps,
                      "animatediff_batch_size": 16, "animatediff_stride": 8,
                      "smoother_progress_ids": [-1]}}}
        frames, seconds, launches, peak = run_counted(
            torch, kernels, lambda: SDVideoPipelineRunner(device="cuda").run(config, pipe=pipe))
        written = sorted(os.listdir(os.path.join(work, "out", "frames")))
        sd_result("diffutoon", pipe, seconds, launches, peak, frames=DIFFUTOON_FRAMES,
                  size=512, controlnet="tile (361 M)", frames_written=len(written),
                  video_bytes=os.path.getsize(os.path.join(work, "out", "video.mp4")))
        if len(written) != DIFFUTOON_FRAMES:
            raise AssertionError(f"diffutoon: {len(written)} frames written")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {k: launches[k] for k in ("K1", "K4", "K5")}


def run_sdxl(torch, kernels, steps: int, vae, clip_g):
    """`sdxl`: SDXL base at its published widths (the 2.57 B UNet, CLIP-L
    of 11 layers; `clip_g`: the `sd3` phase's CLIP-G; `vae`: the `sd`
    phase's SD VAE modules), random bf16 weights from a seed; 1024x1024, CFG 7.5 two-pass, --steps steps,
    one step profiled (`sdxl_profile`), the 20-step request composed
    (`sdxl_image`); the union ControlNet (`sdxl_controlnet`) and the
    IP-Adapter's full 70-site map from image embeds (`sdxl_ipadapter`).
    -> (the launches, the pipeline for `run_sdxl_video`)."""
    from video_styler_tpu_torch.controlnets import Annotator, ControlNetUnit
    from video_styler_tpu_torch.models import ipadapter as I
    from video_styler_tpu_torch.models import sd as S
    from video_styler_tpu_torch.models import sdxl as X
    from video_styler_tpu_torch.models.controlnet import ControlNet, ControlNetConfig
    from video_styler_tpu_torch.pipelines.sdxl_image import SDXLImagePipeline
    from video_styler_tpu_torch.pipelines.wan_video import generate_noise
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    pipe = SDXLImagePipeline(device="cuda", dtype=bf16)
    pipe.unet = random_module(torch, X.SDXLUNet, X.SDXL_UNET, S.init_sd_module_, 90, bf16)
    pipe.te1 = random_module(torch, X.SDXLTextEncoder, X.SDXL_CLIP_L, S.init_sd_module_, 91, bf16)
    pipe.te2 = clip_g
    pipe.vae_encoder, pipe.vae_decoder = vae
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    request = dict(prompt=SD_PROMPT, negative_prompt=SD_NEGATIVE, cfg_scale=SD_CFG,
                   height=1024, width=1024, seed=42, num_inference_steps=steps)
    image, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
    res = sd_result("sdxl", pipe, seconds, launches, peak, model="SDXL base", size=1024,
                    steps=steps, cfg=f"two-pass {SD_CFG}", build_s=build_s,
                    weights_gib={"unet": gib([pipe.unet]), "clip_l": gib([pipe.te1]),
                                 "clip_g": gib([pipe.te2])}, image_size=list(image.size))
    if image.size != (1024, 1024):
        raise AssertionError(f"sdxl: image {image.size}")
    posi, pooled_p = pipe.encode_prompt(SD_PROMPT)
    nega, pooled_n = pipe.encode_prompt(SD_NEGATIVE)
    latents = generate_noise((1, 4, 128, 128), seed=42).to("cuda", bf16)
    t = torch.tensor([999.0], device="cuda")
    add_time = pipe.add_time_id(1024, 1024)

    def one_step():
        e_p = X.sdxl_unet_forward(pipe.unet, latents, t, posi, add_time, pooled_p)
        e_n = X.sdxl_unet_forward(pipe.unet, latents, t, nega, add_time, pooled_n)
        return e_n + SD_CFG * (e_p - e_n)
    sd_profile(torch, "sdxl_profile", one_step, min(step_times(pipe)), (1, 4096, 10, 64),
               sd_attention_calls(torch, X.SDXL_UNET_PROGRAM, X.SDXL_UNET, 2))
    composed_request("sdxl_image", res["stages"], res["step_s"], SD_RECIPE_STEPS, size=1024,
                     cfg=f"two-pass {SD_CFG}")
    cn = random_module(torch, ControlNet, ControlNetConfig(X.SDXL_UNET, union=True),
                       S.init_sd_module_, 93, bf16)
    image, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(
        **request, controlnet_image=synthetic_image(5, 1024),
        controlnet_units=[ControlNetUnit(Annotator("canny"), cn, 1.0, xl=True)]))
    sd_result("sdxl_controlnet", pipe, seconds, launches, peak, steps=steps,
              controlnet="union, canny (1.26 B)", weights_gib={"controlnet": gib([cn])})
    del cn
    ip = random_module(torch, I.IpAdapter, I.ipadapter_config(True, X.SDXL_UNET, clip_dim=1280),
                       S.init_sd_module_, 94, bf16)
    embeds = torch.randn(1, 1280, generator=torch.Generator().manual_seed(95))
    image, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(
        **request, ipadapter_params=ip, ipadapter_image_embeds=embeds, ipadapter_scale=0.6))
    sd_result("sdxl_ipadapter", pipe, seconds, launches, peak, steps=steps, sites=70,
              weights_gib={"ipadapter": gib([ip])})
    return {k: launches[k] for k in ("K1", "K4", "K5")}, pipe, ip


def run_sdxl_video(torch, kernels, steps: int, xl_pipe, ip):
    """`sdxl_video`: SDXL AnimateDiff on the `sdxl` phase's modules (the
    SDXL motion model's 15 modules, 237 M, drawn from a seed): 16 frames at
    1024x1024 in one window, CFG 7.5 two-pass, --steps steps, decoded; once
    more with the IP-Adapter under InstantStyle (`sdxl_video_ipadapter`,
    latents)."""
    from video_styler_tpu_torch.models import motion as M
    from video_styler_tpu_torch.models import sd as S
    from video_styler_tpu_torch.models import sdxl as X
    from video_styler_tpu_torch.pipelines.sdxl_video import SDXLVideoPipeline
    bf16 = torch.bfloat16
    pipe = SDXLVideoPipeline(device="cuda", dtype=bf16)
    for name in ("unet", "te1", "te2", "vae_encoder", "vae_decoder"):
        setattr(pipe, name, getattr(xl_pipe, name))
    pipe.motion_modules = random_module(torch, lambda cfg, dtype: M.sdxl_motion_model(
        cfg, dtype=dtype), X.SDXL_UNET, S.init_sd_module_, 96, bf16)
    request = dict(prompt=SD_PROMPT, negative_prompt=SD_NEGATIVE, cfg_scale=SD_CFG,
                   height=1024, width=1024, seed=42, num_inference_steps=steps,
                   num_frames=SD_VIDEO_FRAMES)
    frames, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
    sd_result("sdxl_video", pipe, seconds, launches, peak, frames=SD_VIDEO_FRAMES, size=1024,
              steps=steps, windows=1, weights_gib={"motion_modules": gib([pipe.motion_modules])},
              frame_shape=list(frames[0].shape))
    if len(frames) != SD_VIDEO_FRAMES or frames[0].shape != (1024, 1024, 3):
        raise AssertionError(f"sdxl_video: {len(frames)} frames of {frames[0].shape}")
    add_time = pipe.add_time_id(1024, 1024)
    video_profile(torch, pipe, "sdxl_video_profile", (SD_VIDEO_FRAMES, 4, 128, 128),
                  lambda lat, t, ctx: X.sdxl_unet_forward(
                      pipe.unet, lat, t, ctx[0], add_time, ctx[1],
                      motion=(pipe.motion_modules, M.SDXL_MOTION_CALL_BLOCK_ID)),
                  (SD_VIDEO_FRAMES, 4096, 10, 64),
                  sd_attention_calls(torch, X.SDXL_UNET_PROGRAM, X.SDXL_UNET, 2))
    pipe.ipadapter = ip
    embeds = torch.randn(1, 1280, generator=torch.Generator().manual_seed(97))
    lat, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(
        **request, ipadapter_image_embeds=embeds, ipadapter_use_instant_style=True,
        return_latents=True))
    sd_result("sdxl_video_ipadapter", pipe, seconds, launches, peak, instant_style_sites=10,
              finite=bool(torch.isfinite(lat).all()))
    if not torch.isfinite(lat).all():
        raise AssertionError("sdxl_video_ipadapter: non-finite latents")
    return {k: launches[k] for k in ("K1", "K4", "K5")}


def run_kolors(torch, kernels, steps: int, xl_pipe):
    """`kolors`: Kolors on the card: ChatGLM3-6B (28 layers of 4096, drawn
    from a seed) in place of the CLIP towers and the Kolors UNet (SDXL's
    with the 5632-wide add embedding and the 4096 -> 2048 text
    projection), 1024x1024, CFG 7.5 two-pass, --steps steps."""
    from video_styler_tpu_torch.models import kolors_text_encoder as K
    from video_styler_tpu_torch.models import sd as S
    from video_styler_tpu_torch.models import sdxl as X
    from video_styler_tpu_torch.pipelines.sdxl_image import SDXLImagePipeline
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    pipe = SDXLImagePipeline(device="cuda", dtype=bf16)
    pipe.vae_encoder, pipe.vae_decoder = xl_pipe.vae_encoder, xl_pipe.vae_decoder
    pipe.unet = random_module(torch, X.SDXLUNet, X.KOLORS_UNET, S.init_sd_module_, 98, bf16)
    pipe.fetch_kolors_text_encoder(random_module(torch, K.ChatGLM, K.CHATGLM3_6B,
                                                 K.init_chatglm_, 99, bf16))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    request = dict(prompt=SD_PROMPT, negative_prompt=SD_NEGATIVE, cfg_scale=SD_CFG,
                   height=1024, width=1024, seed=42, num_inference_steps=steps)
    image, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
    sd_result("kolors", pipe, seconds, launches, peak, steps=steps, build_s=build_s,
              weights_gib={"unet": gib([pipe.unet]), "chatglm3_6b": gib([pipe.kolors])},
              image_size=list(image.size))
    return {k: launches[k] for k in ("K1", "K4", "K5")}


def run_sd_family(torch, kernels, steps: int, clip_l, clip_g) -> dict:
    """The SD family's references and phases, on a card free of the other
    families' models (`clip_l`: the FLUX phase's CLIP-L, `clip_g`: the SD3
    phase's CLIP-G). -> launches by path."""
    check_sd_references(torch)
    out = {}
    out["sd"], sd_pipe = run_sd(torch, kernels, steps, clip_l)
    out["sd_video"] = run_sd_video(torch, kernels, steps, sd_pipe)
    vae = (sd_pipe.vae_encoder, sd_pipe.vae_decoder)
    del sd_pipe
    gc.collect()
    torch.cuda.empty_cache()
    out["sdxl"], xl_pipe, ip = run_sdxl(torch, kernels, steps, vae, clip_g)
    out["sdxl_video"] = run_sdxl_video(torch, kernels, steps, xl_pipe, ip)
    del ip
    xl_pipe.unet = xl_pipe.te1 = xl_pipe.te2 = None
    gc.collect()
    torch.cuda.empty_cache()
    out["kolors"] = run_kolors(torch, kernels, steps, xl_pipe)
    del xl_pipe, vae
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Qwen-Image: the Qwen2.5-VL towers, the 20B DiT, its VAE and adapters
# ---------------------------------------------------------------------------

QWEN_HEADS = 24             # Qwen-Image: 24 heads of 128
QWEN_SIZE = 1328            # the pipeline's default: 83 x 83 = 6,889 image tokens
QWEN_ADAPTER_SIZE = 1024    # the edit and adapter requests
QWEN_REF_SIZE = 256         # qwen_reference: 16 x 16 image tokens
QWEN_CFG = 4.0              # the pipeline's default, two-pass
QWEN_RECIPE_STEPS = 30      # the pipeline's default step count
QWEN_PROMPT = ("a lighthouse on a cliff at dawn, waves breaking on the rocks below, "
               "seagulls over the water, oil painting with thick brush strokes")
QWEN_NEGATIVE = "blurry, low quality"
QWEN_EDIT_PROMPT = "turn it into a watercolor painting at dusk"
QWEN_CATEGORIES = (  # one two-pass DiT step's device time, by category
    ("K1", ("flash_fwd_capped_kernel",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("elementwise", ("elementwise", "reduce_kernel", "CatArrayBatchedCopy", "layer_norm",
                     "copy_kernel", "index", "fill", "softmax")),
)


def qwen_edit_merged_tokens(size: int) -> int:
    """Merged vision tokens of a size x size edit image (the processor's
    smart resize at its default pixel budget)."""
    from video_styler_tpu_torch.models.qwen_vl_vision import smart_resize
    h, w = smart_resize(size, size, 28, 56 * 56, 28 * 28 * 1280)
    return (h // 28) * (w // 28)


_QWEN_LENS = {}


def qwen_joint_lens() -> dict:
    """Every [text | image] length that K1 gets on the qwen, qwen_edit and
    qwen_adapters requests, for the positive and the negative prompt: the
    rows of the pipeline's own `encode_prompt` / `encode_prompt_edit` plus
    the image tokens (and the edit image's extra latent). The stand-in
    tokenizer's rows do not depend on the towers' widths, so the small CPU
    towers of `qwen_reference_configs` give them; `run_qwen` holds the
    full-width encoder's rows to this table. EliGen's positive pass is the
    exact `sdpa`, its negative pass the 1024 negative length."""
    if not _QWEN_LENS:
        import torch
        from video_styler_tpu_torch.pipelines.qwen_image import QwenImagePipeline
        _, text, vision, _ = qwen_reference_configs()
        pipe = QwenImagePipeline(device="cpu")
        pipe.use_text_encoder(qwen_vl(torch, text, vision, "cpu"))
        edit = [qwen_adapter_requests(QWEN_ADAPTER_SIZE)["edit"]["edit_image"]]
        with torch.no_grad():
            _, _, cache = pipe.encode_prompt_edit(QWEN_EDIT_PROMPT, edit)
            for tag, size, rows in (
                    ("t2i", QWEN_SIZE, lambda p: pipe.encode_prompt(p)[0]),
                    ("1024", QWEN_ADAPTER_SIZE, lambda p: pipe.encode_prompt(p)[0]),
                    ("edit", QWEN_ADAPTER_SIZE,
                     lambda p: pipe.encode_prompt_edit(p, edit, _cache=cache)[0])):
                image = (size // 16) ** 2 * (2 if tag == "edit" else 1)
                prompt = QWEN_EDIT_PROMPT if tag == "edit" else QWEN_PROMPT
                _QWEN_LENS[tag] = rows(prompt).shape[1] + image
                _QWEN_LENS[f"{tag}-negative"] = rows(QWEN_NEGATIVE).shape[1] + image
    return dict(_QWEN_LENS)


def check_qwen_kernels(torch):
    """`qwen_kernels`: K1 at the Qwen-Image DiT's joint attention, 24 heads of
    128 over every [text | image] length of `qwen_joint_lens` (the t2i
    request at 1328x1328, the adapters' at 1024x1024 and the edit's with
    its extra latent, each for the positive and the negative prompt), held
    against its plain version (two bf16 ULPs)."""
    rows = []
    for tag, s in qwen_joint_lens().items():
        rows += check_kernels(torch, (1, 1, s), f"qwen-{tag}", heads=QWEN_HEADS, cross_lens=(),
                              norms=False)
    return rows


def qwen_reference_configs():
    """A small Qwen-Image with head dim 128 (dim 256, 2 heads, the release's
    RoPE axes, 2 blocks), a Qwen2.5-VL text tower of 2 layers (2 heads of
    128, one k/v head) and a vision tower of 4 blocks (2 heads of 80), a
    2-block ControlNet, the release-width Wan2.1 VAE."""
    import dataclasses
    from video_styler_tpu_torch.models.llm_decoder import QWEN25_VL_7B_TEXT
    from video_styler_tpu_torch.models.qwen_image_controlnet import QwenBlockwiseCNConfig
    from video_styler_tpu_torch.models.qwen_image_dit import QWEN_IMAGE
    from video_styler_tpu_torch.models.qwen_vl_vision import QWEN25_VL_7B_VISION
    text = dataclasses.replace(QWEN25_VL_7B_TEXT, vocab_size=2048, hidden=256, num_layers=2,
                               num_heads=2, num_kv_heads=1, ffn=512)
    vision = dataclasses.replace(QWEN25_VL_7B_VISION, depth=4, hidden=160, num_heads=2,
                                 intermediate=256, out_hidden=256, fullatt=(3,))
    dit = dataclasses.replace(QWEN_IMAGE, dim=256, num_heads=2, num_layers=2, text_dim=256)
    cn = QwenBlockwiseCNConfig(num_layers=2, dim=256)
    return dit, text, vision, cn


def qwen_vl(torch, text_cfg, vision_cfg, device: str, seed: int = 1):
    """Qwen2.5-VL towers of random bf16 weights from a seed, with the
    stand-in tokenizer."""
    from video_styler_tpu_torch.models.qwen_vl_embedder import QwenVL, StubQwenTokenizer
    tok = StubQwenTokenizer(text_cfg.vocab_size)
    s = tok.special_ids
    return QwenVL.from_configs(text_cfg, vision_cfg, tok, seed=seed, device=device,
                               dtype=torch.bfloat16, image_token_id=s["<|image_pad|>"],
                               video_token_id=s["<|video_pad|>"],
                               vision_end_token_id=s["<|vision_end|>"])


def qwen_pipeline(torch, dit_cfg, text_cfg, vision_cfg, device: str, seed: int = 0):
    """A Qwen-Image pipeline of random bf16 weights (the VAE fp32) from a
    seed, with the stand-in tokenizer."""
    from video_styler_tpu_torch.pipelines.qwen_image import QwenImagePipeline
    return QwenImagePipeline.from_configs(
        dit_cfg, qwen_vl(torch, text_cfg, vision_cfg, device, seed + 1), seed=seed,
        device=device, dtype=torch.bfloat16)


def random_blockwise_cn(torch, cfg, device: str, seed: int):
    from video_styler_tpu_torch.models import qwen_image_controlnet as QC
    from video_styler_tpu_torch.models.flux_dit import init_flux_dit_
    gen = torch.Generator(device).manual_seed(seed)
    with torch.device("meta"):
        cn = QC.QwenBlockwiseControlNet(cfg, dtype=torch.bfloat16)
    return init_flux_dit_(cn.to_empty(device=device), gen).eval()


def qwen_adapter_requests(size: int) -> dict:
    """The reference's and the qwen_adapters phase's requests beyond t2i:
    an edit, EliGen with two entities, the block-wise ControlNet (active the
    first half), inpaint and img2img; CFG 4 two-pass."""
    from video_styler_tpu_torch.pipelines.qwen_image import ControlNetInput
    img = synthetic_image(5, size)
    return {
        "edit": dict(edit_image=synthetic_image(6, size), prompt=QWEN_EDIT_PROMPT),
        "eligen": dict(eligen_entity_prompts=["a red lighthouse", "a purple sky"],
                       eligen_entity_masks=[entity_mask(size, 0.1, 0.3, 0.9, 0.7),
                                            entity_mask(size, 0.0, 0.0, 0.4, 1.0)]),
        "controlnet": dict(blockwise_controlnet_inputs=[ControlNetInput(
            controlnet_id=0, scale=0.8, start=1.0, end=0.5, image=synthetic_image(7, size))]),
        "inpaint": dict(input_image=img, inpaint_mask=entity_mask(size, 0.25, 0.25, 0.75, 0.75),
                        denoising_strength=0.9),
        "img2img": dict(input_image=img, denoising_strength=0.6),
    }


def check_qwen_reference(torch, kernels):
    """`qwen_reference`: the small pipeline of `qwen_reference_configs` on
    the card (K1) against the same weights on the CPU (plain versions),
    bf16: 256x256, 2 steps, t2i at CFG 1 and CFG 4, an edit (the vision
    tower and one extra latent), EliGen and the block-wise ControlNet at
    CFG 4; latents within 5% relative L2, the fp32 decode of the CPU's
    CFG-1 latents on both devices within 2 levels; K1's launches on the card
    against blocks x passes x steps (one pass at CFG 1 and under EliGen,
    whose positive pass is the exact `sdpa`)."""
    import numpy as np
    from video_styler_tpu_torch.models.qwen_vl_embedder import QwenVL
    dit, text, vision, cn_cfg = qwen_reference_configs()
    cpu = qwen_pipeline(torch, dit, text, vision, "cpu")
    cpu.blockwise_controlnets = [random_blockwise_cn(torch, cn_cfg, "cpu", 3)]
    gpu = copy.copy(cpu)
    gpu.device = torch.device("cuda")
    gpu.dit, gpu.vae = (copy.deepcopy(m).to("cuda") for m in (cpu.dit, cpu.vae))
    gpu.blockwise_controlnets = [copy.deepcopy(cpu.blockwise_controlnets[0]).to("cuda")]
    vl = cpu._vl
    gpu.use_text_encoder(QwenVL(copy.deepcopy(vl.text).to("cuda"),
                                copy.deepcopy(vl.vision).to("cuda"), vl.tokenizer,
                                image_token_id=vl.image_token_id,
                                video_token_id=vl.video_token_id,
                                vision_end_token_id=vl.vision_end_token_id))
    res = dict(phase="qwen_reference", size=QWEN_REF_SIZE, steps=2, dit_dim=dit.dim,
               dit_heads=dit.num_heads, latents_rel_l2={}, latents_tol=5e-2,
               k1_launches={}, k1_expected={})
    base = dict(prompt=QWEN_PROMPT, negative_prompt=QWEN_NEGATIVE, height=QWEN_REF_SIZE,
                width=QWEN_REF_SIZE, seed=42, num_inference_steps=2, return_latents=True)
    cases = {"cfg 1": dict(cfg_scale=1.0), "cfg 4": dict(cfg_scale=QWEN_CFG)}
    cases.update({name: dict(cfg_scale=QWEN_CFG, **req) for name, req in
                  qwen_adapter_requests(QWEN_REF_SIZE).items()
                  if name in ("edit", "eligen", "controlnet")})
    lat_cpu, launches = None, {}
    for name, req in cases.items():
        kw = {**base, **req}
        lat_c = cpu(**kw).float()
        lat_g, _, launches[name], _ = run_counted(torch, kernels, lambda: gpu(**kw))
        lat_g = lat_g.float().cpu()
        passes = 1 if name in ("cfg 1", "eligen") else 2
        res["k1_expected"][name] = dit.num_layers * passes * base["num_inference_steps"]
        res["k1_launches"][name] = launches[name]["K1"]
        res["latents_rel_l2"][name] = ((lat_g - lat_c).norm() / lat_c.norm()).item()
        if lat_cpu is None:
            lat_cpu = lat_c
    img_c = np.asarray(cpu.decode_image(lat_cpu).clamp(-1, 1).add(1).mul(127.5).round(), np.int16)
    img_g = np.asarray(gpu.decode_image(lat_cpu.cuda()).clamp(-1, 1).add(1).mul(127.5).round()
                       .cpu(), np.int16)
    res.update(image_max_abs_diff=float(np.abs(img_g - img_c).max()), image_tol=2.0)
    emit(res)
    if not (all(v <= 5e-2 for v in res["latents_rel_l2"].values())
            and res["image_max_abs_diff"] <= 2.0):
        raise AssertionError(f"Qwen-Image, card vs CPU disagree: {res}")
    for name, count in launches.items():
        check_launches(count, {"K1": res["k1_expected"][name]}, f"qwen_reference {name}")


def qwen_result(phase: str, pipe, seconds: float, launches: dict, peak: float, expected: dict,
                **extra) -> dict:
    """A Qwen phase's line: stages, steps, peaks, launches against the
    derived K1 count."""
    res = dict(phase=phase, total_s=seconds,
               stages={k: v for k, v in pipe.stage_times if not k.startswith("denoise_step_")},
               step_s=step_times(pipe), max_memory_allocated_gib=peak,
               launches={k: v for k, v in launches.items() if v}, expected_launches=expected,
               **extra, **CARD)
    emit(res)
    check_launches(launches, expected, phase)
    return res


def run_qwen(torch, kernels, steps: int) -> dict:
    """`qwen`: Qwen-Image at full width and depth on a free card (the 20.4 B
    DiT: dim 3072, 24 heads of 128, 60 blocks; Qwen2.5-VL-7B's text tower,
    28 layers, and its vision tower, 32 blocks; the fp32 Wan2.1 VAE; random
    weights from a seed, bf16): a 1328x1328 request at CFG 4 two-pass,
    --steps steps, then the decode: stage times, the peak, K1's launches
    against 60 a pass; then one two-pass step profiled by category
    (`qwen_profile`); then `qwen_edit` and `qwen_adapters` on the resident
    model. Returns each phase's launches and the Qwen2.5-VL towers (the
    DiT, the VAE and the ControlNet freed)."""
    from video_styler_tpu_torch.models import qwen_image_dit as QD
    from video_styler_tpu_torch.models.llm_decoder import QWEN25_VL_7B_TEXT
    from video_styler_tpu_torch.models.qwen_image_controlnet import QWEN_BLOCKWISE_CN
    from video_styler_tpu_torch.models.qwen_vl_vision import QWEN25_VL_7B_VISION
    from video_styler_tpu_torch.pipelines.wan_video import generate_noise
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = qwen_pipeline(torch, QD.QWEN_IMAGE, QWEN25_VL_7B_TEXT, QWEN25_VL_7B_VISION, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = pipe.dit_cfg
    out = {}
    try:
        weights = {"dit": gib([pipe.dit]), "text": gib([pipe._vl.text]),
                   "vision": gib([pipe._vl.vision]), "vae": gib([pipe.vae])}
        params = {"dit": sum(p.numel() for p in pipe.dit.parameters()),
                  "text": sum(p.numel() for p in pipe._vl.text.parameters()),
                  "vision": sum(p.numel() for p in pipe._vl.vision.parameters())}
        per_pass = cfg.num_layers
        lens = qwen_joint_lens()
        request = dict(prompt=QWEN_PROMPT, negative_prompt=QWEN_NEGATIVE, cfg_scale=QWEN_CFG,
                       height=QWEN_SIZE, width=QWEN_SIZE, seed=42, num_inference_steps=steps)
        image, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
        expected = {"K1": 2 * per_pass * steps}
        res = qwen_result("qwen", pipe, seconds, launches, peak, expected, model="Qwen-Image",
                          dit_dim=cfg.dim, dit_heads=cfg.num_heads, dit_blocks=cfg.num_layers,
                          params=params, weights_gib=weights, build_s=build_s, size=QWEN_SIZE,
                          joint_tokens=[lens["t2i"], lens["t2i-negative"]], steps=steps,
                          cfg=f"two-pass {QWEN_CFG}", image_size=list(image.size),
                          k1_launches_per_30_step_request=2 * per_pass * QWEN_RECIPE_STEPS)
        out["qwen"] = launches
        if image.size != (QWEN_SIZE, QWEN_SIZE):
            raise AssertionError(f"qwen: image {image.size}")
        step_s = min(res["step_s"])
        emit(dict(phase="qwen_image_composed", steps=QWEN_RECIPE_STEPS,
                  note="composed from this run's stages and its fastest step, not run",
                  image_s=sum(res["stages"].values()) + QWEN_RECIPE_STEPS * step_s, **CARD))
        # one two-pass step under the profiler, on this request's inputs
        posi, _ = pipe.encode_prompt(QWEN_PROMPT)
        nega, _ = pipe.encode_prompt(QWEN_NEGATIVE)
        image_tokens = (QWEN_SIZE // 16) ** 2
        if [posi.shape[1] + image_tokens, nega.shape[1] + image_tokens] != res["joint_tokens"]:
            raise AssertionError(f"qwen: the request's joint lengths are not those K1 was "
                                 f"checked at: {posi.shape[1]}, {nega.shape[1]} text rows")
        lat = generate_noise((1, 16, QWEN_SIZE // 8, QWEN_SIZE // 8), seed=42).to(
            "cuda", torch.bfloat16)
        t = torch.tensor([float(pipe.scheduler.timesteps[0]) / 1000.0], device="cuda")
        with torch.no_grad():
            def one_step():
                v = QD.qwen_image_dit_forward(pipe.dit, lat, t, posi)
                vn = QD.qwen_image_dit_forward(pipe.dit, lat, t, nega)
                return vn + QWEN_CFG * (v - vn)
            prof = profile_request(torch, one_step, step_s, categories=QWEN_CATEGORIES)
        emit({"phase": "qwen_profile", "forwards": 2, **prof, **CARD})
        del posi, nega, lat, image
        out["qwen_edit"] = run_qwen_edit(torch, pipe, kernels, steps)
        pipe.blockwise_controlnets = [random_blockwise_cn(torch, QWEN_BLOCKWISE_CN, "cuda", 3)]
        out.update(run_qwen_adapters(torch, pipe, kernels, steps))
        return out, pipe._vl
    finally:
        del pipe
        gc.collect()
        torch.cuda.empty_cache()


def run_qwen_edit(torch, pipe, kernels, steps: int) -> dict:
    """`qwen_edit`: Qwen-Image-Edit on the resident model: a 1024x1024 edit
    image through the vision tower (into the prompt's embedding) and as an
    extra latent, CFG 4 two-pass: the vision and text stages apart, step
    seconds, K1 120 a step."""
    req = qwen_adapter_requests(QWEN_ADAPTER_SIZE)["edit"]
    request = dict(req, negative_prompt=QWEN_NEGATIVE, cfg_scale=QWEN_CFG,
                   height=QWEN_ADAPTER_SIZE, width=QWEN_ADAPTER_SIZE, seed=42,
                   num_inference_steps=steps)
    image, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
    cfg = pipe.dit_cfg
    qwen_result("qwen_edit", pipe, seconds, launches, peak,
                {"K1": 2 * cfg.num_layers * steps}, size=QWEN_ADAPTER_SIZE,
                vision_merged_tokens=qwen_edit_merged_tokens(QWEN_ADAPTER_SIZE),
                vision_patches=4 * qwen_edit_merged_tokens(QWEN_ADAPTER_SIZE),
                joint_tokens=[qwen_joint_lens()[k] for k in ("edit", "edit-negative")],
                steps=steps,
                cfg=f"two-pass {QWEN_CFG}", image_size=list(image.size))
    return launches


def run_qwen_adapters(torch, pipe, kernels, steps: int) -> dict:
    """`qwen_adapters`: on the resident model, 1024x1024, CFG 4, --steps
    each: EliGen with two entities (K1 on the negative pass only: 60 a step;
    the positive pass is the exact `sdpa` under the bias), a random 60-block
    block-wise ControlNet active the first half (no attention of its own:
    120 a step), inpaint and img2img (120 a step)."""
    out = {}
    cfg = pipe.dit_cfg
    for name, req in qwen_adapter_requests(QWEN_ADAPTER_SIZE).items():
        if name == "edit":
            continue
        request = dict(prompt=QWEN_PROMPT, negative_prompt=QWEN_NEGATIVE, cfg_scale=QWEN_CFG,
                       height=QWEN_ADAPTER_SIZE, width=QWEN_ADAPTER_SIZE, seed=42,
                       num_inference_steps=steps, return_latents=True, **req)
        lat, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
        passes = 1 if name == "eligen" else 2
        qwen_result("qwen_adapters", pipe, seconds, launches, peak,
                    {"K1": passes * cfg.num_layers * steps}, adapter=name,
                    size=QWEN_ADAPTER_SIZE, steps=steps, cfg=f"two-pass {QWEN_CFG}",
                    latents_finite=bool(torch.isfinite(lat).all()))
        if not bool(torch.isfinite(lat).all()):
            raise AssertionError(f"qwen_adapters {name}: non-finite latents")
        out[f"qwen_{name}"] = launches
    return out


def run_qwen_phases(torch, kernels, steps: int):
    """`qwen_reference`, then `qwen` (with `qwen_edit` and `qwen_adapters`),
    leaving the Qwen2.5-VL-7B towers on the card for `step1x_nexus`.
    Returns each path's launches and the towers."""
    check_qwen_reference(torch, kernels)
    out, vl = run_qwen(torch, kernels, steps)
    gc.collect()
    torch.cuda.empty_cache()
    return out, vl


# ---------------------------------------------------------------------------
# Step1x and Nexus-Gen on FLUX, then HunyuanVideo text-to-video
# ---------------------------------------------------------------------------

HUNYUAN_HEADS = 24           # HunyuanVideo: 24 heads of 128
HUNYUAN_SIZE = (720, 1280)   # the pipeline's default
HUNYUAN_FRAMES = 9           # 3 latent frames: 10,800 image tokens
HUNYUAN_RECIPE_FRAMES = 129  # the published clip: 33 latent frames, 118,800 image tokens
HUNYUAN_RECIPE_STEPS = 30    # the pipeline's default step count
HUNYUAN_GUIDANCE = 6.0       # the pipeline's default embedded guidance, CFG 1
HUNYUAN_CHECK_HEADS = 2      # K1 at the published length: 2 heads held against plain
HUNYUAN_PROMPT = "a red fox running through deep snow at dawn, cinematic lighting"
HUNYUAN_REF_SIZE = 128       # hunyuan_reference: 128x128, 9 frames
HUNYUAN_REF_TILES = dict(tile_size=(17, 12, 12), tile_stride=(12, 8, 8))   # 2 x 2 tiles
STEP1X_SIZE = 1024
STEP1X_PROMPT = "turn it into a watercolor painting at dusk"
NEXUS_PROMPT = "a lighthouse on a cliff at dawn, oil painting"
STEP1X_REF_SIZE = 256        # step1x_nexus_reference: 16 x 16 image tokens


def hunyuan_joint_lens() -> dict:
    """K1's lengths in the HunyuanVideo DiT at 720x1280: [image | the first
    `split_token` text rows] at this run's 9 frames and the published 129,
    and the text tail (`txt_len - split_token` rows) every block attends
    apart."""
    from video_styler_tpu_torch.models.hunyuan_video_dit import HUNYUAN_VIDEO as H
    h, w = HUNYUAN_SIZE
    image = {f: ((f - 1) // 4 + 1) * (h // 16) * (w // 16)
             for f in (HUNYUAN_FRAMES, HUNYUAN_RECIPE_FRAMES)}
    return {f"joint-{HUNYUAN_FRAMES}f": image[HUNYUAN_FRAMES] + H.split_token,
            "tail": H.txt_len - H.split_token,
            f"joint-{HUNYUAN_RECIPE_FRAMES}f": image[HUNYUAN_RECIPE_FRAMES] + H.split_token}


def check_long_k1(torch, s: int, heads: int, check_heads: int, tag: str):
    """K1 self over s tokens: `check_heads` heads held against the plain
    version on every row, all `heads` timed (K1, the plain version once,
    SDPA)."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa
    d = 128
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn((1, s, heads, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    sub = slice(0, check_heads)
    want = fa.flash_attention_plain(q[:, :, sub], k[:, :, sub], v[:, :, sub])
    err, scale = max_err(torch, out[:, :, sub], want)
    del out, want
    flops = 4.0 * heads * s * s * d
    b_ms, b_by = bound(flops, 2.0 * 4 * s * heads * d)
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v), reps=5)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v), reps=1, warmup=0)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=5)
    return emit_rows([dict(
        name=f"K1 flash_attention self S={s} Sk={s} N={heads} D={d} [{tag}]", kernel="K1",
        route="cuda", source="video_styler_tpu_torch/csrc/flash_attention.cu",
        replaces="video_styler_tpu/ops/flash_attention.py:213", max_abs_err=err,
        max_rel_err=err / scale, tol=TOL_ULPS * scale, checked_heads=check_heads,
        checked_rows=s, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, ratio_to_library=ms / lib_ms, tflops=flops / ms / 1e9,
        ptxas=kernel_usage("flash_fwd_capped_kernel"), clocks=gpu_clocks())])


def check_hunyuan_kernels(torch):
    """`hunyuan_kernels`: K1 at the HunyuanVideo DiT's two attentions a
    block, 24 heads of 128: [image | 71 text rows] at 720x1280x9 (10,871)
    and the 185-row text tail (one key tile), held against the plain
    version (two bf16 ULPs); then the published 720x1280x129 length
    (118,871), 2 heads held on every row and all 24 timed."""
    lens = hunyuan_joint_lens()
    rows = []
    for tag in (f"joint-{HUNYUAN_FRAMES}f", "tail"):
        rows += check_kernels(torch, (1, 1, lens[tag]), f"hunyuan-{tag}", heads=HUNYUAN_HEADS,
                              cross_lens=(), norms=False)
    torch.cuda.empty_cache()
    rows += check_long_k1(torch, lens[f"joint-{HUNYUAN_RECIPE_FRAMES}f"], HUNYUAN_HEADS,
                          HUNYUAN_CHECK_HEADS, f"hunyuan-joint-{HUNYUAN_RECIPE_FRAMES}f")
    torch.cuda.empty_cache()
    return rows


def hunyuan_reference_configs():
    """A small HunyuanVideo with head dim 128 (dim 256, 2 heads, the
    release's RoPE bands, 2 + 2 blocks, 32 text rows split at 12), CLIP-L's
    tiny widths, a 4-layer LLaMA of 256 (2 heads of 128), a 16-channel VAE
    of widths (32, 64, 64, 64)."""
    import dataclasses
    from video_styler_tpu_torch.models.hunyuan_video_dit import HUNYUAN_VIDEO
    from video_styler_tpu_torch.models.hunyuan_video_vae import HUNYUAN_VAE
    from video_styler_tpu_torch.models.llm_decoder import LLAMA3_8B
    from video_styler_tpu_torch.models.sd3_text_encoder import CLIP_L_TINY
    llm = dataclasses.replace(LLAMA3_8B, vocab_size=2048, hidden=256, num_layers=4,
                              num_heads=2, num_kv_heads=1, ffn=512)
    dit = dataclasses.replace(HUNYUAN_VIDEO, hidden_size=256, num_heads=2, num_double_blocks=2,
                              num_single_blocks=2, text_dim=llm.hidden,
                              pooled_dim=CLIP_L_TINY.dim, txt_len=32, split_token=12)
    vae = dataclasses.replace(HUNYUAN_VAE, block_out_channels=(32, 64, 64, 64),
                              layers_per_block=1, num_groups=8)
    return dit, CLIP_L_TINY, llm, vae


def hunyuan_pipeline(torch, configs, device: str, seed: int = 0):
    """A HunyuanVideo pipeline of random bf16 weights (the VAE fp32) from a
    seed, with the stand-in tokenizers."""
    from video_styler_tpu_torch.pipelines.hunyuan_video import (HunyuanVideoPipeline,
                                                                StubLlamaTokenizer)
    from video_styler_tpu_torch.prompters.flux_prompter import StubClipTokenizer
    dit, clip, llm, vae = configs
    return HunyuanVideoPipeline.from_configs(dit, clip, llm, vae, StubClipTokenizer(clip.vocab),
                                             StubLlamaTokenizer(llm.vocab_size), seed=seed,
                                             device=device, dtype=torch.bfloat16)


def check_hunyuan_reference(torch, kernels):
    """`hunyuan_reference`: the small pipeline of `hunyuan_reference_configs`
    on the card (K1) against the same weights on the CPU (plain versions),
    bf16: 128x128, 9 frames, 2 steps, t2v at CFG 1 (embedded 6) and CFG 2,
    v2v (the tiled encode, 2 x 2 tiles) and i2v; latents within 5% relative
    L2; the tiled fp32 decode (2 x 2 tiles) of the CPU's t2v latents on
    both devices within 2 levels; K1's launches against 2 a block, pass and
    step."""
    import numpy as np
    cpu = hunyuan_pipeline(torch, hunyuan_reference_configs(), "cpu")
    gpu = copy.copy(cpu)
    gpu.device = torch.device("cuda")
    gpu.dit, gpu.clip, gpu.vae_encoder, gpu.vae_decoder = (
        copy.deepcopy(m).to("cuda") for m in (cpu.dit, cpu.clip, cpu.vae_encoder,
                                              cpu.vae_decoder))
    gpu.use_llm(copy.deepcopy(cpu.llm_model).to("cuda"), cpu.llm_tokenizer)
    cfg = cpu.dit_cfg
    clip = synthetic_clip(9, HUNYUAN_REF_SIZE, HUNYUAN_REF_SIZE)
    base = dict(prompt=HUNYUAN_PROMPT, negative_prompt="blurry", height=HUNYUAN_REF_SIZE,
                width=HUNYUAN_REF_SIZE, num_frames=9, seed=42, num_inference_steps=2,
                return_latents=True, **HUNYUAN_REF_TILES)
    cases = {"t2v cfg 1": {}, "t2v cfg 2": dict(cfg_scale=2.0),
             "v2v": dict(input_video=clip, denoising_strength=0.8),
             "i2v": dict(input_images=[clip[0]])}
    blocks = cfg.num_double_blocks + cfg.num_single_blocks
    res = dict(phase="hunyuan_reference", size=HUNYUAN_REF_SIZE, frames=9, steps=2,
               dit_dim=cfg.hidden_size, dit_heads=cfg.num_heads, latents_rel_l2={},
               latents_tol=5e-2, k1_launches={}, k1_expected={})
    lat_t2v, launches = None, {}
    for name, req in cases.items():
        kw = {**base, **req}
        lat_c = cpu(**kw).float()
        lat_g, _, launches[name], _ = run_counted(torch, kernels, lambda: gpu(**kw))
        lat_g = lat_g.float().cpu()
        res["latents_rel_l2"][name] = ((lat_g - lat_c).norm() / lat_c.norm()).item()
        res["k1_launches"][name] = launches[name]["K1"]
        res["k1_expected"][name] = 2 * blocks * (2 if "cfg 2" in name else 1) * 2
        if lat_t2v is None:
            lat_t2v = lat_c
    tiles = {k: v for k, v in HUNYUAN_REF_TILES.items()}
    vid_c = np.asarray(cpu.decode_video(lat_t2v, **tiles).clamp(-1, 1).add(1).mul(127.5)
                       .round(), np.int16)
    vid_g = np.asarray(gpu.decode_video(lat_t2v.cuda(), **tiles).clamp(-1, 1).add(1)
                       .mul(127.5).round().cpu(), np.int16)
    res.update(decode_shape=list(vid_g.shape), frames_max_abs_diff=float(np.abs(vid_g - vid_c)
                                                                         .max()), frames_tol=2.0,
               **CARD)
    emit(res)
    if not (all(v <= 5e-2 for v in res["latents_rel_l2"].values())
            and res["frames_max_abs_diff"] <= 2.0):
        raise AssertionError(f"HunyuanVideo, card vs CPU disagree: {res}")
    for name, count in launches.items():
        check_launches(count, {"K1": res["k1_expected"][name]}, f"hunyuan_reference {name}")


def run_hunyuan(torch, kernels, steps: int) -> dict:
    """`hunyuan`: HunyuanVideo at full width and depth on a free card (the
    12.8 B DiT: dim 3072, 24 heads of 128, 20 double + 40 single blocks;
    LLaMA-3-8B's text tower, 32 layers, 30 run; CLIP-L; the fp32 causal VAE;
    random weights from a seed, bf16): a 720x1280 request of 9 frames at CFG
    1 (embedded guidance 6), --steps steps, then the tiled decode: stage
    times, the peak, K1's launches against 2 a block and step (120); then
    one step profiled by category (`hunyuan_profile`)."""
    from video_styler_tpu_torch.models.hunyuan_video_dit import HUNYUAN_VIDEO
    from video_styler_tpu_torch.models.hunyuan_video_vae import HUNYUAN_VAE
    from video_styler_tpu_torch.models.llm_decoder import LLAMA3_8B
    from video_styler_tpu_torch.models.sd3_text_encoder import CLIP_L
    from video_styler_tpu_torch.pipelines.wan_video import generate_noise
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = hunyuan_pipeline(torch, (HUNYUAN_VIDEO, CLIP_L, LLAMA3_8B, HUNYUAN_VAE), "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = pipe.dit_cfg
    h, w = HUNYUAN_SIZE
    try:
        weights = {"dit": gib([pipe.dit]), "llm": gib([pipe.llm_model]), "clip": gib([pipe.clip]),
                   "vae": gib([pipe.vae_encoder, pipe.vae_decoder])}
        params = {"dit": sum(p.numel() for p in pipe.dit.parameters()),
                  "llm": sum(p.numel() for p in pipe.llm_model.parameters())}
        per_step = 2 * (cfg.num_double_blocks + cfg.num_single_blocks)
        request = dict(prompt=HUNYUAN_PROMPT, height=h, width=w, num_frames=HUNYUAN_FRAMES,
                       seed=42, embedded_guidance=HUNYUAN_GUIDANCE, num_inference_steps=steps)
        video, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
        expected = {"K1": per_step * steps}
        lens = hunyuan_joint_lens()
        res = dict(phase="hunyuan", model="HunyuanVideo", dit_dim=cfg.hidden_size,
                   dit_heads=cfg.num_heads, double_blocks=cfg.num_double_blocks,
                   single_blocks=cfg.num_single_blocks, params=params, weights_gib=weights,
                   build_s=build_s, size=[h, w], frames=HUNYUAN_FRAMES,
                   joint_tokens=lens[f"joint-{HUNYUAN_FRAMES}f"], tail_tokens=lens["tail"],
                   steps=steps, cfg=f"1 (embedded {HUNYUAN_GUIDANCE})", total_s=seconds,
                   stages={k: v for k, v in pipe.stage_times
                           if not k.startswith("denoise_step_")},
                   step_s=step_times(pipe), max_memory_allocated_gib=peak,
                   stage_peak_gib={k: v / 2**30 for k, v in pipe.stage_peak_bytes},
                   video_shape=list(video.shape), launches={k: v for k, v in launches.items() if v},
                   expected_launches=expected,
                   k1_launches_per_30_step_request=per_step * HUNYUAN_RECIPE_STEPS, **CARD)
        emit(res)
        check_launches(launches, expected, "hunyuan")
        if list(video.shape) != [HUNYUAN_FRAMES, h, w, 3]:
            raise AssertionError(f"hunyuan: video {video.shape}")
        # one step (CFG 1: one forward) under the profiler, on this request's inputs
        cond = pipe.encode_prompt(HUNYUAN_PROMPT)
        lat = generate_noise((1, 16, (HUNYUAN_FRAMES - 1) // 4 + 1, h // 8, w // 8),
                             seed=42).to("cuda", torch.bfloat16)
        t = torch.tensor([float(pipe.scheduler.timesteps[0])], device="cuda")
        g = torch.tensor([HUNYUAN_GUIDANCE], device="cuda")
        with torch.no_grad():
            prof = profile_request(torch, lambda: pipe._branch(lat, t, cond, g, None),
                                   min(res["step_s"]), categories=FLUX_CATEGORIES)
        emit({"phase": "hunyuan_profile", "forwards": 1, **prof, **CARD})
        return launches
    finally:
        del pipe
        gc.collect()
        torch.cuda.empty_cache()


def nexus_reference_tokens(size: int) -> int:
    """Merged vision tokens of a size x size Nexus-Gen reference image at the
    processor's default pixel budget."""
    from video_styler_tpu_torch.models.qwen_vl_vision import smart_resize
    hh, ww = smart_resize(size, size, 28, 56 * 56, 28 * 28 * 1280)
    return (hh // 28) * (ww // 28)


def step1x_nexus_lens(size: int = STEP1X_SIZE) -> dict:
    """K1's [text | image (| reference)] lengths in FLUX's 57 blocks: Step1x
    (the embedder's 640 rows, the image and the reference on the Kontext
    tokens), Nexus-Gen's generation (81 predicted embeddings) and edit (81
    and the reference image's merged vision tokens)."""
    from video_styler_tpu_torch.models.nexus_gen import NUM_IMG_TOKENS
    image = (size // 16) ** 2
    return {"step1x": 640 + 2 * image, "nexus_gen": NUM_IMG_TOKENS + image,
            "nexus_gen_edit": NUM_IMG_TOKENS + nexus_reference_tokens(size) + image}


def check_step1x_nexus_kernels(torch):
    """`step1x_nexus_kernels`: K1 at FLUX's joint attention, 24 heads of 128,
    over the lengths of `step1x_nexus_lens` at 1024x1024, held against the
    plain version (two bf16 ULPs)."""
    rows = []
    for tag, s in step1x_nexus_lens().items():
        rows += check_kernels(torch, (1, 1, s), tag, heads=FLUX_HEADS, cross_lens=(),
                              norms=False)
    return rows


def step1x_nexus_modules(torch, flux_cfg, vl, device: str, seed: int = 11):
    """The Step1x connector, the Nexus-Gen adapter and merger and the AR
    model's vision head and prefill embeds for a FLUX DiT of `flux_cfg` over
    the Qwen2.5-VL towers `vl`, random bf16 weights from a seed:
    (connector, adapter, merger, NexusGenARModel)."""
    from video_styler_tpu_torch.models import nexus_gen as NG
    from video_styler_tpu_torch.models import step1x as S1
    from video_styler_tpu_torch.models.hunyuan_video_dit import init_hunyuan_video_dit_
    from video_styler_tpu_torch.models.wan_dit import Linear
    hidden, vis = vl.text_cfg.hidden, vl.vision_cfg.out_hidden
    full = hidden == S1.STEP1X_CONNECTOR.in_channels
    ccfg = S1.STEP1X_CONNECTOR if full else S1.Step1xConnectorConfig(
        in_channels=hidden, hidden_size=flux_cfg.context_dim, num_heads=2,
        pooled_dim=flux_cfg.pooled_dim)
    mcfg = NG.NEXUS_GEN_MERGER if full else NG.NexusGenMergerConfig(
        hidden_size=hidden, num_heads=vl.text_cfg.num_heads,
        num_kv_heads=vl.text_cfg.num_kv_heads, intermediate_size=2 * hidden,
        out_channel=flux_cfg.context_dim)
    gen = torch.Generator(device).manual_seed(seed)

    def draw(make, init):
        with torch.device("meta"):
            module = make(torch.bfloat16)
        return init(module.to_empty(device=device), gen).eval()
    connector = draw(lambda dt: S1.Step1xConnector(ccfg, dtype=dt), S1.init_step1x_connector_)
    adapter = draw(lambda dt: NG.NexusGenAdapter(vis, flux_cfg.context_dim, dtype=dt),
                   init_hunyuan_video_dit_)
    merger = draw(lambda dt: NG.NexusGenMerger(mcfg, dtype=dt), init_hunyuan_video_dit_)
    head = draw(lambda dt: Linear(hidden, vis, dtype=dt), init_hunyuan_video_dit_)
    prefill = (0.02 * torch.randn((NG.NUM_IMG_TOKENS, hidden), generator=gen, device=device)
               ).to(torch.bfloat16)
    return connector, adapter, merger, NG.NexusGenARModel(vl, head, prefill)


def attach_step1x_nexus(pipe, modules, vl):
    """Step1x's connector and embedder and Nexus-Gen's adapter and merger on a
    FLUX pipeline; its AR model goes in per request (`run_step1x_nexus_case`)."""
    from video_styler_tpu_torch.models.qwen_vl_embedder import QwenVLStep1xEmbedder
    connector, adapter, merger, _ = modules
    pipe.step1x_connector, pipe.qwenvl = connector, QwenVLStep1xEmbedder(vl)
    pipe.nexus_gen_generation_adapter, pipe.nexus_gen_editing_adapter = adapter, merger


def step1x_nexus_requests(size: int) -> dict:
    """Step1x's edit, Nexus-Gen's generation and edit at CFG 1."""
    return {"step1x": dict(prompt=STEP1X_PROMPT,
                           step1x_reference_image=synthetic_image(21, size)),
            "nexus_gen": dict(prompt=NEXUS_PROMPT),
            "nexus_gen_edit": dict(prompt=STEP1X_PROMPT,
                                   nexus_gen_reference_image=synthetic_image(22, size))}


def run_step1x_nexus_case(pipe, ar, name: str, request: dict, **kw):
    """One request; the Nexus-Gen AR model `ar` is attached for its cases
    only (a FLUX pipeline with `nexus_gen` set replaces every prompt)."""
    pipe.nexus_gen = ar if name.startswith("nexus") else None
    return pipe(**request, **kw)


def check_step1x_nexus_reference(torch, kernels):
    """`step1x_nexus_reference`: the small FLUX of `flux_reference` with the
    small Qwen2.5-VL towers of `qwen_reference`, a connector, an adapter, a
    merger and an AR head of their widths, on the card (K1) against the same
    weights on the CPU, bf16: 256x256, 2 steps, CFG 1, Step1x's edit and
    Nexus-Gen's generation and edit; latents within 5% relative L2, K1's
    launches against the FLUX blocks a step."""
    from video_styler_tpu_torch.models.nexus_gen import NexusGenARModel
    from video_styler_tpu_torch.models.qwen_vl_embedder import QwenVL
    configs = flux_reference_configs()
    _, text, vision, _ = qwen_reference_configs()
    cpu = flux_pipeline(torch, configs, "cpu")
    vl_c = qwen_vl(torch, text, vision, "cpu")
    mods_c = step1x_nexus_modules(torch, cpu.dit_cfg, vl_c, "cpu")
    attach_step1x_nexus(cpu, mods_c, vl_c)
    gpu = copy.copy(cpu)
    gpu.device = torch.device("cuda")
    gpu.prompter = copy.copy(cpu.prompter)
    gpu.dit, gpu.vae_encoder, gpu.vae_decoder, gpu.prompter.clip, gpu.prompter.t5 = (
        copy.deepcopy(m).to("cuda") for m in (cpu.dit, cpu.vae_encoder, cpu.vae_decoder,
                                              cpu.prompter.clip, cpu.prompter.t5))
    vl_g = QwenVL(copy.deepcopy(vl_c.text).to("cuda"), copy.deepcopy(vl_c.vision).to("cuda"),
                  vl_c.tokenizer, image_token_id=vl_c.image_token_id,
                  video_token_id=vl_c.video_token_id,
                  vision_end_token_id=vl_c.vision_end_token_id)
    connector, adapter, merger, head = (copy.deepcopy(m).to("cuda") for m in (
        mods_c[0], mods_c[1], mods_c[2], mods_c[3].vision_head))
    mods_g = (connector, adapter, merger,
              NexusGenARModel(vl_g, head, mods_c[3].prefill_embeds.to("cuda")))
    attach_step1x_nexus(gpu, mods_g, vl_g)
    blocks = cpu.dit_cfg.num_joint_blocks + cpu.dit_cfg.num_single_blocks
    res = dict(phase="step1x_nexus_reference", size=STEP1X_REF_SIZE, steps=2, cfg=1,
               latents_rel_l2={}, latents_tol=5e-2, k1_launches={}, k1_expected=2 * blocks)
    for name, req in step1x_nexus_requests(STEP1X_REF_SIZE).items():
        kw = dict(height=STEP1X_REF_SIZE, width=STEP1X_REF_SIZE, seed=42, num_inference_steps=2,
                  return_latents=True)
        lat_c = run_step1x_nexus_case(cpu, mods_c[3], name, req, **kw).float()
        lat_g, _, launches, _ = run_counted(
            torch, kernels, lambda: run_step1x_nexus_case(gpu, mods_g[3], name, req, **kw))
        lat_g = lat_g.float().cpu()
        res["latents_rel_l2"][name] = ((lat_g - lat_c).norm() / lat_c.norm()).item()
        res["k1_launches"][name] = launches["K1"]
        check_launches(launches, {"K1": 2 * blocks}, f"step1x_nexus_reference {name}")
    emit({**res, **CARD})
    if not all(v <= 5e-2 for v in res["latents_rel_l2"].values()):
        raise AssertionError(f"Step1x / Nexus-Gen, card vs CPU disagree: {res}")


def run_step1x_nexus(torch, kernels, steps: int, vl=None) -> dict:
    """`step1x_nexus`: FLUX.1-dev at full width drawn from a seed (with T5
    v1.1-XXL, CLIP-L and the FLUX VAE) beside the Qwen2.5-VL-7B towers `vl`
    (the qwen phase's, or drawn here), the Step1x connector (2 blocks of
    4096, 32 heads of 128), the Nexus-Gen adapter, merger and AR model's
    vision head and prefill embeds, random bf16 weights: a Step1x edit, a
    Nexus-Gen generation and a Nexus-Gen edit at 1024x1024, CFG 1
    (embedded 3.5), --steps steps each: stage and step seconds, the peak,
    K1's launches against 57 a step. Returns each case's launches."""
    from video_styler_tpu_torch.models.flux_dit import FLUX_DEV
    from video_styler_tpu_torch.models.llm_decoder import QWEN25_VL_7B_TEXT
    from video_styler_tpu_torch.models.qwen_vl_vision import QWEN25_VL_7B_VISION
    from video_styler_tpu_torch.models.sd3_text_encoder import CLIP_L
    from video_styler_tpu_torch.models.sd3_vae import FLUX_VAE
    from video_styler_tpu_torch.models.t5 import T5_V11_XXL
    check_step1x_nexus_reference(torch, kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if vl is None:
        vl = qwen_vl(torch, QWEN25_VL_7B_TEXT, QWEN25_VL_7B_VISION, "cuda")
    pipe = flux_pipeline(torch, (FLUX_DEV, CLIP_L, T5_V11_XXL, FLUX_VAE), "cuda")
    mods = step1x_nexus_modules(torch, pipe.dit_cfg, vl, "cuda")
    attach_step1x_nexus(pipe, mods, vl)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    out = {}
    try:
        weights = {"flux_dit": gib([pipe.dit]), "t5": gib([pipe.prompter.t5]),
                   "qwen_text": gib([vl.text]), "qwen_vision": gib([vl.vision]),
                   "connector": gib([mods[0]]), "adapter": gib([mods[1]]),
                   "merger": gib([mods[2]]), "vision_head": gib([mods[3].vision_head])}
        lens = step1x_nexus_lens()
        blocks = pipe.dit_cfg.num_joint_blocks + pipe.dit_cfg.num_single_blocks
        for name, req in step1x_nexus_requests(STEP1X_SIZE).items():
            kw = dict(height=STEP1X_SIZE, width=STEP1X_SIZE, seed=42, num_inference_steps=steps)
            image, seconds, launches, peak = run_counted(
                torch, kernels, lambda: run_step1x_nexus_case(pipe, mods[3], name, req, **kw))
            expected = {"K1": blocks * steps}
            emit(dict(phase="step1x_nexus", case=name, size=STEP1X_SIZE, steps=steps,
                      cfg="1 (embedded 3.5)", joint_tokens=lens[name], build_s=build_s,
                      weights_gib=weights, total_s=seconds,
                      stages={k: v for k, v in pipe.stage_times
                              if not k.startswith("denoise_step_")},
                      step_s=step_times(pipe), max_memory_allocated_gib=peak,
                      image_size=list(image.size),
                      launches={k: v for k, v in launches.items() if v},
                      expected_launches=expected, **CARD))
            check_launches(launches, expected, f"step1x_nexus {name}")
            if image.size != (STEP1X_SIZE, STEP1X_SIZE):
                raise AssertionError(f"step1x_nexus {name}: image {image.size}")
            out[name] = launches
        return out
    finally:
        del pipe, mods
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The last families: StepVideo (K1), CogVideoX, HunyuanDiT, SVD, OmniGen
# ---------------------------------------------------------------------------

STEP_HEADS = 48              # StepVideo: 48 heads of 128
STEP_SIZE = (544, 992)       # the pipeline's default
STEP_FRAMES = 17             # 3 latent frames: 3 x 34 x 62 = 6,324 tokens
STEP_RECIPE_FRAMES = 204     # the published clip: 36 latent frames, 75,888 tokens
STEP_CFG = 9.0
STEP_CHECK_HEADS = 2         # K1 at the published length: 2 heads held against plain
STEP_PROMPT = "a red fox running through deep snow at dawn, cinematic lighting"
STEP_NEGATIVE = "blurry, low quality"
COG_SIZE = (480, 720)
COG_FRAMES = 13              # 4 latent frames: 5,400 video + 226 text tokens
COG_CFG = 7.0
HUNYUAN_IMAGE_CFG = 7.5
SVD_SIZE = (576, 1024)
SVD_FRAMES = 14
OMNIGEN_CFG = 2.0
FAMILY_SIZE = 1024           # hunyuan_image and omnigen: 1024 x 1024
FAMILY_REF_STEPS = 2
FAMILY_PHASES = ("step_video", "cog_video", "hunyuan_image", "svd", "omnigen")


def step_video_tokens(frames: int) -> int:
    h, w = STEP_SIZE
    return max(frames // 17 * 3, 1) * (h // 16) * (w // 16)


def check_step_video_kernels(torch):
    """`step_video_kernels`: K1 at the StepVideo DiT's self-attention, 48
    heads of 128, over this run's 544x992x17 tokens (6,324) held against
    the plain version (two bf16 ULPs), then the published 204 frames
    (75,888: 2 heads held on every row, all 48 timed)."""
    rows = check_kernels(torch, (1, 1, step_video_tokens(STEP_FRAMES)),
                         f"step_video-{STEP_FRAMES}f", heads=STEP_HEADS, cross_lens=(),
                         norms=False)
    torch.cuda.empty_cache()
    rows += check_long_k1(torch, step_video_tokens(STEP_RECIPE_FRAMES), STEP_HEADS,
                          STEP_CHECK_HEADS, f"step_video-{STEP_RECIPE_FRAMES}f")
    torch.cuda.empty_cache()
    return rows


def to_card(pipe, *attrs):
    """A copy of `pipe` on the card holding copies of its `attrs` models."""
    import torch
    gpu = copy.copy(pipe)
    gpu.device = torch.device("cuda")
    for name in attrs:
        m = getattr(pipe, name)
        setattr(gpu, name, None if m is None else copy.deepcopy(m).to("cuda"))
    return gpu


def card_vs_cpu(torch, kernels, phase: str, cpu, gpu, requests: dict, k1_per_request=None,
                **extra):
    """Each request's latents on the CPU pipeline and its card copy within
    5% relative L2; every kernel's launches in each card run against
    k1_per_request(name) for K1 (0 where the family takes the exact
    `sdpa`, as in JAX)."""
    res = dict(phase=phase, latents_rel_l2={}, latents_tol=5e-2, launches={}, **extra)
    launches = {}
    for name, kw in requests.items():
        lat_c = cpu(**kw, return_latents=True).float()
        lat_g, _, launches[name], _ = run_counted(torch, kernels,
                                                  lambda: gpu(**kw, return_latents=True))
        if not lat_g.is_cuda:
            raise AssertionError(f"{phase} {name}: the card copy ran off the card")
        lat_g = lat_g.float().cpu()
        res["latents_rel_l2"][name] = ((lat_g - lat_c).norm() / lat_c.norm()).item()
        res["launches"][name] = {k: v for k, v in launches[name].items() if v}
        res["latents_shape"] = list(lat_g.shape)
    emit({**res, **CARD})
    if not all(v <= 5e-2 for v in res["latents_rel_l2"].values()):
        raise AssertionError(f"{phase}: card vs CPU disagree: {res}")
    for name, count in launches.items():
        expected = {"K1": k1_per_request(name)} if k1_per_request else {}
        check_launches(count, expected, f"{phase} {name}")


def step_video_reference_configs():
    """A small StepVideo with heads of 128 (2 heads, 2 blocks, the
    release's RoPE split), a 2-layer Step-1 LLM of 256, a 2-layer BERT of
    64, the VAE at its release widths (one resnet a level)."""
    import dataclasses
    from video_styler_tpu_torch.models.hunyuan_image_dit import HunyuanBertConfig
    from video_styler_tpu_torch.models.stepvideo_dit import STEP_VIDEO
    from video_styler_tpu_torch.models.stepvideo_llm import Step1LLMConfig
    from video_styler_tpu_torch.models.stepvideo_vae import STEP_VAE_TINY
    llm = Step1LLMConfig(hidden_size=256, num_heads=2, num_groups=1, ffn_hidden=512,
                         num_layers=2, vocab_size=2048)
    bert = HunyuanBertConfig(vocab=2048, dim=64, num_layers=2, num_heads=2, ffn_dim=128,
                             max_positions=80)
    dit = dataclasses.replace(STEP_VIDEO, num_heads=2, num_layers=2, caption_dim=llm.hidden_size,
                              clip_dim=bert.dim)
    vae = dataclasses.replace(STEP_VAE_TINY, z_channels=dit.in_channels)
    return dit, llm, bert, vae


def step_video_towers(torch, llm_cfg, bert_cfg, device: str, seed: int, dtype):
    """The Step-1 LLM and the bilingual CLIP-BERT, random from a seed."""
    from video_styler_tpu_torch.models import hunyuan_image_dit as H
    from video_styler_tpu_torch.models import stepvideo_llm as L
    gen = torch.Generator(device).manual_seed(seed)
    with torch.device("meta"):
        llm = L.Step1LLM(llm_cfg, dtype=dtype)
        bert = H.HunyuanBert(bert_cfg, dtype=dtype)
    return (L.init_step1_llm_(llm.to_empty(device=device), gen).eval(),
            H.init_hunyuan_image_dit_(bert.to_empty(device=device), gen).eval())


def check_step_video_reference(torch, kernels):
    """`step_video_reference`: the small StepVideo of
    `step_video_reference_configs` on the card (K1, heads of 128) against
    the same weights on the CPU (plain versions), bf16: 64x64, 17 frames
    (48 tokens), 2 steps at CFG 1 and 9; latents within 5%; K1 launches
    against one a block, pass and step."""
    from video_styler_tpu_torch.models.stepvideo_llm import stub_stepchat_tokenize
    from video_styler_tpu_torch.pipelines.hunyuan_image import StubBertTokenizer
    from video_styler_tpu_torch.pipelines.step_video import StepVideoPipeline
    dit, llm_cfg, bert_cfg, vae = step_video_reference_configs()
    cpu = StepVideoPipeline.from_configs(dit, vae, seed=0, device="cpu", dtype=torch.bfloat16,
                                         vae=False)
    llm, bert = step_video_towers(torch, llm_cfg, bert_cfg, "cpu", 1, torch.bfloat16)
    tok, tokenize = StubBertTokenizer(bert_cfg.vocab), stub_stepchat_tokenize(llm_cfg.vocab_size)
    cpu.fetch_text_encoders(bert, tok, llm, tokenize)
    gpu = to_card(cpu, "dit")
    gpu.fetch_text_encoders(copy.deepcopy(bert).to("cuda"), tok, copy.deepcopy(llm).to("cuda"),
                            tokenize)
    base = dict(prompt=STEP_PROMPT, negative_prompt=STEP_NEGATIVE, height=64, width=64,
                num_frames=17, seed=42, num_inference_steps=FAMILY_REF_STEPS)
    requests = {"cfg 1": dict(base, cfg_scale=1.0), "cfg 9": dict(base, cfg_scale=STEP_CFG)}
    card_vs_cpu(torch, kernels, "step_video_reference", cpu, gpu, requests,
                lambda name: dit.num_layers * (2 if name == "cfg 9" else 1) * FAMILY_REF_STEPS,
                dit_dim=dit.dim, dit_heads=dit.num_heads, tokens=3 * 4 * 4)


def family_result(phase: str, pipe, seconds: float, launches: dict, peak: float,
                  expected: dict, **extra) -> dict:
    res = dict(phase=phase, total_s=seconds, stages={k: v for k, v in pipe.stage_times
                                                     if not k.startswith("denoise_step_")},
               step_s=step_times(pipe), max_memory_allocated_gib=peak,
               stage_peak_gib={k: v / 2**30 for k, v in pipe.stage_peak_bytes},
               launches={k: v for k, v in launches.items() if v},
               expected_launches=expected, script_s=time.perf_counter() - START,
               **extra, **CARD)
    emit(res)
    check_launches(launches, expected, phase)
    return res


def free_card(torch):
    gc.collect()
    torch.cuda.empty_cache()


def run_step_video(torch, kernels, steps: int) -> dict:
    """`step_video`: StepVideo at full width and depth on a free card,
    random bf16 weights from a seed: the Step-1 LLM (48 layers of 6144) and
    the CLIP-BERT encode the prompt and the negative prompt, and go; the
    30 B DiT (48 blocks of 6144, 48 heads of 128) runs 544x992x17 (6,324
    tokens) at CFG 9 two-pass for --steps steps and goes; then the fp32
    VAE decodes the latents. Stage times, peaks, K1 launches against 48 a
    pass (192 at 2 steps); one DiT forward profiled by category
    (`step_video_profile`)."""
    from video_styler_tpu_torch.models import hunyuan_image_dit as H
    from video_styler_tpu_torch.models import stepvideo_llm as L
    from video_styler_tpu_torch.models import stepvideo_vae as V
    from video_styler_tpu_torch.models.stepvideo_dit import STEP_VIDEO, step_video_dit_forward
    from video_styler_tpu_torch.pipelines.hunyuan_image import StubBertTokenizer
    from video_styler_tpu_torch.pipelines.step_video import StepVideoPipeline
    from video_styler_tpu_torch.pipelines.wan_video import generate_noise
    free_card(torch)
    h, w = STEP_SIZE
    pipe = StepVideoPipeline.from_configs(STEP_VIDEO, V.STEP_VAE, seed=0, device="cuda",
                                          dit=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm, bert = step_video_towers(torch, L.STEP1_LLM, H.HUNYUAN_BERT, "cuda", 1, torch.bfloat16)
    torch.cuda.synchronize()
    towers = dict(build_s=time.perf_counter() - t0, llm_gib=gib([llm]), bert_gib=gib([bert]),
                  llm_params=sum(p.numel() for p in llm.parameters()))
    pipe.fetch_text_encoders(bert, StubBertTokenizer(H.HUNYUAN_BERT.vocab), llm,
                             L.stub_stepchat_tokenize(L.STEP1_LLM.vocab_size))
    t0 = time.perf_counter()
    cond = {p: pipe.text_encoder(p) for p in (STEP_PROMPT, STEP_NEGATIVE)}
    torch.cuda.synchronize()
    towers.update(encode_s=time.perf_counter() - t0,
                  encode_stages={k: v for k, v in pipe.stage_times},
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    # the LLM goes before the DiT comes: both do not fit in 80 GB
    del llm, bert
    pipe.llm = pipe.clip = None
    pipe.text_encoder = cond.__getitem__
    free_card(torch)
    t0 = time.perf_counter()
    pipe.build_dit(2)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = pipe.dit_cfg
    try:
        request = dict(prompt=STEP_PROMPT, negative_prompt=STEP_NEGATIVE, cfg_scale=STEP_CFG,
                       height=h, width=w, num_frames=STEP_FRAMES, num_inference_steps=steps,
                       seed=42, return_latents=True)
        latents, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
        expected = {"K1": cfg.num_layers * 2 * steps}
        step_stages = list(pipe.stage_times)
        lat = generate_noise(tuple(latents.shape), seed=42).to("cuda", torch.bfloat16)
        t = torch.tensor([float(pipe.scheduler.timesteps[0])], device="cuda")
        with torch.no_grad():
            prof = profile_request(torch, lambda: step_video_dit_forward(
                pipe.dit, lat, t, *cond[STEP_PROMPT]), min(step_times(pipe)) / 2,
                categories=FLUX_CATEGORIES)
        dit_gib = gib([pipe.dit])
        pipe.dit = None
        free_card(torch)
        torch.cuda.reset_peak_memory_stats()
        video, decode_s, _, decode_peak = run_counted(torch, kernels,
                                                      lambda: pipe.decode_video(latents))
        pipe.stage_times = step_stages + [("vae_decode", decode_s)]
        family_result("step_video", pipe, seconds + decode_s, launches, peak, expected,
                      model="StepVideo (Step-Video-T2V)", dit_dim=cfg.dim, dit_heads=cfg.num_heads,
                      dit_layers=cfg.num_layers, dit_gib=dit_gib, dit_build_s=build_s,
                      towers=towers, vae_gib=gib([pipe.vae]), size=[h, w], frames=STEP_FRAMES,
                      tokens=step_video_tokens(STEP_FRAMES), steps=steps, cfg=STEP_CFG,
                      decode_peak_gib=decode_peak, video_shape=list(video.shape),
                      k1_launches_per_30_step_request=cfg.num_layers * 2 * 30)
        emit({"phase": "step_video_profile", "forwards": 1, **prof, **CARD})
        if list(video.shape) != [STEP_FRAMES, h, w, 3]:
            raise AssertionError(f"step_video: video {video.shape}")
        return launches
    finally:
        del pipe
        free_card(torch)


def check_cog_video_reference(torch, kernels):
    """`cog_video_reference`: COG_DIT_TINY (heads of 48: the exact `sdpa`,
    as in JAX) and a tiny T5 v1.1 on the card against the CPU, bf16: 32x32,
    9 frames, 2 steps at CFG 1 and 7; latents within 5%; K1 never
    launched."""
    from video_styler_tpu_torch.models.cog_video import COG_DIT_TINY
    from video_styler_tpu_torch.models.t5 import T5_V11_TINY, T5Encoder, init_t5_
    from video_styler_tpu_torch.pipelines.cog_video import CogVideoPipeline
    from video_styler_tpu_torch.prompters.flux_prompter import StubT5Tokenizer
    cpu = CogVideoPipeline.from_configs(COG_DIT_TINY, seed=0, device="cpu", dtype=torch.bfloat16,
                                        vae=False)
    with torch.device("meta"):
        t5 = T5Encoder(T5_V11_TINY, dtype=torch.bfloat16)
    t5 = init_t5_(t5.to_empty(device="cpu"), torch.Generator().manual_seed(1)).eval()
    tok = StubT5Tokenizer(T5_V11_TINY.vocab)
    cpu.fetch_text_encoder(t5, tok)
    gpu = to_card(cpu, "dit")
    gpu.fetch_text_encoder(copy.deepcopy(t5).to("cuda"), tok)
    base = dict(prompt=STEP_PROMPT, negative_prompt=STEP_NEGATIVE, height=32, width=32,
                num_frames=9, seed=42, num_inference_steps=FAMILY_REF_STEPS)
    card_vs_cpu(torch, kernels, "cog_video_reference", cpu, gpu,
                {"cfg 1": dict(base, cfg_scale=1.0), "cfg 7": dict(base, cfg_scale=COG_CFG)})


def run_cog_video(torch, kernels, steps: int) -> dict:
    """`cog_video`: CogVideoX-5B at full width and depth on a free card (the
    5.6 B DiT: 42 blocks of 3072, 48 heads of 64; T5 v1.1-XXL; the fp32
    VAE; random weights from a seed, bf16): 480x720x13 (5,400 video + 226
    text tokens, 48 x 5,626^2 fp32 logits a call) at CFG 7 two-pass for
    --steps steps, then the chunked decode; K1 never launched (the exact
    `sdpa`, as in JAX); one DiT forward profiled (`cog_video_profile`)."""
    from video_styler_tpu_torch.models.cog_video import COG_VIDEO_X, cog_dit_forward
    from video_styler_tpu_torch.models.t5 import T5_V11_XXL, T5Encoder, init_t5_
    from video_styler_tpu_torch.pipelines.cog_video import CogVideoPipeline
    from video_styler_tpu_torch.pipelines.wan_video import generate_noise
    from video_styler_tpu_torch.prompters.flux_prompter import StubT5Tokenizer
    free_card(torch)
    h, w = COG_SIZE
    t0 = time.perf_counter()
    pipe = CogVideoPipeline.from_configs(COG_VIDEO_X, seed=0, device="cuda")
    t5 = random_module(torch, T5Encoder, T5_V11_XXL, init_t5_, 1, torch.bfloat16)
    pipe.fetch_text_encoder(t5, StubT5Tokenizer(T5_V11_XXL.vocab))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = pipe.dit_cfg
    try:
        request = dict(prompt=STEP_PROMPT, negative_prompt=STEP_NEGATIVE, cfg_scale=COG_CFG,
                       height=h, width=w, num_frames=COG_FRAMES, num_inference_steps=steps,
                       seed=42, return_latents=True)
        latents, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
        step_stages = list(pipe.stage_times)
        ctx = pipe.text_encoder(STEP_PROMPT)
        lat = generate_noise(tuple(latents.shape), seed=42).to("cuda", torch.bfloat16)
        t = torch.tensor([float(pipe.scheduler.timesteps[0])], device="cuda")
        with torch.no_grad():
            prof = profile_request(torch, lambda: cog_dit_forward(pipe.dit, lat, t, ctx),
                                   min(step_times(pipe)) / 2, categories=FLUX_CATEGORIES)
        video, decode_s, _, decode_peak = run_counted(torch, kernels,
                                                      lambda: pipe.decode_video(latents))
        pipe.stage_times = step_stages + [("vae_decode", decode_s)]
        tokens = latents.shape[2] * (h // 16) * (w // 16)
        family_result("cog_video", pipe, seconds + decode_s, launches, peak, {},
                      model="CogVideoX-5B", dit_dim=cfg.dim, dit_heads=cfg.num_heads,
                      dit_layers=cfg.num_layers, weights_gib={"dit": gib([pipe.dit]),
                                                              "t5": gib([t5]),
                                                              "vae": gib([pipe.vae_decoder])},
                      build_s=build_s, size=[h, w], frames=COG_FRAMES, video_tokens=tokens,
                      text_tokens=226, steps=steps, cfg=COG_CFG, decode_peak_gib=decode_peak,
                      logits_gib_per_call=cfg.num_heads * (tokens + 226) ** 2 * 4 / 2**30,
                      video_shape=list(video.shape))
        emit({"phase": "cog_video_profile", "forwards": 1, **prof, **CARD})
        return launches
    finally:
        del pipe, t5
        free_card(torch)


def hunyuan_image_tiny(torch, device: str, dtype, vae: bool = True):
    """HunyuanDiT's smoke models (the tiny DiT, BERT and mT5, the SDXL VAE),
    random from a seed."""
    from video_styler_tpu_torch.image_gen import MT5_SMOKE
    from video_styler_tpu_torch.models.hunyuan_image_dit import (HUNYUAN_BERT_TINY,
                                                                 HUNYUAN_DIT_TINY)
    from video_styler_tpu_torch.models.t5 import T5Config
    from video_styler_tpu_torch.pipelines.hunyuan_image import (HunyuanImagePipeline,
                                                                StubBertTokenizer,
                                                                StubMT5Tokenizer)
    t5 = T5Config(**MT5_SMOKE)
    return HunyuanImagePipeline.from_configs(
        HUNYUAN_DIT_TINY, HUNYUAN_BERT_TINY, t5, StubBertTokenizer(HUNYUAN_BERT_TINY.vocab),
        StubMT5Tokenizer(t5.vocab), seed=0, device=device, dtype=dtype, vae=vae)


def check_hunyuan_image_reference(torch, kernels):
    """`hunyuan_image_reference`: the tiny HunyuanDiT (heads of 16, the
    exact `sdpa`) with its BERT and mT5 on the card against the CPU, bf16:
    64x64, 2 steps at CFG 1 and 7.5; latents within 5%; K1 never launched."""
    cpu = hunyuan_image_tiny(torch, "cpu", torch.bfloat16, vae=False)
    gpu = to_card(cpu, "dit", "bert", "t5")
    base = dict(prompt=STEP_PROMPT, negative_prompt=STEP_NEGATIVE, height=64, width=64,
                seed=42, num_inference_steps=FAMILY_REF_STEPS)
    card_vs_cpu(torch, kernels, "hunyuan_image_reference", cpu, gpu,
                {"cfg 1": dict(base, cfg_scale=1.0),
                 "cfg 7.5": dict(base, cfg_scale=HUNYUAN_IMAGE_CFG)})


def run_hunyuan_image(torch, kernels, steps: int) -> dict:
    """`hunyuan_image`: HunyuanDiT at full width and depth (1.5 B: 40 blocks
    of 1408, 16 heads of 88), the CLIP-BERT (24 x 1024), mT5-XL and the
    SDXL VAE, random weights from a seed, bf16 (the VAE fp32): 1024x1024
    (4,096 image tokens) at CFG 7.5 two-pass for --steps steps and the
    decode; K1 never launched; one DiT forward profiled."""
    from video_styler_tpu_torch.models import hunyuan_image_dit as H
    from video_styler_tpu_torch.models.t5 import MT5_XL
    from video_styler_tpu_torch.pipelines.hunyuan_image import (HunyuanImagePipeline,
                                                                StubBertTokenizer,
                                                                StubMT5Tokenizer)
    from video_styler_tpu_torch.pipelines.wan_video import generate_noise
    free_card(torch)
    t0 = time.perf_counter()
    pipe = HunyuanImagePipeline.from_configs(
        H.HUNYUAN_DIT, H.HUNYUAN_BERT, MT5_XL, StubBertTokenizer(H.HUNYUAN_BERT.vocab),
        StubMT5Tokenizer(MT5_XL.vocab), seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = pipe.dit_cfg
    try:
        request = dict(prompt=STEP_PROMPT, negative_prompt=STEP_NEGATIVE,
                       cfg_scale=HUNYUAN_IMAGE_CFG, height=FAMILY_SIZE, width=FAMILY_SIZE,
                       num_inference_steps=steps, seed=42)
        image, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
        res = family_result("hunyuan_image", pipe, seconds, launches, peak, {},
                            model="HunyuanDiT", dit_dim=cfg.hidden_dim,
                            dit_heads=cfg.num_heads,
                            dit_blocks=cfg.num_layers_down + cfg.num_layers_up,
                            weights_gib={"dit": gib([pipe.dit]), "bert": gib([pipe.bert]),
                                         "mt5": gib([pipe.t5]),
                                         "vae": gib([pipe.vae_encoder, pipe.vae_decoder])},
                            build_s=build_s, size=FAMILY_SIZE,
                            image_tokens=(FAMILY_SIZE // 16) ** 2, steps=steps,
                            cfg=HUNYUAN_IMAGE_CFG, image_size=list(image.size))
        cond = pipe.encode_prompt(STEP_PROMPT)
        lat = generate_noise((1, 4, FAMILY_SIZE // 8, FAMILY_SIZE // 8), seed=42).to(
            "cuda", torch.bfloat16)
        t = torch.tensor([999.0], device="cuda")
        size = torch.tensor([[FAMILY_SIZE, FAMILY_SIZE, FAMILY_SIZE, FAMILY_SIZE, 0, 0]],
                            dtype=torch.float32, device="cuda")
        cos, sin = H._rope_on(cfg, FAMILY_SIZE // 8, FAMILY_SIZE // 8, torch.device("cuda"))
        with torch.no_grad():
            prof = profile_request(torch, lambda: pipe._forward(lat, t, cond, size, cos, sin),
                                   min(res["step_s"]) / 2, categories=FLUX_CATEGORIES)
        emit({"phase": "hunyuan_image_profile", "forwards": 1, **prof, **CARD})
        return launches
    finally:
        del pipe
        free_card(torch)


def svd_tiny(torch, device: str, dtype):
    from video_styler_tpu_torch.models import svd as S
    from video_styler_tpu_torch.pipelines.svd_video import SVDVideoPipeline
    return SVDVideoPipeline.from_configs(S.SVD_UNET_TINY, S.SVD_IMAGE_ENCODER_TINY_224, seed=0,
                                         device=device, dtype=dtype)


def check_svd_reference(torch, kernels):
    """`svd_reference`: SVD_UNET_TINY (160 wide), a tiny CLIP-H tower and
    the SD VAE encoder on the card against the CPU, the UNet bf16: 3 frames
    of 64x64, 2 steps, the CFG ramp 1 to 3; latents within 5%; K1 never
    launched."""
    cpu = svd_tiny(torch, "cpu", torch.bfloat16)
    gpu = to_card(cpu, "unet", "image_encoder", "vae_encoder")
    image = synthetic_clip(1, 64, 64)[0]
    card_vs_cpu(torch, kernels, "svd_reference", cpu, gpu,
                {"i2v": dict(input_image=image, num_frames=3, height=64, width=64, seed=42,
                             num_inference_steps=FAMILY_REF_STEPS)})


def run_svd(torch, kernels, steps: int) -> dict:
    """`svd`: Stable Video Diffusion at full width (the 1.5 B UNet, bf16;
    the CLIP-H image tower; the SD VAE encoder and the temporal decoder,
    fp32), random weights from a seed: 576x1024, 14 frames, --steps steps
    of the two-pass CFG ramp, then the decode; the spatial attention's fp32
    logits (5 heads x 9,216^2 a frame) run 2 frames at a time; K1 never
    launched; one step's two UNet passes profiled."""
    from video_styler_tpu_torch.models import svd as S
    from video_styler_tpu_torch.pipelines.svd_video import SVDVideoPipeline
    free_card(torch)
    h, w = SVD_SIZE
    t0 = time.perf_counter()
    pipe = SVDVideoPipeline.from_configs(S.SVD_UNET, S.SVD_IMAGE_ENCODER, seed=0, device="cuda",
                                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    image = synthetic_clip(1, h, w)[0]
    try:
        request = dict(input_image=image, num_frames=SVD_FRAMES, height=h, width=w, seed=42,
                       num_inference_steps=steps)
        frames, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
        res = family_result("svd", pipe, seconds, launches, peak, {}, model="SVD (img2vid)",
                            weights_gib={"unet": gib([pipe.unet]),
                                         "image_encoder": gib([pipe.image_encoder]),
                                         "vae": gib([pipe.vae_encoder, pipe.vae_decoder])},
                            unet_params=sum(p.numel() for p in pipe.unet.parameters()),
                            build_s=build_s, size=[h, w], frames=SVD_FRAMES, steps=steps,
                            video_frames=len(frames), frame_size=list(frames[0].size),
                            spatial_logits_gib_per_pass=SVD_FRAMES * 5 * (h * w // 64) ** 2 * 4
                            / 2**30)
        x = torch.randn((SVD_FRAMES, 8, h // 8, w // 8), generator=torch.Generator(
            "cuda").manual_seed(3), device="cuda").to(torch.bfloat16)
        emb = torch.zeros((1, 1, 1024), device="cuda", dtype=torch.bfloat16)
        ids = [6, 127, 0.02]
        with torch.no_grad():
            prof = profile_request(torch, lambda: [S.svd_unet_forward(pipe.unet, x, 1.0, emb, ids)
                                                   for _ in range(2)], min(res["step_s"]),
                                   categories=FLUX_CATEGORIES)
        emit({"phase": "svd_profile", "forwards": 2, **prof, **CARD})
        if len(frames) != SVD_FRAMES or frames[0].size != (w, h):
            raise AssertionError(f"svd: {len(frames)} frames of {frames[0].size}")
        return launches
    finally:
        del pipe
        free_card(torch)


def omnigen_tiny(torch, device: str, dtype):
    from video_styler_tpu_torch.models.omnigen import OMNIGEN_TINY
    from video_styler_tpu_torch.pipelines.omnigen_image import OmnigenImagePipeline
    from video_styler_tpu_torch.prompters.omnigen_prompter import StubPhi3Tokenizer
    return OmnigenImagePipeline.from_configs(OMNIGEN_TINY, StubPhi3Tokenizer(
        OMNIGEN_TINY.vocab_size), seed=0, device=device, dtype=dtype, su_factor=None)


def check_omnigen_reference(torch, kernels):
    """`omnigen_reference`: OMNIGEN_TINY (heads of 8, the exact `sdpa`) on
    the card against the CPU, bf16: 32x32, 2 steps of text CFG 2, and with
    a reference image (image CFG: 3 branches); latents within 5%; K1 never
    launched."""
    from PIL import Image
    cpu = omnigen_tiny(torch, "cpu", torch.bfloat16)
    gpu = to_card(cpu, "transformer", "vae_encoder")
    base = dict(height=32, width=32, seed=42, num_inference_steps=FAMILY_REF_STEPS)
    ref = Image.fromarray(synthetic_clip(1, 32, 32)[0])
    card_vs_cpu(torch, kernels, "omnigen_reference", cpu, gpu,
                {"text cfg": dict(base, prompt=STEP_PROMPT),
                 "image cfg": dict(base, prompt="the picture <img><|image_1|></img> at dusk",
                                   reference_images=[ref])})


def run_omnigen(torch, kernels, steps: int) -> dict:
    """`omnigen`: OmniGen at full width (Phi-3: 32 layers of 3072, 32 heads
    of 96, Phi-3's su factors) and the SDXL VAE, random weights from a
    seed, bf16 (the VAE fp32): 1024x1024 (4,096 image tokens after the
    prompt) at text CFG 2 for --steps steps and the decode; K1 never
    launched; one transformer forward profiled."""
    from video_styler_tpu_torch.models import omnigen as O
    from video_styler_tpu_torch.pipelines.omnigen_image import OmnigenImagePipeline
    from video_styler_tpu_torch.prompters.omnigen_prompter import StubPhi3Tokenizer
    free_card(torch)
    t0 = time.perf_counter()
    pipe = OmnigenImagePipeline.from_configs(O.OMNIGEN, StubPhi3Tokenizer(O.OMNIGEN.vocab_size),
                                             seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = pipe.cfg
    try:
        request = dict(prompt=STEP_PROMPT, cfg_scale=OMNIGEN_CFG, height=FAMILY_SIZE,
                       width=FAMILY_SIZE, num_inference_steps=steps, seed=42)
        image, seconds, launches, peak = run_counted(torch, kernels, lambda: pipe(**request))
        branches = pipe.prompter(STEP_PROMPT, [], FAMILY_SIZE, FAMILY_SIZE)
        lens = [b["input_ids"].shape[1] + 1 + (FAMILY_SIZE // 16) ** 2 for b in branches]
        res = family_result("omnigen", pipe, seconds, launches, peak, {}, model="OmniGen",
                            hidden=cfg.hidden_size, heads=cfg.num_heads, layers=cfg.num_layers,
                            weights_gib={"transformer": gib([pipe.transformer]),
                                         "vae": gib([pipe.vae_encoder, pipe.vae_decoder])},
                            build_s=build_s, size=FAMILY_SIZE, sequence_lengths=lens,
                            steps=steps, cfg=OMNIGEN_CFG, image_size=list(image.size))
        br = branches[0]
        cos, sin = (torch.from_numpy(a).cuda() for a in O.longrope_tables(
            cfg, br["position_ids"], pipe.su_factor))
        lat = torch.randn((1, 4, FAMILY_SIZE // 8, FAMILY_SIZE // 8), device="cuda",
                          dtype=torch.bfloat16)
        ids = torch.from_numpy(br["input_ids"]).cuda()
        mask = torch.from_numpy(br["attention_mask"]).cuda()
        t = torch.tensor([0.5], device="cuda")
        with torch.no_grad():
            prof = profile_request(torch, lambda: O.omnigen_forward(
                pipe.transformer, lat, t, ids, [], {}, mask, cos=cos, sin=sin),
                min(res["step_s"]) / 2, categories=FLUX_CATEGORIES)
        emit({"phase": "omnigen_profile", "forwards": 1, **prof, **CARD})
        return launches
    finally:
        del pipe
        free_card(torch)


def run_family_phases(torch, kernels, steps: int, only=FAMILY_PHASES):
    """The last families' kernel rows, references and full-width phases, in
    order (StepVideo first: its LLM and DiT each want most of the card).
    -> (kernel rows, launches by path)."""
    rows, paths = [], {}
    if "step_video" in only:
        rows += check_step_video_kernels(torch)
        check_step_video_reference(torch, kernels)
        paths["step_video"] = run_step_video(torch, kernels, steps)
    for name, check, run in (("cog_video", check_cog_video_reference, run_cog_video),
                             ("hunyuan_image", check_hunyuan_image_reference, run_hunyuan_image),
                             ("svd", check_svd_reference, run_svd),
                             ("omnigen", check_omnigen_reference, run_omnigen)):
        if name in only:
            check(torch, kernels)
            paths[name] = run(torch, kernels, steps)
    return rows, paths


# ---------------------------------------------------------------------------
# Multi-GPU: one rank's kernels in this process, then ranks sharing the card
# ---------------------------------------------------------------------------

USP_HEADS = 40          # Wan2.1-14B: 40 heads of 128
RING_BLOCKS = 4         # sp = 4 over the Ditto clip's 29,640 tokens: 7,410 a rank
# four bf16 ULPs at the output's largest magnitude: the ring's merge adds
# four bf16-rounded partial outputs (each within two ULPs of its own
# magnitude) with fp32 weights, against K1's one rounding over all keys
TOL_RING = 2.0 ** -6
# the usp phase's FSDP edit: Wan2.1-VACE-14B's width and mesh at a cut
# depth, 8 of the DiT's 40 blocks with the VACE blocks mapped into them
# (layers 0 and 5), for one step. At full depth each step gathered ~33.6 GB
# a rank through host memory over gloo (75-88 s a step on one H100); at 8
# blocks it gathers a fifth of that
USP_VACE_STEPS = 1
USP_VACE_LAYERS = 8
# the usp phase's Wan2.1-T2V-1.3B at its width, cut to 10 of its 30 blocks
# (its one-process reference at the same depth), on the (1, 2, 2) mesh alone:
# four ranks share the card over gloo, and a run's cost is mostly the ranks'
# start and their umT5-XXL, not the blocks
USP_T2V_LAYERS = 10
# the usp phase's (d): Wan2.2-Animate-14B on the I2V trunk and Wan2.2-S2V-14B
# at their widths on the (1, 1, 2) mesh, cut to the blocks that reach each
# adapter: the I2V trunk's first 2 blocks (a face block after block 0) and
# S2V's first 2 (its audio injector after block 0); one step each
USP_ANIMATE_LAYERS = 2
USP_S2V_LAYERS = 2
USP_FAMILY_STEPS = 1


def check_ring_body(torch, rows: int, blocks: int):
    """The ring's per-rank body (`parallel.ring.ring_body`): `rows` query
    rows against `blocks` key blocks of `rows`, each through K1 with its
    stats, merged in fp32; held against K1's plain version over the whole
    key sequence (and reported against the JAX body's online softmax,
    `ring_body_plain`, on the same rows)."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.parallel import ring
    n, d = USP_HEADS, 128
    gen = torch.Generator("cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = randn(1, rows, n, d)
    k, v = randn(1, rows * blocks, n, d), randn(1, rows * blocks, n, d)
    kv = [(k[:, i * rows:(i + 1) * rows], v[:, i * rows:(i + 1) * rows])
          for i in range(blocks)]
    out = ring.ring_body(q, kv)
    torch.cuda.synchronize()
    sub = torch.cat([torch.arange(0, 1024), torch.arange(rows - 1024, rows)]).cuda()
    err, scale = max_err(torch, out[:, sub], fa.flash_attention_plain(q[:, sub], k, v))
    err_body, _ = max_err(torch, out[:, sub], ring.ring_body_plain(q[:, sub], kv))
    flops = 4.0 * n * rows * rows * blocks * d
    nbytes = 2.0 * (2 * rows + 2 * rows * blocks) * n * d
    b_ms, b_by = bound(flops, nbytes)
    ms = time_ms(torch, lambda: ring.ring_body(q, kv), reps=10)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=10)
    return emit_rows([dict(
        name=f"K1 ring body Sq={rows} Sk={blocks}x{rows} N={n} D={d} [usp-ring-sp{blocks}]",
        kernel="K1", route="cuda", source="video_styler_tpu_torch/csrc/flash_attention.cu",
        replaces="video_styler_tpu/ops/flash_attention.py:213",
        max_abs_err=err, max_rel_err=err / scale, tol=TOL_RING * scale,
        max_abs_err_vs_ring_plain=err_body, checked_rows=int(sub.numel()),
        ms=ms, plain_ms=time_ms(torch, lambda: ring.ring_body_plain(q, kv), reps=2, warmup=1),
        k1_whole_ms=time_ms(torch, lambda: fa.flash_attention(q, k, v), reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, ratio_to_library=ms / lib_ms,
        tflops=flops / ms / 1e9, clocks=gpu_clocks())])


def check_usp_kernels(torch):
    """`usp_kernels`: one rank's kernel work at Wan2.1-14B width over the
    Ditto clip (29,640 tokens), in this process: K1 on a Ulysses share (20
    and 10 heads over the whole sequence, sp = 2 and 4), K1 cross, K4 and
    K5 on one rank's 7,410 rows with its cos/sin rows (rank 1 of 4), and
    the ring's body over 4 blocks."""
    from video_styler_tpu_torch.ops.rope import assemble_freqs_grid
    ditto = token_grid(DITTO_FRAMES)
    rows = []
    for sp in (2, RING_BLOCKS):
        rows += check_kernels(torch, ditto, f"usp-ulysses-sp{sp}", heads=USP_HEADS // sp,
                              cross_lens=(), norms=False)
    n = math.prod(ditto) // RING_BLOCKS
    cos, sin = assemble_freqs_grid(128, *ditto)
    rows += check_kernels(torch, (1, n, 1), f"usp-rank1-of-{RING_BLOCKS}",
                          cross_lens=(TEXT_LEN,), self_attn=False,
                          rope_tables=(cos[n:2 * n].numpy(), sin[n:2 * n].numpy()))
    rows += check_ring_body(torch, n, RING_BLOCKS)
    torch.cuda.empty_cache()
    return rows


def usp_configs(model: str):
    """(DiT config, VACE config or None) of a usp model: Wan2.1-T2V-1.3B at
    USP_T2V_LAYERS blocks ("t2v-1.3B"), or Wan2.1-VACE-14B at USP_VACE_LAYERS
    blocks ("vace-14B": the release's widths, the VACE layers below the
    cut)."""
    import dataclasses
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_14B, WAN_T2V_1_3B
    from video_styler_tpu_torch.models.wan_vace import VACE_14B
    if model == "t2v-1.3B":
        return dataclasses.replace(WAN_T2V_1_3B, num_layers=USP_T2V_LAYERS), None
    return (dataclasses.replace(WAN_T2V_14B, num_layers=USP_VACE_LAYERS),
            dataclasses.replace(VACE_14B, vace_layers=tuple(
                i for i in VACE_14B.vace_layers if i < USP_VACE_LAYERS)))


def usp_pipeline(torch, model: str, mesh=None):
    """The usp phase's pipeline from seed 0, on the card (`usp_configs`),
    with umT5-XXL and the Wan2.1 VAE; under `mesh`, its DiT and VACE drawn
    FSDP-sharded."""
    from video_styler_tpu_torch.models.t5 import UMT5_XXL
    from video_styler_tpu_torch.models.wan_vae import WAN21_VAE
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer
    dit, vace = usp_configs(model)
    return WanVideoPipeline.from_configs(dit, vace, UMT5_XXL, WAN21_VAE,
                                         StubTokenizer(TEXT_LEN), TEXT_LEN, seed=0,
                                         device="cuda", mesh=mesh)


def usp_request(model: str, frames: int, steps: int) -> dict:
    """The request of the usp phase's model, for latents: the e2e edit, or
    a text-to-video request of the same size."""
    if model == "vace-14B":
        return dict(edit_request(frames, steps), return_latents=True)
    return dict(prompt="a cat boxing on a stage", negative_prompt="", num_frames=frames,
                height=480, width=832, seed=42, cfg_scale=5.0, num_inference_steps=steps,
                tiled=True, return_latents=True)


def park_text_encoder(pipe):
    """umT5 waits on the host and comes to the card for each prompt encode
    (`train.HostParked`), so that the ranks sharing the card leave its
    ~10.6 GiB to the others between encodes."""
    from video_styler_tpu_torch.train import HostParked
    parked = HostParked(pipe.prompter.text_encoder)
    encode = pipe.prompter.encode_prompt

    def encode_parked(*args, **kwargs):
        with parked:
            return encode(*args, **kwargs)
    pipe.prompter.encode_prompt = encode_parked


def usp_rank(spec: dict) -> dict:
    """One rank of a `usp` run (spawned by `parallel.run_local`): the
    pipeline under spec["mesh"], the request with its K1/K4/K5 launches
    counted from 0, the rank's peak memory and step times."""
    import torch
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr
    from video_styler_tpu_torch.parallel import make_mesh, process_index
    t0 = time.perf_counter()
    pipe = usp_pipeline(torch, spec["model"], make_mesh(*spec["mesh"], device_type="cuda"))
    if spec["park_t5"]:
        park_text_encoder(pipe)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    shard_gib = dit_vace_gib(pipe)
    kernels = {"K1": fa.KERNEL, "K4": fnr.ROPE_KERNEL, "K5": fnr.RMS_KERNEL,
               "K6": fa.INT8_CAPPED_KERNEL}
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    request = usp_request(spec["model"], spec["frames"], spec["steps"])
    latents = pipe(**request)
    total_s = time.perf_counter() - t0
    out = dict(rank=process_index(), latents=latents.float().cpu().numpy(),
               launches={name: kern.launches for name, kern in kernels.items()},
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, dit_vace_gib=shard_gib,
               build_s=build_s, total_s=total_s, step_s=step_times(pipe),
               stages=dict(pipe.stage_times))
    if spec.get("quantize"):
        # (e): the sharded pipeline quantised (each rank its own rows), the
        # same request again with int8 attention
        from video_styler_tpu_torch.ops.attention import set_quantized_attention
        t0 = time.perf_counter()
        pipe.quantize("int8", quantize_attention=True)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        try:
            for kern in kernels.values():
                kern.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            latents = pipe(**request)
            out["quant"] = dict(latents=latents.float().cpu().numpy(),
                                launches={n: k.launches for n, k in kernels.items()},
                                dit_vace_gib=dit_vace_gib(pipe), quantize_s=quantize_s,
                                total_s=time.perf_counter() - t0, step_s=step_times(pipe),
                                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        finally:
            set_quantized_attention(False)
    return out


def dit_vace_gib(pipe) -> float:
    """The GiB of the DiT and VACE that this process holds (its shards on a
    mesh with fsdp > 1, quantised buffers included)."""
    from video_styler_tpu_torch.parallel.fsdp import local_bytes
    return sum(local_bytes(m) for m in (pipe.dit, pipe.vace) if m is not None) / 2**30


def usp_family_pipeline(torch, family: str, frames: int, audio=None):
    """(pipeline, request) of a usp (d) run, from seeds on cuda:0, in any
    process: "animate", Wan2.2-Animate-14B on the I2V trunk (a random
    `WAN_I2V_14B` cut to USP_ANIMATE_LAYERS blocks, CLIP ViT-H/14, the
    `WAN_ANIMATE_14B` adapter) on the `animate` phase's request (the
    `frames`-frame 480x832 clip's first frame, its last 4k - 3 frames as
    the pose video and at 512x512 as the face video, CFG 5); or "s2v",
    `WAN_S2V_14B` cut to USP_S2V_LAYERS blocks (its injector after block 0)
    on the `s2v` phase's 12-frame 448x832 request with `audio` (CFG 4.5);
    both with umT5-XXL and the Wan2.1 VAE, USP_FAMILY_STEPS steps, for
    latents."""
    import dataclasses
    from video_styler_tpu_torch import wan_video_gen as G
    from video_styler_tpu_torch.models import wan_animate as A
    from video_styler_tpu_torch.models import wan_s2v as S
    from video_styler_tpu_torch.models.clip_vit import CLIP_VIT_H_14
    from video_styler_tpu_torch.models.t5 import UMT5_XXL
    from video_styler_tpu_torch.models.wan_dit import WAN_I2V_14B
    from video_styler_tpu_torch.models.wan_vae import WAN21_VAE
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer
    if family == "animate":
        pipe = WanVideoPipeline.from_configs(
            dataclasses.replace(WAN_I2V_14B, num_layers=USP_ANIMATE_LAYERS), None, UMT5_XXL,
            WAN21_VAE, StubTokenizer(TEXT_LEN), TEXT_LEN, seed=0, device="cuda",
            clip_cfg=CLIP_VIT_H_14)
        pipe.animate = random_module(torch, A.WanAnimateAdapter, A.WAN_ANIMATE_14B,
                                     A.init_wan_animate_, 10, torch.bfloat16)
        video = synthetic_clip(frames)
        request = dict(prompt="the camera slowly pushes in as the light changes",
                       negative_prompt="blurry, static", height=480, width=832,
                       num_frames=frames, seed=42, cfg_scale=5.0,
                       num_inference_steps=USP_FAMILY_STEPS, tiled=True,
                       input_image=video[0], animate_pose_video=G.animate_clip(video),
                       animate_face_video=G.animate_clip(synthetic_clip(frames, 512, 512)),
                       return_latents=True)
        return pipe, request
    pipe = WanVideoPipeline.from_configs(None, None, UMT5_XXL, WAN21_VAE,
                                         StubTokenizer(TEXT_LEN), TEXT_LEN, seed=0,
                                         device="cuda")
    pipe.s2v_model = random_module(torch, S.WanS2V, usp_s2v_config(), S.init_wan_s2v_, 20,
                                   torch.bfloat16)
    request = dict(prompt="a woman sings on a rooftop at dusk",
                   ref_image=synthetic_clip(S2V_RUN_FRAMES, 448, 832)[0],
                   negative_prompt="blurry, static", num_frames=S2V_RUN_FRAMES, height=448,
                   width=832, seed=42, cfg_scale=4.5, num_inference_steps=USP_FAMILY_STEPS,
                   tiled=True, audio_input=audio, return_latents=True)
    return pipe, request


def usp_s2v_config():
    import dataclasses
    from video_styler_tpu_torch.models import wan_s2v as S
    return dataclasses.replace(S.WAN_S2V_14B, num_layers=USP_S2V_LAYERS,
                               audio_inject_layers=(0,))


def expected_family_launches(family: str) -> dict:
    """K1/K4/K5 launches of one (d) run, a rank's or one process's: the I2V
    trunk's three attention calls a block (self, text, image) and S2V's
    (`run_s2v`'s per-step count) over two CFG passes a step."""
    if family == "animate":
        n = USP_ANIMATE_LAYERS * 2 * USP_FAMILY_STEPS
        return {"K1": 3 * n, "K4": n, "K5": n}
    cfg = usp_s2v_config()
    inj = len(cfg.audio_inject_layers)
    return {"K1": 2 * (2 * cfg.num_layers + inj) * USP_FAMILY_STEPS,
            "K4": 2 * cfg.num_layers * USP_FAMILY_STEPS,
            "K5": 2 * (cfg.num_layers + inj) * USP_FAMILY_STEPS}


def run_usp_family(torch, family: str, frames: int, audio=None, mesh=None) -> dict:
    """One (d) run (`usp_family_pipeline`), under `mesh` or in one process:
    the request's latents with its K1/K4/K5 launches counted from 0 and its
    stage peaks, then the latents decoded (width-sharded under the mesh)
    with the decode's peak above what was resident before it."""
    import numpy as np
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr
    pipe, request = usp_family_pipeline(torch, family, frames, audio)
    encode_check = {}
    if mesh is not None:
        pipe.shard(mesh)
        encode_check = usp_encode_check(torch, pipe, request)
    kernels = {"K1": fa.KERNEL, "K4": fnr.ROPE_KERNEL, "K5": fnr.RMS_KERNEL}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels.values():
            kern.launches = 0
        t0 = time.perf_counter()
        latents = (pipe.s2v if family == "s2v" else pipe)(**request)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = {name: kern.launches for name, kern in kernels.items()}
        stage_peaks = {k: v / 2**30 for k, v in pipe.stage_peak_bytes}
        stages = dict(pipe.stage_times)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        video = pipe.decode_video(latents)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        frames_out = pipe.vae_output_to_video(video)
    finally:
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return dict(latents=latents.float().cpu().numpy(), frames=frames_out, launches=launches,
                stage_peak_gib=stage_peaks, stages=stages, total_s=total_s,
                decode_s=decode_s, decode_peak_above_resident_gib=decode_peak,
                finite=bool(np.isfinite(frames_out).all()), encode_check=encode_check)


def usp_encode_check(torch, pipe, request) -> dict:
    """The request's image (`input_image` or `ref_image`) encoded by the
    pipeline's VAE in fp32, width-sharded under its mesh and whole in this
    process: their relative L2 distance, and the share of latents whose
    bf16 rounding (the pipeline's dtype) differs."""
    from video_styler_tpu_torch.models import wan_vae as V
    from video_styler_tpu_torch.parallel import use_sharding
    from video_styler_tpu_torch.pipelines.wan_video import _image_array, _preprocess_images
    image = request.get("input_image", request.get("ref_image"))
    clip = torch.from_numpy(_preprocess_images([_image_array(
        image, request["width"], request["height"])])).cuda()
    with torch.no_grad():
        with use_sharding(pipe.sharding_ctx):
            shared = V.encode(pipe.vae, clip, tiled=True)
        whole = V.encode(pipe.vae, clip, tiled=True)
    flips = (shared.to(torch.bfloat16) != whole.to(torch.bfloat16)).float().mean().item()
    return dict(encode_fp32_rel_l2=((shared - whole).norm() / whole.norm()).item(),
                encode_fp32_max_abs=(shared - whole).abs().max().item(),
                bf16_flip_share=flips)


def usp_family_rank(spec: dict) -> dict:
    """`usp` (d), one rank of the (1, 1, 2) mesh: Animate, then S2V."""
    import torch
    from video_styler_tpu_torch.parallel import make_mesh, process_index
    mesh = make_mesh(1, 1, 2, device_type="cuda")
    out = dict(rank=process_index())
    for family in ("animate", "s2v"):
        out[family] = run_usp_family(torch, family, spec["frames"], spec["audio"], mesh)
    return out


def usp_s2v_audio(torch):
    """The (d) S2V request's audio: 5 s of synthetic audio through a random
    `WAV2VEC2_XLSR_53` tower (seed 21, fp32), as in the `s2v` phase."""
    from video_styler_tpu_torch import wan_video_gen as G
    from video_styler_tpu_torch.models import wav2vec as W
    from video_styler_tpu_torch.models.audio_features import extract_audio_features
    w2v = random_module(torch, W.Wav2Vec2, W.WAV2VEC2_XLSR_53, W.init_wav2vec_, 21,
                        torch.float32)
    audio = extract_audio_features(G.smoke_waveform(64), num_frames=S2V_RUN_FRAMES, model=w2v)
    del w2v
    gc.collect()
    torch.cuda.empty_cache()
    return audio


def run_usp_families(torch, frames: int, store_dir: str, smi: str, failures: list) -> dict:
    """`usp` (d): the Animate and S2V runs in this process, then on two
    ranks of the (1, 1, 2) mesh on cuda:0 over gloo; per rank the latents
    and frames against this process's (5%), the VAE peaks against this
    process's and the launches against the derived count. Returns rank 0's
    launches summed over both runs."""
    import numpy as np
    from video_styler_tpu_torch.parallel import run_local
    audio = usp_s2v_audio(torch)
    one = {family: run_usp_family(torch, family, frames, audio)
           for family in ("animate", "s2v")}
    t0 = time.perf_counter()
    ranks = run_local(usp_family_rank, 2, "gloo", os.path.join(store_dir, "families"),
                      dict(frames=frames, audio=audio), device="cuda:0", timeout_s=900)
    wall_s = time.perf_counter() - t0
    total = {}

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for family, layers in (("animate", USP_ANIMATE_LAYERS), ("s2v", USP_S2V_LAYERS)):
        ref = one[family]
        expected = expected_family_launches(family)
        res = dict(phase=f"usp_{family}", mesh=dict(dp=1, fsdp=1, sp=2), backend="gloo",
                   card=smi, note="2 ranks share one card over gloo: times are not a "
                                  "multi-card speed",
                   recipe="Wan2.2-Animate-14B" if family == "animate" else "Wan2.2-S2V-14B",
                   layers=layers, steps=USP_FAMILY_STEPS,
                   latents_rel_l2=[rel(r[family]["latents"], ref["latents"]) for r in ranks],
                   frames_rel_l2=[rel(r[family]["frames"], ref["frames"]) for r in ranks],
                   frames_mean_abs_diff=[float(np.abs(r[family]["frames"].astype(np.int16)
                                                      - ref["frames"]).mean())
                                         for r in ranks],
                   tol=5e-2,
                   ranks_bit_equal=bool(np.array_equal(ranks[0][family]["latents"],
                                                       ranks[1][family]["latents"])),
                   launches=[r[family]["launches"] for r in ranks],
                   one_process_launches=ref["launches"], expected_launches=expected,
                   stage_peak_gib=[r[family]["stage_peak_gib"] for r in ranks],
                   one_process_stage_peak_gib=ref["stage_peak_gib"],
                   decode_peak_above_resident_gib=[r[family]["decode_peak_above_resident_gib"]
                                                   for r in ranks],
                   one_process_decode_peak_above_resident_gib=ref[
                       "decode_peak_above_resident_gib"],
                   stages=[r[family]["stages"] for r in ranks],
                   one_process_stages=ref["stages"],
                   decode_s=[r[family]["decode_s"] for r in ranks],
                   one_process_decode_s=ref["decode_s"],
                   total_s=[r[family]["total_s"] for r in ranks],
                   one_process_total_s=ref["total_s"], wall_s=wall_s,
                   encode_check=[r[family]["encode_check"] for r in ranks],
                   frames_shape=list(ref["frames"].shape))
        emit(res)
        if any(r[family]["launches"] != expected for r in ranks) \
                or ref["launches"] != expected:
            failures.append(f"{family} mesh (1, 1, 2): launches {res['launches']}, "
                            f"one process {ref['launches']}, expected {expected}")
        worst = max(res["latents_rel_l2"] + res["frames_rel_l2"])
        if not (worst <= 5e-2 and all(r[family]["finite"] for r in ranks)):
            failures.append(f"{family} mesh (1, 1, 2): latents {res['latents_rel_l2']}, "
                            f"frames {res['frames_rel_l2']} from one process")
        _summed(total, ranks[0][family]["launches"])
    return total


def ditto_mesh_rank(out_dir: str) -> dict:
    """`usp` (c): `infer_ditto --smoke --mesh 1,1,1` on a one-rank NCCL
    group against the same CLI without --mesh (frames), and the smoke
    pipeline's latents under the (1, 1, 1) mesh against none."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from video_styler_tpu_torch import infer_ditto
    from video_styler_tpu_torch.parallel import make_mesh
    argv = ["--smoke", "--prompt", "a watercolor city at dusk"]
    meshed = infer_ditto.main(argv + ["--mesh", "1,1,1", "--output_path",
                                      os.path.join(out_dir, "mesh.mp4")])
    plain = infer_ditto.main(argv + ["--output_path", os.path.join(out_dir, "plain.mp4")])
    request = dict(prompt="a watercolor city at dusk",
                   vace_video=infer_ditto.smoke_frames(9, 32, 32), num_frames=9, height=32,
                   width=32, seed=42, cfg_scale=5.0, num_inference_steps=4, tiled=False,
                   return_latents=True)
    lat_mesh = infer_ditto.build_smoke_pipeline().shard(make_mesh(1, 1, 1))(**request)
    lat = infer_ditto.build_smoke_pipeline()(**request)
    return dict(backend=dist.get_backend(), world_size=dist.get_world_size(),
                frames_bit_equal=bool(np.array_equal(meshed, plain)),
                latents_bit_equal=bool(torch.equal(lat_mesh, lat)),
                latents_max_abs_diff=(lat_mesh.float() - lat.float()).abs().max().item())


def expected_usp_launches(model: str, steps: int) -> dict:
    """K1/K4/K5 launches of one rank: those of one process (two K1 and one
    K4 and K5 per block, DiT and VACE, and forward; two forwards a step);
    no K6 before (e) quantises."""
    dit, vace = usp_configs(model)
    layers = dit.num_layers + (0 if vace is None else len(vace.vace_layers))
    forwards = 2 * steps
    return {"K1": 2 * layers * forwards, "K4": layers * forwards, "K5": layers * forwards,
            "K6": 0}


def run_usp(torch, frames: int, steps: int, smi: str):
    """`usp` (last, on a free card): ranks spawned by `parallel.run_local`
    on cuda:0 with gloo named (NCCL refuses two ranks on one device).
    (a) Wan2.1-T2V-1.3B at full width cut to USP_T2V_LAYERS blocks on the
    mesh (1, 2, 2), against the same model in this process; (b) the e2e edit at
    Wan2.1-VACE-14B width cut to USP_VACE_LAYERS blocks on (1, 2, 1), FSDP
    over 2 ranks, for USP_VACE_STEPS steps, against the same model and
    request in this process; (e) in (b)'s ranks, the sharded pipeline
    quantised to int8 with int8 attention and the request again, against
    the same in this process; (d) Animate and S2V on (1, 1, 2)
    (`run_usp_families`); (c) `ditto_mesh_rank` on a one-rank NCCL group.
    Returns rank 0's launches summed over (a), (b), (e) and (d)."""
    import numpy as np
    from video_styler_tpu_torch.parallel import run_local
    from video_styler_tpu_torch.ops.attention import set_quantized_attention
    store_dir = tempfile.mkdtemp(prefix="usp-")
    references, quantized = {}, {}
    for model, n_steps in (("t2v-1.3B", steps), ("vace-14B", USP_VACE_STEPS)):
        pipe = usp_pipeline(torch, model)
        request = usp_request(model, frames, n_steps)
        references[model] = pipe(**request).float().cpu().numpy()
        if model == "vace-14B":
            # (e)'s reference: the same model quantised in one process
            pipe.quantize("int8", quantize_attention=True)
            try:
                quantized = dict(latents=pipe(**request).float().cpu().numpy(),
                                 dit_vace_gib=dit_vace_gib(pipe))
            finally:
                set_quantized_attention(False)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    total, failures = {}, []
    runs = [("t2v-1.3B", (1, 2, 2), steps, False), ("vace-14B", (1, 2, 1), USP_VACE_STEPS, True)]
    for model, mesh, n_steps, park in runs:
        reference = references[model]
        world = math.prod(mesh)
        spec = dict(model=model, mesh=mesh, frames=frames, steps=n_steps, park_t5=park,
                    quantize=model == "vace-14B")
        t0 = time.perf_counter()
        ranks = run_local(usp_rank, world, "gloo",
                          os.path.join(store_dir, f"{model}-{world}-{mesh[1]}"), spec,
                          device="cuda:0", timeout_s=900)
        wall_s = time.perf_counter() - t0
        expected = expected_usp_launches(model, n_steps)
        rel = [float(np.linalg.norm(r["latents"] - reference) / np.linalg.norm(reference))
               for r in ranks]
        res = dict(phase="usp", model=model, mesh=dict(zip(("dp", "fsdp", "sp"), mesh)),
                   backend="gloo", card=smi,
                   note=f"{world} ranks share one card over gloo: step times are not a "
                        "multi-card speed",
                   frames=frames, tokens=math.prod(token_grid(frames)), steps=n_steps,
                   cfg="two-pass 5.0", latents_rel_l2=rel, latents_tol=5e-2,
                   bit_equal_to_one_process=[bool(np.array_equal(r["latents"], reference))
                                             for r in ranks],
                   ranks_bit_equal=all(np.array_equal(r["latents"], ranks[0]["latents"])
                                       for r in ranks),
                   peak_gib=[r["peak_gib"] for r in ranks],
                   dit_vace_gib=[r["dit_vace_gib"] for r in ranks],
                   launches=[r["launches"] for r in ranks], expected_launches=expected,
                   step_s=[r["step_s"] for r in ranks], total_s=[r["total_s"] for r in ranks],
                   build_s=[r["build_s"] for r in ranks], wall_s=wall_s,
                   stages=ranks[0]["stages"])
        emit(res)
        if any(r["launches"] != expected for r in ranks):
            failures.append(f"{model} mesh {mesh}: launches {res['launches']}, "
                            f"expected {expected} a rank")
        if not max(rel) <= 5e-2:
            failures.append(f"{model} mesh {mesh}: latents {rel} from one process")
        for name, count in ranks[0]["launches"].items():
            total[name] = total.get(name, 0) + count
        if spec["quantize"]:
            # (e): K6 takes every attention call K1 took
            q_expected = {"K6": expected["K1"], "K4": expected["K4"], "K5": expected["K5"]}
            q_rel = [float(np.linalg.norm(r["quant"]["latents"] - quantized["latents"])
                           / np.linalg.norm(quantized["latents"])) for r in ranks]
            emit(dict(phase="usp_quant", model=model,
                      mesh=dict(zip(("dp", "fsdp", "sp"), mesh)), backend="gloo", card=smi,
                      mode="int8 linears + int8 attention (K6)", steps=n_steps,
                      latents_rel_l2=q_rel, latents_tol=5e-2,
                      ranks_bit_equal=bool(np.array_equal(ranks[0]["quant"]["latents"],
                                                          ranks[1]["quant"]["latents"])),
                      dit_vace_gib=[r["quant"]["dit_vace_gib"] for r in ranks],
                      one_process_dit_vace_gib=quantized["dit_vace_gib"],
                      bf16_dit_vace_gib=[r["dit_vace_gib"] for r in ranks],
                      launches=[r["quant"]["launches"] for r in ranks],
                      expected_launches=q_expected,
                      quantize_s=[r["quant"]["quantize_s"] for r in ranks],
                      step_s=[r["quant"]["step_s"] for r in ranks],
                      total_s=[r["quant"]["total_s"] for r in ranks],
                      peak_gib=[r["quant"]["peak_gib"] for r in ranks]))
            if any({k: v for k, v in r["quant"]["launches"].items() if v} != q_expected
                   for r in ranks):
                failures.append(f"{model} quantised on {mesh}: launches "
                                f"{[r['quant']['launches'] for r in ranks]}, expected "
                                f"{q_expected} a rank")
            if not max(q_rel) <= 5e-2:
                failures.append(f"{model} quantised on {mesh}: latents {q_rel} from one "
                                f"process")
            for name, count in ranks[0]["quant"]["launches"].items():
                total[name] = total.get(name, 0) + count
    _summed(total, run_usp_families(torch, frames, store_dir, smi, failures))
    res = run_local(ditto_mesh_rank, 1, "nccl", os.path.join(store_dir, "nccl"), store_dir,
                    timeout_s=300)[0]
    emit(dict(phase="usp_nccl_mesh_1_1_1", **res))
    if not (res["backend"] == "nccl" and res["frames_bit_equal"] and res["latents_bit_equal"]):
        failures.append(f"infer_ditto --mesh 1,1,1 differs from the run without: {res}")
    shutil.rmtree(store_dir, ignore_errors=True)
    if failures:
        raise AssertionError("usp: " + "; ".join(failures))
    return total




def composed_request(phase: str, stages: dict, step_s, steps: int, **extra):
    """A recipe's request of `steps` steps composed from a measured request's
    stages other than its steps and its fastest step (not run)."""
    stages = {k: v for k, v in stages.items() if not k.startswith("denoise_step_")}
    emit(dict(phase=phase, steps=steps, note="composed from this run's stages and its "
              "fastest step, not run", image_s=sum(stages.values()) + steps * min(step_s),
              stages=stages, step_s_min=min(step_s), **extra, **CARD))


def profile_request(torch, run, unprofiled_s: float, categories=None):
    """Device time by kernel category (KERNEL_CATEGORIES unless given) over
    one more identical request, under torch.profiler tracing the card alone
    (the host's operators are not recorded: the same kernels and device
    times at about half the profiled run's cost). idle_share compares the
    summed kernel time with the unprofiled request's wall time (the
    profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    totals, per_kernel = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        cat = next((c for c, keys in categories or KERNEL_CATEGORIES
                    if any(k in evt.name for k in keys)), "other")
        totals[cat] = totals.get(cat, 0.0) + us / 1e3
        per_kernel[evt.name[:90]] = per_kernel.get(evt.name[:90], 0.0) + us / 1e3
    busy_ms = sum(totals.values())
    if not busy_ms:
        raise AssertionError("the profiler recorded no kernel on the card")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ms_by_category=totals, device_busy_ms=busy_ms,
                unprofiled_wall_ms=unprofiled_s * 1e3,
                idle_share=(1.0 - busy_ms / (unprofiled_s * 1e3)) if busy_ms else None,
                top_kernels_ms=dict(top))


# ---------------------------------------------------------------------------
# Image-family and streamed LoRA training
# ---------------------------------------------------------------------------

FLUX_LORA_RANK = 4          # the JAX family recipe's default rank, on every linear
FLUX_LORA_SIZE = 1024
STREAM_TRAIN_RANK = 128     # the Ditto recipe's VACE LoRA
HF_VOCAB = 128              # the tiny `transformers` models' vocabulary


def check_flux_lora_kernels(torch):
    """`flux_lora_kernels`: K1 with its stats output and K3 at the FLUX
    LoRA step's attention, 24 heads of 128 over 4,608 [text | image]
    tokens (every row and head checked), with SDPA's forward and backward
    as the library times. K3's dq-only twin is checked too, but its row is
    left out of the kernels line: no FLUX attention takes it (q, k and v all
    come from LoRA'd linears)."""
    s = flux_tokens(FLUX_LORA_SIZE)
    rows = check_attention_training(torch, s, s, f"flux-lora-{FLUX_LORA_SIZE}px", "self",
                                    heads=FLUX_HEADS)
    return [r for r in rows if r["kernel"] != "K3q"]


def expected_flux_lora_launches(cfg, steps: int) -> dict:
    """K1 with stats runs each block's joint attention in the forward and
    again in its remat recompute; K3 (dq, dk, dv) once a block in the
    backward: q, k and v all come from LoRA'd linears."""
    blocks = cfg.num_joint_blocks + cfg.num_single_blocks
    return {"K1": 2 * blocks * steps, "K3": blocks * steps}


def run_flux_lora(torch, pipe, kernels, steps: int) -> dict:
    """`flux_lora`: the JAX family recipe's LoRA (rank 4 on every linear,
    fp32, Adam at 1e-4) on the resident FLUX.1-dev DiT at full width and
    depth, bf16 weights, `remat=True`: --steps steps at 1024x1024 through
    `trainers.image_training` (flow match, shift 3, the bell weights) on
    seeded latents and the phase's T5 and CLIP encode of a prompt (made
    once, before the steps; the text towers stay resident: they fit).
    Step seconds, peak memory, the loss of each step, and K1 / K3 / K3q
    launches against `expected_flux_lora_launches`."""
    from video_styler_tpu_torch.models.flux_dit import flux_dit_forward
    from video_styler_tpu_torch.pipelines.wan_video import generate_noise
    from video_styler_tpu_torch.trainers.image_training import make_image_lora_train_step
    from video_styler_tpu_torch.trainers.lora_train import (apply_lora, init_lora,
                                                            lora_parameters)
    cfg = pipe.dit_cfg
    with torch.no_grad():
        emb, pooled, _ = pipe.encode_prompt(FLUX_PROMPT)
    latents = (0.5 * generate_noise((1, 16, FLUX_LORA_SIZE // 8, FLUX_LORA_SIZE // 8),
                                    seed=7)).to("cuda", torch.bfloat16)
    lora = init_lora(pipe.dit, rank=FLUX_LORA_RANK, targets=("*",),
                     generator=torch.Generator().manual_seed(1))
    apply_lora(pipe.dit, lora)
    params = lora_parameters(lora)

    def forward(x, t, c):
        return flux_dit_forward(pipe.dit, x, t, c[0], c[1], remat=True)
    step = make_image_lora_train_step(forward, torch.optim.Adam(params, lr=1e-4))
    gen = torch.Generator().manual_seed(10)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(latents, (emb, pooled), generator=gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {name: kern.launches for name, kern in kernels.items()}
    expected = expected_flux_lora_launches(cfg, steps)
    res = dict(phase="flux_lora", model="FLUX.1-dev", dit_dim=cfg.dim,
               dit_heads=cfg.num_heads, joint_blocks=cfg.num_joint_blocks,
               single_blocks=cfg.num_single_blocks, size=FLUX_LORA_SIZE,
               tokens=flux_tokens(FLUX_LORA_SIZE), steps=steps, lora_rank=FLUX_LORA_RANK,
               lora_targets='every linear ("*")', lora_linears=len(lora),
               lora_params=sum(p.numel() for p in params), optimizer="Adam 1e-4",
               remat=True, dtype="bf16 weights and activations, fp32 LoRA",
               losses=losses, step_s=step_s,
               memory_allocated_before_gib=before / 2**30,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               dit_weights_gib=gib([pipe.dit]), launches=launches,
               expected_launches=expected, **CARD)
    emit(res)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"flux_lora: non-finite loss {losses}")
    check_launches(launches, expected, "flux_lora")
    return launches


def run_flux_lora_alone(torch, kernels, steps: int) -> dict:
    """`flux_lora` on a FLUX.1-dev pipeline of its own (for --only)."""
    from video_styler_tpu_torch.models.flux_dit import FLUX_DEV
    from video_styler_tpu_torch.models.sd3_text_encoder import CLIP_L
    from video_styler_tpu_torch.models.sd3_vae import FLUX_VAE
    from video_styler_tpu_torch.models.t5 import T5_V11_XXL
    pipe = flux_pipeline(torch, (FLUX_DEV, CLIP_L, T5_V11_XXL, FLUX_VAE), "cuda")
    try:
        return run_flux_lora(torch, pipe, kernels, steps)
    finally:
        del pipe
        gc.collect()
        torch.cuda.empty_cache()


def _flat(torch, grads) -> "torch.Tensor":
    """A LoRA's A and B gradients ({name: {"A", "B"}}) as one fp32 CPU
    vector."""
    return torch.cat([g[k].detach().float().reshape(-1).cpu() for g in grads.values()
                      for k in ("A", "B")])


def _grads_of(torch, lora) -> dict:
    """{name: {"A", "B"}} of each LoRA factor's `.grad`, zeros where a
    linear got none (the forward never reached it)."""
    return {n: {k: ab[k].grad if ab[k].grad is not None else torch.zeros_like(ab[k])
                for k in ("A", "B")} for n, ab in lora.items()}


def check_image_lora_reference(torch, kernels):
    """`image_lora_reference`: one LoRA step of each family's tiny model on
    the card and on the CPU from the same weights, LoRA, inputs, tid and
    noise (`train_lora.smoke_pack`): FLUX and Qwen-Image at heads of 128
    (K1 forward, K3 backward; bf16, remat), SD3 (heads of 64: the exact
    `sdpa`; bf16), the real tiny SD UNet (fp32; the exact `sdpa`) with
    the UNet LoRA's targets through `trainers.sd_training`, and FLUX,
    Qwen-Image (K1f, K3f) and SD3 again in fp32, as `train_lora --smoke`
    runs them on the card. Loss and LoRA gradients within 5% relative L2."""
    from video_styler_tpu_torch import train_lora
    from video_styler_tpu_torch.models import sd as SDM
    from video_styler_tpu_torch.trainers.lora_train import apply_lora, init_lora, lora_parameters
    from video_styler_tpu_torch.trainers.sd_training import (init_sd_lora,
                                                             make_sd_lora_train_step)
    res = dict(phase="image_lora_reference", loss_rel={}, grads_rel_l2={}, k1={}, k3={},
               tol=5e-2)
    cases = [(f, torch.bfloat16, f) for f in ("flux", "qwen_image", "sd3")]
    cases += [("sd_unet", torch.float32, "sd_unet")]
    cases += [(f, torch.float32, f"{f} fp32") for f in ("flux", "qwen_image", "sd3")]
    for family, dtype, key in cases:
        out = []
        k1, k3 = ("K1", "K3") if dtype == torch.bfloat16 else ("K1f", "K3f")
        for dev in ("cpu", "cuda"):
            if family == "sd_unet":
                gen = torch.Generator().manual_seed(1)
                unet = SDM.init_sd_module_(SDM.SDUNet(SDM.SD_UNET_TINY), gen).eval()
                unet = unet.to(dev).requires_grad_(False)
                lat = torch.randn((1, 4, 16, 16), generator=gen).to(dev)
                ctx = torch.randn((1, 77, SDM.SD_UNET_TINY.text_dim), generator=gen).to(dev)
                lora = init_sd_lora(unet, rank=4, generator=torch.Generator().manual_seed(2))
                apply_lora(unet, lora)

                def fwd(s, t, c, unet=unet):
                    return SDM.sd_unet_forward(unet, s, t, c)
                step = make_sd_lora_train_step(
                    fwd, torch.optim.SGD(lora_parameters(lora), lr=0.0))
            else:
                model, fwd, lat, ctx = train_lora.smoke_pack(
                    family, dev, dtype, card_widths=True, remat=dev == "cuda")
                lora = train_lora.lora_setup(family, model, rank=4)
                step = train_lora.make_step(family, fwd,
                                            torch.optim.SGD(lora_parameters(lora), lr=0.0))
            for kern in kernels.values():
                kern.launches = 0
            loss = step(lat, ctx, generator=torch.Generator().manual_seed(3))
            out.append((float(loss), _flat(torch, _grads_of(torch, lora))))
            if dev == "cuda":
                res["k1"][key] = kernels[k1].launches
                res["k3"][key] = kernels[k3].launches
        (lc, gc_), (lg, gg) = out
        res["loss_rel"][key] = abs(lg - lc) / abs(lc)
        res["grads_rel_l2"][key] = ((gg - gc_).norm() / gc_.norm()).item()
    emit(res)
    bad = [f for f in res["loss_rel"] if not (res["loss_rel"][f] <= 5e-2
                                              and res["grads_rel_l2"][f] <= 5e-2)]
    # the tiny FLUX (2 + 2 blocks) and Qwen-Image (2 blocks): K1 (K1f) in
    # the forward and the remat recompute, K3 (K3f) in the backward, a block
    # each
    want = {"flux": (8, 4), "qwen_image": (4, 2), "sd3": (0, 0), "sd_unet": (0, 0),
            "flux fp32": (8, 4), "qwen_image fp32": (4, 2), "sd3 fp32": (0, 0)}
    bad += [f for f, (k1, k3) in want.items() if (res["k1"][f], res["k3"][f]) != (k1, k3)]
    if bad:
        raise AssertionError(f"image LoRA steps, card vs CPU: {bad}: {res}")


def hf_tiny_models(torch, root: str) -> dict:
    """A tiny Qwen2.5-VL (2 text layers, 2 heads of 128, one k/v head, a
    2-block vision tower of 2 heads of 80) and a tiny LLaMA (3 layers, the
    same heads) over a 128-token vocabulary, built from configs with
    seeded weights (norm weights off 1) and written by `save_pretrained`
    under `root`. -> {"qwen": dir, "llama": dir}."""
    from transformers import (LlamaConfig, LlamaModel, Qwen2_5_VLConfig,
                              Qwen2_5_VLForConditionalGeneration)
    from video_styler_tpu_torch.models.qwen_vl_embedder import StubQwenTokenizer
    ids = StubQwenTokenizer(HF_VOCAB).special_ids

    def text(layers, theta, eps):
        return dict(vocab_size=HF_VOCAB, hidden_size=256, num_hidden_layers=layers,
                    num_attention_heads=2, num_key_value_heads=1, intermediate_size=128,
                    rope_theta=theta, rms_norm_eps=eps)
    qcfg = Qwen2_5_VLConfig(
        text_config=dict(text(2, 1e6, 1e-6),
                         rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]}),
        vocab_size=HF_VOCAB, hidden_size=256,
        vision_config=dict(depth=2, hidden_size=160, num_heads=2, intermediate_size=96,
                           out_hidden_size=256, patch_size=14, temporal_patch_size=2,
                           spatial_merge_size=2, window_size=112, fullatt_block_indexes=[1]),
        image_token_id=ids["<|image_pad|>"], video_token_id=ids["<|video_pad|>"],
        vision_start_token_id=ids["<|vision_start|>"])
    out = {}
    for name, build in (("qwen", lambda: Qwen2_5_VLForConditionalGeneration(qcfg)),
                        ("llama", lambda: LlamaModel(LlamaConfig(**text(3, 5e5, 1e-5))))):
        torch.manual_seed(0)
        model = build()
        with torch.no_grad():
            for pname, p in model.named_parameters():
                if pname.endswith("norm.weight") or "layernorm" in pname:
                    p.add_(0.1 * torch.randn(p.shape))
        out[name] = os.path.join(root, name)
        model.save_pretrained(out[name])
    return out


def check_transformers_backends(torch):
    """`transformers_backends`: the two `transformers` backends on the card
    (`QwenImagePipeline.fetch_text_encoder(backend="transformers")`, HF's
    Qwen2.5-VL; `HunyuanVideoPipeline.fetch_llm(backend="transformers")`,
    HF's LlamaModel at the native path's layer) against the port's native
    paths on the same `save_pretrained` files, fp32, two prompts: the
    card's `transformers` version, the key names it wrote, and the
    embeddings' relative L2 (within 1e-4)."""
    import transformers
    from safetensors import safe_open
    from video_styler_tpu_torch.models.qwen_vl_embedder import StubQwenTokenizer
    from video_styler_tpu_torch.pipelines import hunyuan_video as HV
    from video_styler_tpu_torch.pipelines import qwen_image as QI
    root = tempfile.mkdtemp(prefix="chip_smoke_hf_")
    try:
        dirs = hf_tiny_models(torch, root)
        names = {}
        for name, d in dirs.items():
            with safe_open(os.path.join(d, "model.safetensors"), "pt") as f:
                keys = sorted(f.keys())
            names[name] = [k for k in keys if ".0." in k][:3]
        prompts = ("a red fox running through deep snow at dawn", "")
        res = dict(phase="transformers_backends", transformers=transformers.__version__,
                   saved_names=names, rel_l2={}, tol=1e-4)
        qtok = StubQwenTokenizer(HF_VOCAB)
        pipes = {}
        for backend, path in (("native", os.path.join(dirs["qwen"], "model.safetensors")),
                              ("transformers", dirs["qwen"])):
            pipes[backend] = QI.QwenImagePipeline(device="cuda", dtype=torch.float32)
            pipes[backend].fetch_text_encoder(path, qtok, backend=backend)
        res["rel_l2"]["qwen"] = [_rel_l2(pipes["transformers"].encode_prompt(p)[0].cpu(),
                                         pipes["native"].encode_prompt(p)[0].cpu())
                                 for p in prompts]
        ltok = HV.StubLlamaTokenizer(HF_VOCAB)
        for backend, path in (("native", os.path.join(dirs["llama"], "model.safetensors")),
                              ("transformers", dirs["llama"])):
            pipes[backend] = HV.HunyuanVideoPipeline(device="cuda", dtype=torch.float32)
            pipes[backend].fetch_llm(path, ltok, backend=backend)
        res["rel_l2"]["llama"] = [_rel_l2(pipes["transformers"].llm(p)[0].cpu(),
                                          pipes["native"].llm(p)[0].cpu()) for p in prompts]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(res)
    if not all(v <= 1e-4 for vs in res["rel_l2"].values() for v in vs):
        raise AssertionError(f"transformers backends against the native paths: {res}")


def expected_streaming_train_launches(n_trunk: int, vace_layers, mode: str, seg_k: int,
                                      cross_kv: bool) -> dict:
    """K1 / K4 / K5 / K3 / K3q launches of one streamed VACE-LoRA step with
    sub_remat, from the configuration. The walk's schedule: trunk block j,
    then VACE block i after trunk layer vace_layers[i]. Trunk blocks before
    the first VACE block need no backward. Every block forward runs K1
    twice (self, cross), K4 and K5 once; a block's backward runs the
    block's three checkpointed stages forward, then again in its backward
    (K1 4, K4 2, K5 2), K3 for self-attention, and for cross-attention K3
    where its k / v carry the LoRA (the VACE blocks' with `cross_kv`), K3q
    where they come from the frozen text (the trunk's). "device" mode
    recomputes, segment by segment, the inputs of all but a segment's last
    item that trains."""
    schedule = []
    for j in range(n_trunk):
        schedule.append("trunk")
        if j in vace_layers:
            schedule.append("vace")
    first = schedule.index("vace")
    bwd = [si for si in range(len(schedule)) if si >= first]
    forwards = len(schedule)
    if mode == "device":
        for s0 in range(0, len(schedule), seg_k):
            seg = [si for si in bwd if s0 <= si < s0 + seg_k]
            if seg:
                forwards += seg[-1] - s0
    n_vace = schedule.count("vace")
    n_trunk_bwd = len(bwd) - n_vace
    return {"K1": 2 * forwards + 4 * len(bwd), "K4": forwards + 2 * len(bwd),
            "K5": forwards + 2 * len(bwd),
            "K3": len(bwd) + (n_vace if cross_kv else 0),
            "K3q": n_trunk_bwd + (0 if cross_kv else n_vace)}


def streaming_lora(torch, vace_cfg, device, rank: int, seed: int, scale_b: float = 1e-3):
    """A per-block LoRA on every VACE block's q, k, v, o (self and cross),
    ffn.0 and ffn.2 (the Ditto recipe's targets), fp32 on `device`, B off
    zero (so that A's gradients are not zero by construction), in the
    port's layout (`blocks.{i}.self_attn.q`, ..., `blocks.{i}.ffn.fc2`)."""
    from torch import nn
    gen = torch.Generator().manual_seed(seed)
    dim, ffn = vace_cfg.dim, vace_cfg.ffn_dim
    shapes = {f"{a}.{n}": (dim, dim) for a in ("self_attn", "cross_attn") for n in "qkvo"}
    shapes.update({"ffn.fc1": (dim, ffn), "ffn.fc2": (ffn, dim)})
    lora = {}
    for i in range(len(vace_cfg.vace_layers)):
        for name, (in_f, out_f) in shapes.items():
            a = torch.randn((rank, in_f), generator=gen) / rank
            b = torch.randn((out_f, rank), generator=gen) * scale_b
            lora[f"blocks.{i}.{name}"] = {"A": nn.Parameter(a.to(device)),
                                          "B": nn.Parameter(b.to(device))}
    return lora


def check_streaming_train_reference(torch, kernels):
    """`streaming_train_reference`: the smoke VACE pipeline's DiT and VACE
    streamed from an int8 store (one trunk block resident, the rest through
    the ring), one streamed VACE-LoRA gradient on the card against the same
    on the CPU (same weights, LoRA and inputs), "device" mode with 2-item
    segments and "host" mode; loss and gradients within 5% relative L2, and
    K1 / K3 / K3q launches on the card against the derived counts."""
    from video_styler_tpu_torch.infer_ditto import build_smoke_pipeline
    from video_styler_tpu_torch.models.wan_streaming import WanBlockStreamer
    from video_styler_tpu_torch.trainers.streaming_train import StreamingTrainer
    cpu = build_smoke_pipeline(device="cpu", seed=0)
    gen = torch.Generator().manual_seed(4)
    f_lat, h, w = 3, 8, 8
    inputs = [torch.randn((1, cpu.dit.cfg.in_dim, f_lat, h, w), generator=gen),
              torch.tensor([600.0]),
              torch.randn((1, 16, cpu.dit.cfg.text_dim), generator=gen),
              torch.randn((1, cpu.dit.cfg.out_dim, f_lat, h, w), generator=gen),
              torch.randn((1, cpu.vace.cfg.vace_in_dim, f_lat, h, w), generator=gen)]
    res = dict(phase="streaming_train_reference", store="int8", resident_blocks=1,
               loss_rel={}, grads_rel_l2={}, launches={}, expected_launches={}, tol=5e-2)
    out = {}
    for dev in ("cpu", "cuda"):
        dit = copy.deepcopy(cpu.dit).to(dev)
        vace = copy.deepcopy(cpu.vace).to(dev)
        streamer = WanBlockStreamer(dit, vace, mode="int8", resident_blocks=1,
                                    prefetch_depth=2)
        lora = streaming_lora(torch, vace.cfg, dev, rank=8, seed=5, scale_b=0.05)
        for ckpt in ("device", "host"):
            trainer = StreamingTrainer(streamer, activation_ckpt=ckpt, segment=2)
            for kern in kernels.values():
                kern.launches = 0
            x, t, ctx, target, vctx = (a.to(dev) for a in inputs)
            loss, _, grads = trainer.loss_and_grads(
                x.to(torch.bfloat16), t, ctx.to(torch.bfloat16), target,
                vace_context=vctx.to(torch.bfloat16), vace_scale=0.8, vace_lora=lora)
            out[(dev, ckpt)] = (float(loss), _flat(torch, grads))
            if dev == "cuda":
                res["launches"][ckpt] = {k: kernels[k].launches
                                         for k in ("K1", "K3", "K3q", "K4", "K5")}
                res["expected_launches"][ckpt] = expected_streaming_train_launches(
                    dit.cfg.num_layers, vace.cfg.vace_layers, ckpt, 2, cross_kv=True)
    for ckpt in ("device", "host"):
        (lc, gcpu), (lg, ggpu) = out[("cpu", ckpt)], out[("cuda", ckpt)]
        res["loss_rel"][ckpt] = abs(lg - lc) / abs(lc)
        res["grads_rel_l2"][ckpt] = ((ggpu - gcpu).norm() / gcpu.norm()).item()
    emit(res)
    ok = all(v <= 5e-2 for v in list(res["loss_rel"].values())
             + list(res["grads_rel_l2"].values()))
    if not ok or res["launches"] != res["expected_launches"]:
        raise AssertionError(f"streamed LoRA gradients, card vs CPU: {res}")


def run_streaming_train(torch, kernels, pipe, frames: int, smi: str) -> dict:
    """`streaming_train`: on the `streaming` phase's int8 store (13.5 GB
    budget, depth 3) at full width, the Ditto recipe's VACE LoRA (rank 128
    on q, k, v, o, ffn.0, ffn.2 of the 8 VACE blocks, fp32), one streamed
    step on the --frames request (9: 4,680 tokens): "host" mode (its
    gradients kept), then "device" mode (k = ceil(sqrt(48)) = 7) with an
    AdamW update; sub_remat on. Step seconds, the loop's peak against the
    budget plus what lies outside it (the VAE; umT5 parked on the host),
    the GB the ring copied, the two modes' gradients against each other,
    and K1 / K3 / K3q / K4 / K5 launches against the derived counts.
    Returns the device-mode step's launches."""
    from video_styler_tpu_torch.trainers.lora_train import lora_parameters
    from video_styler_tpu_torch.trainers.streaming_train import StreamingTrainer
    from video_styler_tpu_torch.trainers.training import adamw
    streamer = pipe._streamers["dit"]
    lora = streaming_lora(torch, streamer.vace_cfg, "cuda", rank=STREAM_TRAIN_RANK, seed=7)
    params = lora_parameters(lora)
    opt = adamw(params, 1e-4)
    gen = torch.Generator("cuda").manual_seed(5)
    f_lat = (frames - 1) // 4 + 1
    lat = torch.randn((1, 16, f_lat, 60, 104), generator=gen, device="cuda")
    noise = torch.randn(lat.shape, generator=gen, device="cuda")
    sigma = 0.6
    noisy = ((1 - sigma) * lat + sigma * noise).to(torch.bfloat16)
    ctx = torch.randn((1, TEXT_LEN, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    vctx = torch.randn((1, 96, f_lat, 60, 104), generator=gen, device="cuda"
                       ).to(torch.bfloat16)
    args = (noisy, torch.tensor([600.0], device="cuda"), ctx, noise - lat)
    kw = dict(vace_context=vctx, vace_scale=1.0, vace_lora=lora)
    vae_bytes = sum(t.numel() * t.element_size() for t in pipe.vae.parameters())
    allocated_before = torch.cuda.memory_allocated()
    res = dict(phase="streaming_train", card=smi, frames=frames,
               tokens=int(math.prod(token_grid(frames))), store="int8",
               hbm_budget_gb=STREAM_BUDGET_GB, prefetch_depth=STREAM_DEPTH,
               resident_blocks=streamer.resident_blocks, lora_rank=STREAM_TRAIN_RANK,
               lora_linears=len(lora), lora_params=sum(p.numel() for p in params),
               sub_remat=True, memory_allocated_before_gb=allocated_before / 1e9,
               outside_budget_bytes=dict(vae=vae_bytes, lora_and_adamw=None),
               modes={})
    grads = {}
    launches = {}
    for ckpt in ("host", "device"):
        trainer = StreamingTrainer(streamer, activation_ckpt=ckpt)
        for kern in kernels.values():
            kern.launches = 0
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _, g = trainer.loss_and_grads(*args, **kw)
        if ckpt == "device":
            for name, ab in lora.items():
                for k in ("A", "B"):
                    ab[k].grad = g[name][k]
            opt.step()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches[ckpt] = {name: kern.launches for name, kern in kernels.items()}
        expected = expected_streaming_train_launches(
            streamer.cfg.num_layers, streamer.vace_cfg.vace_layers, ckpt,
            trainer.last_ckpt[1], cross_kv=True)
        grads[ckpt] = _flat(torch, g)
        res["modes"][ckpt] = dict(
            loss=float(loss), step_s=step_s, segment=trainer.last_ckpt[1],
            loop_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            streamed_gb=trainer.bytes_copied / 1e9, pin_s=trainer.pin_seconds,
            launches=launches[ckpt],
            expected_launches=expected)
    res["outside_budget_bytes"]["lora_and_adamw"] = 4 * sum(p.numel() for p in params) * 4
    res["grads_rel_l2_host_vs_device"] = ((grads["host"] - grads["device"]).norm()
                                          / grads["device"].norm()).item()
    res["grads_tol"] = 1e-2
    emit(res)
    failures = []
    for ckpt, mode in res["modes"].items():
        if not math.isfinite(mode["loss"]):
            failures.append(f"{ckpt}: non-finite loss")
        try:
            check_launches(mode["launches"], mode["expected_launches"],
                           f"streaming_train ({ckpt})")
        except AssertionError as e:
            failures.append(str(e))
        budget = STREAM_BUDGET_GB * 1e9 + vae_bytes + 8e9
        if mode["loop_peak_gib"] * 2**30 > budget:
            failures.append(f"{ckpt}: loop peak {mode['loop_peak_gib']:.2f} GiB over the "
                            f"budget + the VAE + the 8 GB stash budget")
    if not res["grads_rel_l2_host_vs_device"] <= 1e-2:
        failures.append("host and device gradients differ")
    if failures:
        raise AssertionError("streaming_train: " + "; ".join(failures))
    return launches["device"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--frames", type=int, default=RUN_FRAMES,
                    help="frames (4k+1) of the 480x832 end-to-end request")
    ap.add_argument("--train-frames", type=int, default=RUN_FRAMES,
                    help="frames (4k+1) of the 480x832 clip of the LoRA steps")
    ap.add_argument("--only", nargs="+",
                    choices=("qwen", "step1x", "hunyuan") + FAMILY_PHASES
                    + ("usp", "flux_lora", "streaming_train", "transformers", "train"),
                    default=None,
                    help="build the kernels and run only these phases (qwen: "
                         "qwen_kernels to qwen_adapters; step1x: step1x_nexus_kernels "
                         "to step1x_nexus, on the qwen phase's towers when it runs too; "
                         "hunyuan: hunyuan_kernels to hunyuan; step_video: "
                         "step_video_kernels to step_video; cog_video, hunyuan_image, svd, "
                         "omnigen: each family's reference and full-width phase; usp; "
                         "flux_lora: flux_lora_kernels, image_lora_reference and "
                         "flux_lora on a FLUX.1-dev of its own; streaming_train: "
                         "streaming_train_reference, streaming and streaming_train; "
                         "transformers: transformers_backends; train: the fp32 kernel "
                         "rows, then train and train_precision on a random 14B "
                         "pipeline at --train-frames, reporting an OOM), "
                         "then the kernels line of their rows: for iterating on them "
                         "(with no arguments every phase runs)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where the load phase writes its ~47 GB of checkpoint "
                         "files (in a new folder it removes; default: the "
                         "temporary directory)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "video_styler_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from video_styler_tpu_torch.extensions.fastblend import kernels as fk
    from video_styler_tpu_torch.ops import cuda_build
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    t0 = time.perf_counter()
    cuda_build.build_all()
    build_s = time.perf_counter() - t0
    PTXAS.update(ptxas_usage(cuda_build.BUILD_DIR))
    CARD["card"] = smi
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), build_s=build_s, ptxas=PTXAS))

    kernels = {"K1": fa.KERNEL, "K4": fnr.ROPE_KERNEL, "K5": fnr.RMS_KERNEL,
               "K3": fa.BWD_KERNEL, "K3q": fa.BWD_DQ_KERNEL,
               "K1f": fa.F32_KERNEL, "K3f": fa.BWD_F32_KERNEL, "K3q-f": fa.BWD_DQ_F32_KERNEL,
               "K4f": fnr.ROPE_F32_KERNEL, "K5f": fnr.RMS_F32_KERNEL,
               "K2": fa.ONLINE_KERNEL, "K8": fa.DUAL_KERNEL,
               "K6": fa.INT8_CAPPED_KERNEL, "K6o": fa.INT8_ONLINE_KERNEL,
               "K7": fa.INT8_3D_KERNEL, "F1": fk.REMAP_KERNEL,
               "F2": fk.PATCH_ERROR_KERNEL, "F3": fk.PAIRWISE_KERNEL}
    if args.only:
        rows, path_launches, vl = [], {}, None
        if "qwen" in args.only:
            rows += check_qwen_kernels(torch)
            qwen_launches, vl = run_qwen_phases(torch, kernels, args.steps)
            path_launches.update(qwen_launches)
        if "step1x" in args.only:
            rows += check_step1x_nexus_kernels(torch)
            path_launches.update(run_step1x_nexus(torch, kernels, args.steps, vl))
        del vl
        gc.collect()
        torch.cuda.empty_cache()
        if "hunyuan" in args.only:
            rows += check_hunyuan_kernels(torch)
            check_hunyuan_reference(torch, kernels)
            path_launches["hunyuan"] = run_hunyuan(torch, kernels, args.steps)
        if set(FAMILY_PHASES) & set(args.only):
            family_rows, family_paths = run_family_phases(torch, kernels, args.steps,
                                                          args.only)
            rows += family_rows
            path_launches.update(family_paths)
        if "usp" in args.only:
            path_launches["usp"] = run_usp(torch, args.frames, args.steps, smi)
        own_rows, f32_rows = [], []
        if "transformers" in args.only:
            check_transformers_backends(torch)
        if "flux_lora" in args.only:
            own_rows = check_flux_lora_kernels(torch)
            check_image_lora_reference(torch, kernels)
            path_launches["flux_lora"] = run_flux_lora_alone(torch, kernels, args.steps)
        if "streaming_train" in args.only:
            check_streaming_train_reference(torch, kernels)
            path_launches["streaming"], path_launches["streaming_train"] = run_streaming(
                torch, kernels, args.frames, args.steps, smi)
        if "train" in args.only:
            f32_rows = run_train_alone(torch, kernels, args.train_frames, args.steps)
        launches = {"K1": sum(c.get("K1", 0) for c in path_launches.values())}
        return finish(torch, smi, rows, launches, path_launches, [], {},
                      own_rows=flux_lora_rows(own_rows, path_launches.get("flux_lora"))
                      + f32_rows)
    ditto, run = token_grid(DITTO_FRAMES), token_grid(args.frames)
    rows = check_kernels(torch, ditto, f"ditto-{DITTO_FRAMES}f")
    if args.frames != DITTO_FRAMES:
        rows += check_kernels(torch, run, f"run-{args.frames}f")
    # the image-conditioned path's new shapes: K1 cross to the 257 CLIP rows
    # and to FLF2V's 769-row text branch at this run's and the I2V recipe's
    # 32,760 query rows; TI2V-5B's 24 heads (Dm 3072) over 5,070 tokens
    image_lens = (CLIP_ROWS, FLF2V_TEXT_ROWS)
    for frames in sorted({args.frames, I2V_RECIPE_FRAMES}):
        rows += check_kernels(torch, token_grid(frames), f"i2v-{frames}f",
                              cross_lens=image_lens, self_attn=False, norms=False)
    rows += check_kernels(torch, TI2V_GRID, f"ti2v-{TI2V_FRAMES}f", heads=24)
    # the Fun reference frame: one more leading latent frame (6,240 tokens
    # at 9 frames, RoPE rows over f + 1 frames), whose queries also reach
    # the text and the 257 CLIP keys (V1.1 Control keeps the image input);
    # the 1.3B speed-control
    # width: 12 heads of 128, Dm 1536
    rows += check_kernels(torch, (run[0] + 1,) + run[1:], f"fun-ref-{args.frames}f",
                          cross_lens=(TEXT_LEN, CLIP_ROWS))
    rows += check_kernels(torch, run, f"speed-{args.frames}f", heads=12)
    # Wan2.2-S2V at 448x832: self-attention over the latent frames and the
    # reference frame (RoPE rows from its segments) at the run's 12 frames
    # (5,824 tokens, with the text cross) and the recipe's 80 (30,576);
    # the audio cross, a batch row per latent frame against 5 keys
    for frames, cross in ((S2V_RUN_FRAMES, (TEXT_LEN,)), (S2V_RECIPE_FRAMES, ())):
        rows += check_kernels(torch, s2v_grid(frames), f"s2v-{frames}f", cross_lens=cross,
                              rope_tables=s2v_rope_tables(frames))
        rows += check_audio_cross_kernels(torch, (frames - 1) // 4 + 1, f"s2v-{frames}f")
    # FastBlend's F1-F3 at the post-processing path's top pyramid level
    rows += check_fastblend_kernels(torch)
    # one rank's share of the multi-GPU path at 14B width
    rows += check_usp_kernels(torch)
    torch.cuda.empty_cache()
    s_ditto = math.prod(ditto)
    s_run = math.prod(run)
    s_train = math.prod(token_grid(args.train_frames))
    train_rows = check_attention_training(torch, s_ditto, s_ditto,
                                          f"ditto-{DITTO_FRAMES}f", "self",
                                          check_heads=2)
    train_rows += check_attention_training(torch, s_ditto, TEXT_LEN,
                                           f"ditto-{DITTO_FRAMES}f", "cross")
    if args.train_frames != DITTO_FRAMES:
        for kind, sk in (("self", s_train), ("cross", TEXT_LEN)):
            train_rows += check_attention_training(torch, s_train, sk,
                                                   f"train-{args.train_frames}f", kind)
    # q x8: logits of std ~11 (RMS-normed q/k give ~1.4). The capped
    # softmax holds up to a largest logit of ~96 + 127 bits; q x24 over
    # 4,680^2 logits per head passes that (both the kernel and its plain
    # version overflow there, as the Pallas kernel would)
    train_rows += check_attention_training(torch, s_train, s_train,
                                           f"train-{args.train_frames}f",
                                           "self q x8 (magnitude stress)", mag=8.0)
    torch.cuda.empty_cache()
    # the float32 instantiations the Ditto recipe's fp32 activations run, at
    # the full clip's 29,640 tokens and the train clip's, self and cross
    f32_rows = f32_kernel_rows(torch, args.train_frames)

    # the online-softmax and int8 kernels, at the Ditto shapes and this run's
    new_rows = check_online_kernels(torch, s_ditto, f"ditto-{DITTO_FRAMES}f", cross=True)
    new_rows += check_int8_kernels(torch, s_ditto, f"ditto-{DITTO_FRAMES}f", cross=True,
                                   three_d=True)
    if args.frames != DITTO_FRAMES:
        new_rows += check_online_kernels(torch, s_run, f"run-{args.frames}f", cross=False)
        new_rows += check_int8_kernels(torch, s_run, f"run-{args.frames}f", cross=False,
                                       three_d=False)
    # the q x24 logits that the capped softmax cannot take (above): the
    # running max can; the int8 kernels are stressed at q x8 like K1
    new_rows += check_online_kernels(torch, s_run, f"run-{args.frames}f", cross=False,
                                     mag=24.0)
    new_rows += check_int8_kernels(torch, s_run, f"run-{args.frames}f", cross=False,
                                   three_d=False, mag=8.0)
    check_online_training(torch, s_train, f"train-{args.train_frames}f")
    torch.cuda.empty_cache()

    check_reference(torch)
    check_reference_quant(torch)
    check_train_reference(torch)
    check_editor_reference(torch)
    check_enhance_reference(torch)
    check_image_references(torch)
    check_fun_references(torch)
    check_s2v_reference(torch)
    check_postprocess_reference(torch)
    check_streaming_reference(torch)
    check_streaming_train_reference(torch, kernels)
    check_image_lora_reference(torch, kernels)
    check_transformers_backends(torch)
    pipe, init_s = build_pipeline(torch)
    e2e_frames = []
    run_edit(torch, pipe, kernels, args.steps, args.frames, "e2e", {"K1": 1.0},
             outputs=e2e_frames, init_s=init_s)
    # from here on every phase runs on the pipeline loaded from the files,
    # and the kernels line counts its launches
    holder = [pipe]
    del pipe
    pipe, launches = run_load(torch, holder, kernels, args.frames, args.steps, e2e_frames,
                              args.ckpt_dir)
    del e2e_frames
    launches.update(run_e2e_online(torch, pipe, kernels, args.frames))
    train_launches, train_inputs = run_train(torch, pipe, kernels, args.train_frames)
    if train_inputs is None:
        raise AssertionError(f"the fp32 LoRA steps at {args.train_frames} frames ran out of "
                             f"the card's memory (`--only train --train-frames N` tries "
                             f"another count)")
    run_train_precision(torch, pipe, kernels, train_inputs, args.train_frames)
    del train_inputs
    # the editor and the enhancer on the loaded pipeline; umT5 and the VAE,
    # parked on the host for the cache-fed LoRA steps, come back
    pipe.prompter.text_encoder.to("cuda")
    pipe.vae.to("cuda")
    path_launches = {}
    path_launches["editor"], editor_grid, editor_rope_ids = run_editor(
        torch, pipe, kernels, args.frames, args.steps)
    rows += check_kernels(torch, editor_grid, f"editor-{args.frames}f", editor_rope_ids)
    torch.cuda.empty_cache()
    path_launches["enhance"] = run_enhance(torch, pipe, kernels, args.frames)
    launches["K6"] = run_e2e_quant(torch, pipe, kernels, args.steps, args.frames)["K6"]
    # the int8 online body on the same quantised pipeline: FLASH_CAPPED=0
    os.environ["FLASH_CAPPED"] = "0"
    try:
        from video_styler_tpu_torch.ops.attention import set_quantized_attention
        set_quantized_attention(True)
        launches["K6o"] = run_edit(torch, pipe, kernels, 1, args.frames, "e2e_quant_online",
                                   {"K6o": 1.0}, profile=False,
                                   environment={"FLASH_CAPPED": "0"})["K6o"]
    finally:
        set_quantized_attention(False)
        del os.environ["FLASH_CAPPED"]
    launches["K7"] = run_entry_3d(torch, kernels, s_run)["K7"]
    # the image-conditioned models in the VACE pipeline's place: its DiT and
    # VACE go; umT5 and the Wan2.1 VAE stay
    pipe.dit = pipe.vace = None
    gc.collect()
    torch.cuda.empty_cache()
    path_launches.update(run_i2v(torch, pipe, kernels, args.frames, args.steps))
    path_launches["speed"] = run_speed(torch, pipe, kernels, args.frames, args.steps)
    path_launches["ti2v"] = run_ti2v(torch, pipe, kernels, args.steps)
    path_launches["s2v"] = run_s2v(torch, pipe, kernels, args.steps)
    # the post-processing chain on a free card: umT5 and the VAE go too
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(run_postprocess(torch, kernels))
    # block streaming at 14B width on a free card, then the workflow CLIs
    path_launches["streaming"], path_launches["streaming_train"] = run_streaming(
        torch, kernels, args.frames, args.steps, smi)
    run_workflow_smokes(torch, kernels)
    # FLUX.1-dev on the free card: K1 at its shapes (and its adapters'),
    # the small pipelines card vs CPU, then the full-width requests; then
    # SD3.5-Large on FLUX's text towers and VAE
    rows += check_flux_kernels(torch)
    emit(dict(phase="card", nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()))
    rows += check_flux_adapter_kernels(torch)
    lora_rows = check_flux_lora_kernels(torch)
    torch.cuda.empty_cache()
    check_flux_reference(torch)
    check_flux_adapters_reference(torch)
    check_sd3_reference(torch)
    (path_launches["flux"], path_launches["flux_adapters"], path_launches["flux_lora"],
     shared) = run_flux(torch, kernels, args.steps)
    gc.collect()
    torch.cuda.empty_cache()
    path_launches["sd3"], clip_g = run_sd3(torch, kernels, args.steps, shared)
    clip_l = shared[0]
    del shared
    gc.collect()
    torch.cuda.empty_cache()
    # SD 1.5, SDXL and Kolors, images and video, on FLUX's CLIP-L and SD3's
    # CLIP-G
    path_launches.update(run_sd_family(torch, kernels, args.steps, clip_l, clip_g))
    del clip_l, clip_g
    gc.collect()
    torch.cuda.empty_cache()
    # Qwen-Image on the free card: K1 at its joint lengths, the small
    # pipeline card vs CPU, then the 20B DiT and Qwen2.5-VL-7B at full width
    rows += check_qwen_kernels(torch)
    qwen_launches, vl = run_qwen_phases(torch, kernels, args.steps)
    path_launches.update(qwen_launches)
    # Step1x and Nexus-Gen on FLUX.1-dev beside the Qwen phase's towers, then
    # HunyuanVideo on the free card
    rows += check_step1x_nexus_kernels(torch)
    path_launches.update(run_step1x_nexus(torch, kernels, args.steps, vl))
    del vl
    gc.collect()
    torch.cuda.empty_cache()
    rows += check_hunyuan_kernels(torch)
    check_hunyuan_reference(torch, kernels)
    path_launches["hunyuan"] = run_hunyuan(torch, kernels, args.steps)
    # StepVideo (K1 at its shapes, the 30 B DiT after the Step-1 LLM), then
    # CogVideoX, HunyuanDiT, SVD and OmniGen, each on the free card
    family_rows, family_paths = run_family_phases(torch, kernels, args.steps)
    rows += family_rows
    path_launches.update(family_paths)
    # the multi-GPU path: ranks sharing the free card
    path_launches["usp"] = run_usp(torch, args.frames, args.steps, smi)
    # the bf16 training rows count the streamed 14B LoRA steps (bf16, as in
    # JAX), the fp32 rows the Ditto recipe's `train` steps
    return finish(torch, smi, rows + new_rows, launches, path_launches, train_rows,
                  path_launches["streaming_train"],
                  own_rows=flux_lora_rows(lora_rows, path_launches["flux_lora"])
                  + [dict(r, launches=train_launches[r["kernel"].replace("K1fs", "K1f")])
                     for r in f32_rows])


def f32_kernel_rows(torch, train_frames: int):
    """K1f, K3f, K3q-f (self at 29,640 tokens on 2 heads' rows, at the
    train clip's tokens on all, and the 512-key cross at both) and K4f,
    K5f at both token counts."""
    s_ditto = math.prod(token_grid(DITTO_FRAMES))
    s_train = math.prod(token_grid(train_frames))
    shapes = {s_train: (f"train-{train_frames}f", token_grid(train_frames)),
              s_ditto: (f"ditto-{DITTO_FRAMES}f", token_grid(DITTO_FRAMES))}
    rows = []
    for s, (tag, grid) in shapes.items():
        rows += check_f32_attention(torch, s, s, tag, "self",
                                    check_heads=2 if s > 10_000 else None)
        rows += check_f32_attention(torch, s, TEXT_LEN, tag, "cross")
        rows += check_f32_norms(torch, grid, tag)
        torch.cuda.empty_cache()
    return rows


def run_train_alone(torch, kernels, frames: int, steps: int):
    """`--only train`: the fp32 kernel rows, then the `train` and
    `train_precision` phases on a random 14B pipeline (no e2e edit, no
    load) at `frames`. Running out of the card's memory is reported as the
    finding: by `train` (the phase ends there) and by the plain run of
    `train_precision`. Returns the kernel rows with `train`'s launches."""
    rows = f32_kernel_rows(torch, frames)
    pipe, _ = build_pipeline(torch)
    launches, inputs = run_train(torch, pipe, kernels, frames, steps)
    if inputs is not None:
        run_train_precision(torch, pipe, kernels, inputs, frames, plain_oom_ok=True)
    return [dict(r, launches=launches[r["kernel"].replace("K1fs", "K1f")]) for r in rows]


def flux_lora_rows(rows, launches):
    """The FLUX LoRA shape's K1-with-stats and K3 rows with their launches
    in the `flux_lora` steps."""
    return [dict(r, launches=launches["K1" if r["kernel"] == "K1s" else r["kernel"]])
            for r in rows]


def finish(torch, smi, rows, launches, path_launches, train_rows, train_launches,
           own_rows=()):
    """The kernels line (each row with its launches on the main path; an
    own row carries the launches of its path's run), the nvidia-smi line
    and the last line; fails if a kernel of the rows was never launched."""
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    by_path = {name: {path: counts[name] for path, counts in path_launches.items()
                      if name in counts} for name in ("K1", "K4", "K5")}
    line = ([{**{k: r[k] for k in keys}, "launches": launches[r["kernel"]],
              **({"launches_by_path": by_path[r["kernel"]]} if r["kernel"] in by_path else {})}
             for r in rows]
            + [{**{k: r[k] for k in keys}, "launches": train_launches[
                "K1" if r["kernel"] == "K1s" else r["kernel"]]} for r in train_rows]
            + [{**{k: r[k] for k in keys}, "launches": r["launches"]} for r in own_rows])
    unlaunched = sorted({r["name"].split()[0] for r in line if r["launches"] == 0})
    if unlaunched:
        raise AssertionError(f"kernels never launched on their main-path runs: {unlaunched}")
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
