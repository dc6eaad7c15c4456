"""The Diffutoon runner: a JSON config drives `SDVideoPipeline`.

Counterpart of `video_styler_tpu/pipelines/pipeline_runner.py`: the config
names the models (`model_list` of files: a civitai SD 1.5 checkpoint, a
motion-module file, LoRAs merged into the UNet at `lora_alphas`;
`controlnet_units` of {processor_id, model_path, scale}; a tokenizer
folder), the data (the input frames from a video file or an image
folder, optional ControlNet frames per unit, the output folder and fps),
an optional smoother chain (`processors.SequencialProcessor`) and the
pipeline's inputs; `run` loads, renders, and writes the frames, the video
and the config without its frame lists.

Where the JAX runner fails, this one departs from it: the civitai state
dicts are built into modules (JAX stores the flat renamed dicts as its
params, which its UNet cannot read), the motion file's modules are the
pipeline's (JAX keeps the converter's whole tree, one level too high), a
LoRA merges into the UNet's blocks (JAX's LoRA walk cannot enter the SD
UNet's blocks), and the per-unit ControlNet frames are annotated per unit
(JAX hands each unit's list to the annotator as one image).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np


class SDVideoPipelineRunner:

    def __init__(self, in_streamlit: bool = False, device=None):
        self.in_streamlit = in_streamlit
        self.device = device

    # ---------------- loading ----------------

    def load_pipeline(self, model_list, textual_inversion_folder=None, device=None,
                      lora_alphas=None, controlnet_units=None, tokenizer_path=None):
        import torch
        from ..controlnets import Annotator, ControlNetUnit, MultiControlNetManager
        from ..lora import merge_lora
        from ..models.controlnet import ControlNet, convert_controlnet, detect_controlnet_config
        from ..models.motion import convert_motion_model, detect_motion_model
        from ..utils import ckpt as C
        from ..utils.sd_civitai import convert_sd_civitai
        from .sd_video import SDVideoPipeline

        device = device if device is not None else self.device
        pipe = SDVideoPipeline(device=device)
        dev, dtype = pipe.device, pipe.dtype
        loras, lora_alphas = [], list(lora_alphas or [])
        for path in model_list:
            sd = C.load_state_dict(path, lazy=True)
            if any(".lora_" in k or "lora_up" in k for k in sd):
                loras.append(C.read_tensors(sd, torch.device("cpu")))
            elif any("motion_modules." in k or "temporal_transformer" in k for k in sd):
                msd = convert_motion_model(sd)
                motion = detect_motion_model(msd, device="meta", dtype=dtype)
                motion.load_state_dict(C.read_tensors(msd, dev, dtype), strict=True, assign=True)
                pipe.motion_modules = motion.eval()
            else:
                parts = convert_sd_civitai(sd)
                built = SDVideoPipeline.from_state_dicts(
                    unet_sd=parts["unet"] or None, text_encoder_sd=parts["text_encoder"] or None,
                    vae_encoder_sd=parts["vae_encoder"] or None,
                    vae_decoder_sd=parts["vae_decoder"] or None, device=dev, dtype=dtype)
                for name in ("unet", "text_encoder", "vae_encoder", "vae_decoder"):
                    if getattr(built, name) is not None:
                        setattr(pipe, name, getattr(built, name))
        for i, sd in enumerate(loras):
            merge_lora(pipe.unet, sd, alpha=lora_alphas[i] if i < len(lora_alphas) else 1.0)
        if controlnet_units:
            units = []
            for u in controlnet_units:
                sd = convert_controlnet(C.load_state_dict(u["model_path"], lazy=True))
                model = C.build_module(ControlNet, detect_controlnet_config(sd), sd, dev, dtype)
                units.append(ControlNetUnit(Annotator(u["processor_id"]), model,
                                            scale=u.get("scale", 1.0)))
            pipe.controlnet_manager = MultiControlNetManager(units)
        if tokenizer_path:
            from transformers import CLIPTokenizer
            pipe.tokenizer = CLIPTokenizer.from_pretrained(tokenizer_path)
        return pipe

    def load_smoother(self, smoother_configs):
        from ..processors import SequencialProcessor
        return SequencialProcessor.from_config(smoother_configs)

    # ---------------- data ----------------

    def load_video(self, video_file=None, image_folder=None, height=None, width=None,
                   start_frame_id=None, end_frame_id=None) -> List[np.ndarray]:
        """uint8 (H, W, 3) frames of a video file or of an image folder (its
        files in name order), cropped and resized to (height, width)."""
        from ..data.video import VideoData, crop_and_resize, read_image
        src = video_file or image_folder
        if os.path.isdir(src):
            frames = [read_image(os.path.join(src, f)) for f in sorted(os.listdir(src))]
            if height is not None and width is not None:
                frames = [crop_and_resize(f, height, width) for f in frames]
        else:
            video = VideoData(src, height=height, width=width)
            frames = [video[i] for i in range(len(video))]
            video.close()
        start = start_frame_id or 0
        end = end_frame_id if end_frame_id is not None else len(frames)
        return frames[start:end]

    def add_data_to_pipeline_inputs(self, data: Dict, pipeline_inputs: Dict) -> Dict:
        frames = self.load_video(**data["input_frames"])
        pipeline_inputs["input_frames"] = frames
        pipeline_inputs["num_frames"] = len(frames)
        pipeline_inputs["height"], pipeline_inputs["width"] = frames[0].shape[:2]
        if data.get("controlnet_frames"):
            pipeline_inputs["controlnet_frames"] = [self.load_video(**unit)
                                                    for unit in data["controlnet_frames"]]
        return pipeline_inputs

    def save_output(self, video, output_folder: str, fps: int, config: Dict):
        from PIL import Image
        from ..data.video import save_video
        os.makedirs(os.path.join(output_folder, "frames"), exist_ok=True)
        for i, frame in enumerate(video):
            Image.fromarray(np.asarray(frame)).save(os.path.join(output_folder, "frames",
                                                                 f"{i}.png"))
        save_video(video, os.path.join(output_folder, "video.mp4"), fps=fps)
        config = dict(config)
        config["pipeline"] = dict(config["pipeline"])
        config["pipeline"]["pipeline_inputs"] = {
            k: v for k, v in config["pipeline"]["pipeline_inputs"].items()
            if k not in ("input_frames", "controlnet_frames")}
        with open(os.path.join(output_folder, "config.json"), "w") as f:
            json.dump(config, f, indent=4)

    # ---------------- run ----------------

    def run(self, config, pipe=None):
        """config: a dict or a JSON file's path; `pipe` (a built pipeline)
        stands in for loading the models."""
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        inputs = self.add_data_to_pipeline_inputs(config["data"],
                                                  dict(config["pipeline"]["pipeline_inputs"]))
        config["pipeline"]["pipeline_inputs"] = inputs
        if pipe is None:
            pipe = self.load_pipeline(**config["models"])
        smoother = (self.load_smoother(config["smoother_configs"])
                    if "smoother_configs" in config else None)
        frames = pipe(seed=config["pipeline"].get("seed", 0), smoother=smoother, **inputs)
        self.save_output(frames, config["data"]["output_folder"], config["data"].get("fps", 25),
                         config)
        return frames
