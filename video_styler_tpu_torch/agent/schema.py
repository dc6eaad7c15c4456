"""Agent state schema: the port's own copy of `video_styler_tpu/agent/schema.py`
(the reference's src/agent/schema.py)."""
from __future__ import annotations

from typing import List, Optional, TypedDict


class VideoMetadata(TypedDict):
    fps: float
    duration: float
    width: int
    height: int
    frame_count: int


class FrameInfo(TypedDict):
    frame_index: int
    timestamp: float
    image_path: str
    stylized_image_path: Optional[str]
    styling_prompt: Optional[str]


class StyleAnalysis(TypedDict):
    dominant_style_prefix: str
    specific_style_prefix: str
    negative_prompt: str


class State(TypedDict, total=False):
    video_url: str
    output_dir: str
    style_instruction: str
    video_metadata: VideoMetadata
    frames: List[FrameInfo]
    edit_analysis: StyleAnalysis
    consistent_edit_prompt: str
    current_frame_index: int
    processed_frames: List[int]
    max_frames: int
    current_node: str
    output_video_path: str
