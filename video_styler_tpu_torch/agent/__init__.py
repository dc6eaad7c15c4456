from .graph import StateGraph, END, build_video_styling_app
from .schema import State, FrameInfo, StyleAnalysis, VideoMetadata
