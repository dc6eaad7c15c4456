"""Agent workflow: keyframe stylization as a checkpointed state graph.

Counterpart of `video_styler_tpu/agent/graph.py` (its own copy; the
reference's src/agent/graph.py), without the LangGraph
dependency: a minimal StateGraph engine with the same API (add_node,
add_edge, add_conditional_edges, set_entry_point, compile) drives the same
topology — every worker node returns to a central `router`, which saves a
JSON checkpoint (`state_last.json`) and dispatches on `state['current_node']`;
init_context resumes from the latest checkpoint when present.

Nodes:
  init_context  — cv2 frame extraction @1fps (max 10 frames), metadata
  edit_analysis — LLM structured StyleAnalysis (pluggable; template fallback)
  video_style   — per-keyframe prompt + image_generation_tool, one frame/turn
  combine_video — write the stylized keyframes to an mp4
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable, Dict, Optional

from .logger import log_info, log_error, log_save, log_node
from .schema import State, StyleAnalysis

END = "__end__"


class StateGraph:
    """Minimal LangGraph-compatible state graph."""

    def __init__(self, state_type=None):
        self.nodes: Dict[str, Callable] = {}
        self.edges: Dict[str, str] = {}
        self.conditional: Dict[str, tuple] = {}
        self.entry: Optional[str] = None

    def add_node(self, name: str, fn: Callable):
        self.nodes[name] = fn

    def add_edge(self, src: str, dst: str):
        self.edges[src] = dst

    def add_conditional_edges(self, src: str, logic: Callable,
                              mapping: Dict[str, str]):
        self.conditional[src] = (logic, mapping)

    def set_entry_point(self, name: str):
        self.entry = name

    def compile(self):
        return CompiledGraph(self)


class CompiledGraph:
    def __init__(self, graph: StateGraph, max_steps: int = 1000):
        self.graph = graph
        self.max_steps = max_steps

    def invoke(self, state: State) -> State:
        node = self.graph.entry
        for _ in range(self.max_steps):
            if node == END:
                return state
            log_node(f"-> {node}")
            state = self.graph.nodes[node](state)
            if node in self.graph.conditional:
                logic, mapping = self.graph.conditional[node]
                node = mapping[logic(state)]
            elif node in self.graph.edges:
                node = self.graph.edges[node]
            else:
                return state
        raise RuntimeError("graph exceeded max_steps")


# ---------------------------------------------------------------- workflow

def _video_info(video_path) -> dict:
    import cv2
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        cap.release()
        raise IOError(f"Unable to open video: {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    width = int(cap.get(3) or 0)
    height = int(cap.get(4) or 0)
    cap.release()
    return {"fps": fps, "frame_count": frame_count, "width": width,
            "height": height, "duration": frame_count / fps if fps else 0}


def _save_state_json(state: State, step_name: str):
    output_dir = state.get("output_dir")
    if not output_dir:
        return None
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"state_{step_name}.json"
    with open(path, "w") as f:
        json.dump(state, f, default=str, indent=2)
    log_save(f"Saved state to {path}")
    return path


def _find_latest_checkpoint(output_dir) -> Optional[State]:
    try:
        path = Path(output_dir) / "state_last.json"
        if not path.exists():
            return None
        with open(path) as f:
            state = json.load(f)
        log_info(f"Loaded checkpoint from {path}")
        return state
    except Exception as e:  # noqa: BLE001
        log_error(f"Failed to load checkpoint: {e}")
        return None


def build_video_styling_app(llm_fn: Optional[Callable] = None,
                            image_provider: str = "mock"):
    """Build the compiled workflow. llm_fn(prompt) -> str is the pluggable
    analysis model (Gemini in the reference); a template fallback keeps the
    graph runnable offline."""
    from .image_generation import image_generation_tool

    def init_context(state: State) -> State:
        ckpt = _find_latest_checkpoint(state["output_dir"])
        if ckpt:
            return ckpt
        import cv2
        out = Path(state["output_dir"])
        frames_dir = out / "frames" / "source"
        frames_dir.mkdir(parents=True, exist_ok=True)
        info = _video_info(state["video_url"])
        max_frames = state.get("max_frames", 10)
        step = max(int(info["fps"]), 1)                 # ~1 fps sampling
        cap = cv2.VideoCapture(str(state["video_url"]))
        frames = []
        idx = 0
        while len(frames) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % step == 0:
                path = str(frames_dir / f"frame_{idx:05d}.png")
                cv2.imwrite(path, frame)
                frames.append({"frame_index": idx,
                               "timestamp": idx / info["fps"],
                               "image_path": path,
                               "stylized_image_path": None,
                               "styling_prompt": None})
            idx += 1
        cap.release()
        state.update(video_metadata=info, frames=frames,
                     current_frame_index=0, processed_frames=[],
                     current_node="edit_analysis")
        return state

    def edit_analysis(state: State) -> State:
        instruction = state.get("style_instruction", "stylize the video")
        if llm_fn is not None:
            raw = llm_fn(
                "Analyze this video-editing instruction and output JSON with "
                "dominant_style_prefix, specific_style_prefix, negative_prompt: "
                + instruction)
            try:
                analysis: StyleAnalysis = json.loads(raw)
            except (json.JSONDecodeError, TypeError):
                analysis = {"dominant_style_prefix": instruction,
                            "specific_style_prefix": "",
                            "negative_prompt": ""}
        else:
            analysis = {"dominant_style_prefix": instruction,
                        "specific_style_prefix": "high quality, consistent style",
                        "negative_prompt": "blurry, distorted"}
        state.update(edit_analysis=analysis,
                     consistent_edit_prompt=(
                         f"{analysis['dominant_style_prefix']}, "
                         f"{analysis['specific_style_prefix']}"),
                     current_node="video_style")
        return state

    def video_style(state: State) -> State:
        from PIL import Image
        i = state["current_frame_index"]
        frames = state["frames"]
        if i >= len(frames):
            state["current_node"] = "combine_video"
            return state
        frame = frames[i]
        prompt = state["consistent_edit_prompt"]
        if i > 0 and frames[i - 1].get("styling_prompt"):
            prompt = f"{prompt} (consistent with previous frame)"
        img = Image.open(frame["image_path"]).convert("RGB")
        styled = image_generation_tool(img, prompt, provider=image_provider)
        out = Path(state["output_dir"]) / "frames" / "styled"
        out.mkdir(parents=True, exist_ok=True)
        styled_path = str(out / f"frame_{frame['frame_index']:05d}.png")
        styled.save(styled_path)
        frame["stylized_image_path"] = styled_path
        frame["styling_prompt"] = prompt
        state["processed_frames"].append(i)
        state["current_frame_index"] = i + 1
        state["current_node"] = ("video_style" if i + 1 < len(frames)
                                 else "combine_video")
        return state

    def combine_video(state: State) -> State:
        from PIL import Image
        from ..data.video import save_video
        frames = [Image.open(f["stylized_image_path"])
                  for f in state["frames"] if f.get("stylized_image_path")]
        out_path = str(Path(state["output_dir"]) / "styled_keyframes.mp4")
        save_video(frames, out_path, fps=max(1, len(frames) // 2))
        state.update(output_video_path=out_path, current_node="end")
        return state

    def router(state: State) -> State:
        _save_state_json(state, "last")
        return state

    def router_logic(state: State) -> str:
        nxt = state.get("current_node", "end")
        log_info(f"Router to {nxt}")
        return nxt if nxt in ("init_context", "edit_analysis", "video_style",
                              "combine_video") else "end"

    graph = StateGraph(State)
    graph.add_node("init_context", init_context)
    graph.add_node("edit_analysis", edit_analysis)
    graph.add_node("router", router)
    graph.add_node("video_style", video_style)
    graph.add_node("combine_video", combine_video)
    graph.set_entry_point("init_context")
    graph.add_edge("init_context", "router")
    graph.add_edge("edit_analysis", "router")
    graph.add_edge("video_style", "router")
    graph.add_edge("combine_video", "router")
    graph.add_conditional_edges("router", router_logic, {
        "init_context": "init_context",
        "edit_analysis": "edit_analysis",
        "video_style": "video_style",
        "combine_video": "combine_video",
        "end": END,
    })
    return graph.compile()
