"""The Ditto workflow's host-only half in the port (`agent/`,
`prompters/prompt_extend.py`, the refiner hooks of `WanPrompter`,
`step1_generate_keyframes`, `video_editing_with_agent`) against the JAX
package's modules: the same State JSON and keyframes from the graph, the
same requests to each image provider's stub server and the same images
back, the same prompt strings. The providers are reached only through the
local stub server of `test_agent_providers.py`; nothing leaves the host.
"""
import json
import os
import sys
import urllib.request

import numpy as np
import pytest
from PIL import Image

import video_styler_tpu.agent as JA
from video_styler_tpu.agent import image_generation as JIG
from video_styler_tpu.agent import providers as JP
from video_styler_tpu.agent.config import ConfigManager as JConfig
from video_styler_tpu.prompters import prompt_extend as JPE
from video_styler_tpu.prompters.wan_prompter import WanPrompter as JPrompter

import video_styler_tpu_torch.agent as TA
from video_styler_tpu_torch.agent import image_generation as TIG
from video_styler_tpu_torch.agent import providers as TP
from video_styler_tpu_torch.agent.config import ConfigManager, expand_env
from video_styler_tpu_torch.prompters import prompt_extend as TPE
from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer, WanPrompter

from test_agent_providers import RESULT_B64, _Server
from test_torch_pipeline import cpu_share  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_video(path, n_frames=30, fps=10):
    import cv2
    rng = np.random.default_rng(0)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (64, 48))
    for i in range(n_frames):
        frame = np.full((48, 64, 3), (i * 8) % 255, np.uint8)
        frame[10:20, 10:30] = rng.integers(0, 255, 3, np.uint8)
        vw.write(frame)
    vw.release()


def _normalised(state, root) -> dict:
    return json.loads(json.dumps(state, default=str).replace(str(root), "<out>"))


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _llm(prompt):
    return json.dumps({"dominant_style_prefix": "ukiyo-e woodblock",
                       "specific_style_prefix": "flat colours, bold outlines",
                       "negative_prompt": "photo"})


@pytest.mark.parametrize("llm", [None, _llm, lambda p: "not json"],
                         ids=["template", "llm", "llm-bad-json"])
def test_agent_graph_matches_jax(tmp_path, llm):
    """The whole graph (frames at ~1 fps, the analysis, one mock edit per
    keyframe, the combine, the router's checkpoints): the same State JSON,
    the same source and styled keyframes, the same state_last.json."""
    video = tmp_path / "in.mp4"
    _make_video(video)
    states = {}
    for name, pkg in (("jax", JA), ("port", TA)):
        out = tmp_path / name
        app = pkg.build_video_styling_app(llm_fn=llm, image_provider="mock")
        states[name] = (out, app.invoke({"video_url": str(video), "output_dir": str(out),
                                         "style_instruction": "van gogh style",
                                         "max_frames": 3}))
    (jout, jstate), (tout, tstate) = states["jax"], states["port"]
    assert _normalised(tstate, tout) == _normalised(jstate, jout)
    assert tstate["current_node"] == "end" and len(tstate["frames"]) == 3
    for jf, tf in zip(jstate["frames"], tstate["frames"]):
        for key in ("image_path", "stylized_image_path"):
            assert np.array_equal(_pixels(tf[key]), _pixels(jf[key]))
    with open(tout / "state_last.json") as f, open(jout / "state_last.json") as g:
        assert _normalised(json.load(f), tout) == _normalised(json.load(g), jout)
    assert os.path.getsize(tstate["output_video_path"]) > 0


def test_agent_resumes_from_checkpoint(tmp_path):
    video = tmp_path / "in.mp4"
    _make_video(video)
    app = TA.build_video_styling_app(image_provider="mock")
    app.invoke({"video_url": str(video), "output_dir": str(tmp_path / "o"),
                "style_instruction": "sketch", "max_frames": 2})
    again = app.invoke({"video_url": "/nonexistent.mp4", "output_dir": str(tmp_path / "o")})
    assert again["current_node"] == "end" and len(again["frames"]) == 2


def test_step1_cli_matches_jax(tmp_path, monkeypatch):
    """The port's step 1 and inference/step1_generate_keyframes.py on one
    clip: the same keyframe_info.json (paths aside) and keyframes."""
    video = tmp_path / "in.mp4"
    _make_video(video)
    from video_styler_tpu_torch import step1_generate_keyframes as step1
    info = step1.main(["--video", str(video), "--style", "sketch", "--max_frames", "3",
                       "--output_dir", str(tmp_path / "port")])
    sys.path.insert(0, os.path.join(REPO, "inference"))
    try:
        import step1_generate_keyframes as jstep1
        monkeypatch.setattr(sys, "argv", ["step1", "--video", str(video), "--style", "sketch",
                                          "--max_frames", "3", "--output_dir",
                                          str(tmp_path / "jax")])
        jstep1.main()
    finally:
        sys.path.remove(os.path.join(REPO, "inference"))
    with open(tmp_path / "jax" / "keyframe_info.json") as f:
        jinfo = json.load(f)
    with open(tmp_path / "port" / "keyframe_info.json") as f:
        assert json.load(f) == info
    assert _normalised(info, tmp_path / "port") == _normalised(jinfo, tmp_path / "jax")
    for t, j in zip(info["generated_frames"], jinfo["generated_frames"]):
        assert np.array_equal(_pixels(t), _pixels(j))


def test_step1_and_integrated_cli_smoke(tmp_path):
    """`step1_generate_keyframes --smoke` (a synthetic clip, the mock
    provider) and `video_editing_with_agent --smoke --device cpu` (step 1,
    then the editor on tiny random models)."""
    from video_styler_tpu_torch import step1_generate_keyframes as step1
    from video_styler_tpu_torch import video_editing_with_agent
    info = step1.main(["--smoke", "--style", "sketch", "--max_frames", "2",
                       "--output_dir", str(tmp_path / "s1")])
    assert len(info["generated_frames"]) == 2 and info["source_fps"] == pytest.approx(10.0)
    frames = video_editing_with_agent.main(["--smoke", "--style", "sketch", "--device", "cpu",
                                            "--max_frames", "3",
                                            "--output_dir", str(tmp_path / "agent"),
                                            "--output_path", str(tmp_path / "out.mp4")])
    assert frames.shape == (5, 32, 32, 3) and frames.dtype == np.uint8
    assert os.path.getsize(tmp_path / "out.mp4") > 0
    with pytest.raises(SystemExit):
        step1.main(["--style", "x"])


# --------------------------------------------------------------------------
# Image providers, retry, config
# --------------------------------------------------------------------------

def _provider_run(pkg, name, monkeypatch, img):
    """One call of provider `name` against a fresh stub server: (the
    requests it received, the image it returned)."""
    responses = {
        "gemini": {"candidates": [{"finishReason": "STOP", "content": {"parts": [
            {"inlineData": {"mimeType": "image/png", "data": RESULT_B64}}]}}]},
        "qwen": {"output": {"choices": [{"message": {"content": [
            {"image": f"data:image/png;base64,{RESULT_B64}"}]}}]}},
        "openai": {"data": [{"b64_json": RESULT_B64}]}}
    srv = _Server(responses.get(name) or (lambda path: {"data": [{"url": f"{srv.endpoint}/r.png"}]}))
    env = {"gemini": ("GEMINI_API_KEY", "GEMINI_API_ENDPOINT"),
           "qwen": ("DASHSCOPE_API_KEY", "DASHSCOPE_API_ENDPOINT"),
           "doubao": ("ARK_IMAGE_API_KEY", "ARK_API_ENDPOINT"),
           "openai": ("AZURE_API_KEY", "AZURE_ENDPOINT")}[name]
    monkeypatch.setenv(env[0], "key")
    monkeypatch.setenv(env[1], srv.endpoint)
    try:
        out = pkg.image_generation_tool(img, "make it van gogh", provider=name,
                                        target_ratio=16 / 9)
    finally:
        srv.stop()
    return srv.requests, out


@pytest.mark.parametrize("name", ["gemini", "qwen", "doubao", "openai"])
def test_providers_match_jax(name, monkeypatch):
    """Each provider's wire request (path, body; a multipart body up to its
    random boundary) and decoded image, as the JAX package's."""
    img = Image.new("RGB", (16, 9), (10, 20, 30))
    treqs, tout = _provider_run(TIG, name, monkeypatch, img)
    jreqs, jout = _provider_run(JIG, name, monkeypatch, img)
    assert [r["path"] for r in treqs] == [r["path"] for r in jreqs]
    for t, j in zip(treqs, jreqs):
        tb, jb = t["body"], j["body"]
        ctype = t["headers"].get("Content-Type", "")
        if ctype.startswith("multipart/"):
            tb = tb.replace(ctype.split("boundary=")[1].encode(), b"B")
            jb = jb.replace(j["headers"]["Content-Type"].split("boundary=")[1].encode(), b"B")
        assert tb == jb
    assert np.array_equal(np.asarray(tout), np.asarray(jout))


def test_retry_classification_mock_and_data_urls_match_jax():
    import urllib.error
    errors = [RuntimeError("HTTP 500 from x: oops"), RuntimeError("status=429 rate limit"),
              RuntimeError("HTTP 401 from x: denied"), ValueError("nope"),
              TP.NonRetryableError("bad key"), urllib.error.URLError("timed out")]
    assert ([TP.is_retryable_error(e) for e in errors]
            == [JP.is_retryable_error(e) for e in errors] == [True, True, False, False, False,
                                                                True])
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("HTTP 503 service unavailable")
    with pytest.raises(RuntimeError):
        TIG.retry_with_backoff(boom, max_retries=2, base_delay=0.01)
    assert len(calls) == 2
    img = Image.fromarray(np.random.default_rng(0).integers(0, 255, (16, 16, 3), np.uint8))
    for prompt in ("style A", "style B", "style C"):
        assert np.array_equal(np.asarray(TIG.image_generation_tool(img, prompt)),
                              np.asarray(JIG.image_generation_tool(img, prompt)))
    url = TIG.pil_to_data_url(img)
    assert url == JIG.pil_to_data_url(img)
    assert np.array_equal(np.asarray(TIG.data_url_to_pil(url)), np.asarray(img))
    with pytest.raises(ValueError):
        TIG.image_generation_tool(img, "x", provider="nope")


def test_config_matches_jax(monkeypatch):
    monkeypatch.setenv("MY_KEY", "secret123")
    data = {"agents": {"styler": {"model": {"model": "gemini-2.5-flash",
                                            "api_key": "${MY_KEY}"}, "prompt": "be stylish"}},
            "mcp_servers": [{"name": "s", "url": "${MY_KEY}/x"}]}
    t, j = ConfigManager(data=data), JConfig(data=data)
    ta, ja = t.get_agent_config("styler"), j.get_agent_config("styler")
    assert (ta.name, ta.prompt, vars(ta.model)) == (ja.name, ja.prompt, vars(ja.model))
    assert t.get_agent_config("styler").model.api_key == "secret123"
    assert [vars(s) for s in t.get_mcp_servers()] == [vars(s) for s in j.get_mcp_servers()]
    assert expand_env("${MISSING}") == ""


# --------------------------------------------------------------------------
# Prompt refiners
# --------------------------------------------------------------------------

def test_prompt_expanders_match_jax():
    prompts = ["a cat on a roof", "a detailed cat", ""]

    def generate(text):
        return f"[{len(text)}] vivid"

    def chat(messages):
        return " " + messages[-1]["content"].upper() + " "

    def translate(text):
        return text[::-1]

    pairs = [(TPE.TemplatePromptExpander(), JPE.TemplatePromptExpander()),
             (TPE.BeautifulPrompt(generate), JPE.BeautifulPrompt(generate)),
             (TPE.BeautifulPrompt(generate, v2=True), JPE.BeautifulPrompt(generate, v2=True)),
             (TPE.QwenPrompt(chat), JPE.QwenPrompt(chat)),
             (TPE.Translator(translate), JPE.Translator(translate)),
             (TPE.PromptRefinerChain([TPE.Translator(translate)]).add(
                 TPE.TemplatePromptExpander()),
              JPE.PromptRefinerChain([JPE.Translator(translate)]).add(
                  JPE.TemplatePromptExpander()))]
    for t, j in pairs:
        for p in prompts:
            for positive in (True, False):
                assert t(p, positive=positive) == j(p, positive=positive)


def test_dashscope_expander_matches_jax(monkeypatch):
    """Behind a stub of urlopen: the same request and the same reply."""
    seen = []

    class Reply:
        def __init__(self, req):
            seen.append((req.full_url, req.data, dict(req.headers)))

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return json.dumps({"output": {"text": "an expanded prompt"}}).encode()

    monkeypatch.setattr(urllib.request, "urlopen", lambda req, timeout=None: Reply(req))
    monkeypatch.setenv("DASHSCOPE_API_KEY", "dk")
    got = TPE.DashScopePromptExpander()("a cat")
    want = JPE.DashScopePromptExpander()("a cat")
    assert got == want == "an expanded prompt"
    assert seen[0] == seen[1]
    monkeypatch.delenv("DASHSCOPE_API_KEY")
    with pytest.raises(RuntimeError):
        TPE.DashScopePromptExpander()("a cat")


def test_wan_prompter_refiner_hooks_match_jax():
    """process_prompt runs the chain, as the JAX prompter's; encode_prompt
    encodes the refined prompt."""
    import torch
    from video_styler_tpu_torch.models.t5 import T5Config, T5Encoder, init_t5_
    tp, jp = WanPrompter(StubTokenizer(16), 16), JPrompter(text_len=16)
    for p in (tp, jp):
        assert p.process_prompt("a cat") == "a cat"
    tp.refiners.add(TPE.TemplatePromptExpander())
    jp.refiners.add(JPE.TemplatePromptExpander())
    assert tp.process_prompt("a cat") == jp.process_prompt("a cat")
    assert tp.process_prompt("a cat", positive=False) == "a cat"
    with torch.device("meta"):
        t5 = T5Encoder(T5Config(vocab=128, dim=64, dim_attn=64, dim_ffn=128, num_heads=4,
                                num_layers=2, num_buckets=8))
    tp.text_encoder = init_t5_(t5.to_empty(device="cpu"), torch.Generator().manual_seed(0))
    plain = WanPrompter(StubTokenizer(16), 16, tp.text_encoder)
    assert torch.equal(tp.encode_prompt("a cat"),
                       plain.encode_prompt(tp.process_prompt("a cat")))
    assert not torch.equal(tp.encode_prompt("a cat"), plain.encode_prompt("a cat"))
