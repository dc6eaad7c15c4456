"""Prompt refiners / extenders: the port's own copy of
`video_styler_tpu/prompters/prompt_extend.py`.

Port surface of the reference hooks (prompters/base_prompter.py:38-70) and
the enhancer's prompt expanders (denoising_enhancing/wan/utils/
prompt_extend.py): a prompt passes through optional refiner chains before
encoding. Network expanders (DashScope / Qwen-VL) are HTTP clients requiring
egress; the template expander works offline.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional


class TemplatePromptExpander:
    """Offline expander: appends quality/style boilerplate like the Wan
    system prompts do."""

    POSITIVE_SUFFIX = (", cinematic lighting, highly detailed, smooth motion, "
                       "best quality, 4k")

    def __call__(self, prompt: str, positive: bool = True) -> str:
        if not positive or not prompt:
            return prompt
        if any(tok in prompt.lower() for tok in ("quality", "detailed", "4k")):
            return prompt
        return prompt + self.POSITIVE_SUFFIX


class DashScopePromptExpander:
    """Qwen prompt expander over DashScope HTTP (needs DASHSCOPE_API_KEY +
    network egress)."""

    def __init__(self, model: str = "qwen-plus", max_retries: int = 3):
        self.model = model
        self.max_retries = max_retries

    def __call__(self, prompt: str, positive: bool = True) -> str:
        import json
        import urllib.request
        api_key = os.environ.get("DASHSCOPE_API_KEY")
        if not api_key:
            raise RuntimeError("DASHSCOPE_API_KEY not configured")
        payload = json.dumps({
            "model": self.model,
            "input": {"messages": [
                {"role": "system",
                 "content": "Expand the following video generation prompt "
                            "with rich visual detail. Reply with the prompt only."},
                {"role": "user", "content": prompt}]},
        }).encode()
        req = urllib.request.Request(
            "https://dashscope.aliyuncs.com/api/v1/services/aigc/text-generation/generation",
            data=payload,
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {api_key}"})
        from ..agent.image_generation import retry_with_backoff
        def call():
            with urllib.request.urlopen(req, timeout=60) as resp:
                data = json.loads(resp.read())
            return data["output"]["text"]
        return retry_with_backoff(call, max_retries=self.max_retries)


class PromptRefinerChain:
    """BasePrompter.process_prompt semantics: run refiners in order."""

    def __init__(self, refiners: Optional[List[Callable]] = None):
        self.refiners = refiners or []

    def add(self, refiner: Callable):
        self.refiners.append(refiner)
        return self

    def __call__(self, prompt: str, positive: bool = True) -> str:
        for r in self.refiners:
            prompt = r(prompt, positive=positive)
        return prompt


class BeautifulPrompt:
    """BeautifulPrompt refiner analog (reference
    prompters/prompt_refiners.py:6-54): instruction template + LLM
    generation appended to the raw prompt; negative prompts pass through.
    `generate` is an injectable callable(text) -> completion string (served
    via transformers or any host LLM)."""

    TEMPLATE = ("Instruction: Give a simple description of the image to "
                "generate a drawing prompt.\nInput: {raw_prompt}\nOutput:")
    TEMPLATE_V2 = (
        "Converts a simple image description into a prompt. Prompts are "
        "formatted as multiple related tags separated by commas, plus you "
        "can use () to increase the weight, [] to decrease the weight, or "
        "use a number to specify the weight. You should add appropriate "
        "words to make the images described in the prompt more "
        "aesthetically pleasing, but make sure there is a correlation "
        "between the input and output.\n### Input: {raw_prompt}\n"
        "### Output:")

    def __init__(self, generate: Callable[[str], str], v2: bool = False):
        self.generate = generate
        self.template = self.TEMPLATE_V2 if v2 else self.TEMPLATE

    def __call__(self, raw_prompt: str, positive: bool = True, **kw) -> str:
        if not positive:
            return raw_prompt
        out = self.generate(self.template.format(raw_prompt=raw_prompt))
        return raw_prompt + ", " + out.strip()


class QwenPrompt:
    """Chinese->English describer analog (prompt_refiners.py:57-104):
    chat-format LLM call with the reference system prompt; negative prompts
    pass through. `chat` is callable(messages) -> reply string."""

    SYSTEM_PROMPT = (
        "You are an English image describer. Your task is to translate a "
        "given Chinese image description into a concise and precise "
        "English description, with vivid imagery and stylistic elements; "
        "at most 200 words.")

    def __init__(self, chat: Callable[[list], str],
                 system_prompt: Optional[str] = None):
        self.chat = chat
        self.system_prompt = system_prompt or self.SYSTEM_PROMPT

    def __call__(self, raw_prompt: str, positive: bool = True, **kw) -> str:
        if not positive:
            return raw_prompt
        return self.chat([
            {"role": "system", "content": self.system_prompt},
            {"role": "user", "content": raw_prompt},
        ]).strip()


class Translator:
    """Seq2seq translation refiner analog (prompt_refiners.py:107-130):
    applies to BOTH positive and negative prompts. `translate` is
    callable(text) -> translated text (e.g. an opus-mt pipe)."""

    def __init__(self, translate: Callable[[str], str]):
        self.translate = translate

    def __call__(self, prompt: str, positive: bool = True, **kw) -> str:
        return self.translate(prompt)
