from .wan_prompter import StubTokenizer, WanPrompter  # noqa: F401
