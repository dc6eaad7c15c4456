"""Agent config: YAML + ${ENV} expansion -> dataclasses.

Counterpart of `video_styler_tpu/agent/config.py` (the reference's
src/config/manager.py and src/config/model.py), its own copy.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ModelConfig:
    model: str = "gemini-2.5-flash"
    model_provider: str = "mock"
    api_key: Optional[str] = None
    base_url: Optional[str] = None
    temperature: float = 0.7


@dataclass
class AgentConfig:
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    prompt: str = ""


@dataclass
class MCPServerConfig:
    name: str = ""
    url: str = ""
    transport: str = "sse"


_ENV_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}")


def expand_env(value):
    """Recursively expand ${VAR} from the environment."""
    if isinstance(value, str):
        return _ENV_RE.sub(lambda m: os.environ.get(m.group(1), ""), value)
    if isinstance(value, dict):
        return {k: expand_env(v) for k, v in value.items()}
    if isinstance(value, list):
        return [expand_env(v) for v in value]
    return value


class ConfigManager:
    def __init__(self, config_path: Optional[str] = None,
                 data: Optional[dict] = None):
        if data is None:
            import yaml
            with open(config_path) as f:
                data = yaml.safe_load(f) or {}
        self.data = expand_env(data)

    def get_agent_config(self, agent_name: str) -> AgentConfig:
        agents: Dict = self.data.get("agents", {})
        cfg = agents.get(agent_name, {})
        model = ModelConfig(**cfg.get("model", {}))
        return AgentConfig(name=agent_name, model=model,
                           prompt=cfg.get("prompt", ""))

    def get_mcp_servers(self):
        return [MCPServerConfig(**s) for s in self.data.get("mcp_servers", [])]
