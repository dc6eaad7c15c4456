from .flow_match import FlowMatchScheduler  # noqa: F401
