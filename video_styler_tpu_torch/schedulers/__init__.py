from .flow_match import FlowMatchScheduler  # noqa: F401
from .flow_unipc import FlowUniPCMultistepScheduler  # noqa: F401
from .flow_dpm import FlowDPMSolverMultistepScheduler  # noqa: F401
from .ddim import EnhancedDDIMScheduler  # noqa: F401
