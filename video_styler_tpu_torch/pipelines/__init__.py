from .wan_video import WanVideoPipeline  # noqa: F401
from .wan_video_editor import WanVideoEditorPipeline  # noqa: F401
from .wan_enhancer import WanEnhancerPipeline  # noqa: F401
