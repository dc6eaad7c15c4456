from .wan_video import WanVideoPipeline  # noqa: F401
from .wan_video_editor import WanVideoEditorPipeline  # noqa: F401
from .wan_enhancer import WanEnhancerPipeline  # noqa: F401
from .flux_image import FluxImagePipeline, FluxTeaCache  # noqa: F401
from .sd3_image import SD3ImagePipeline  # noqa: F401
