from .wan_video import WanVideoPipeline  # noqa: F401
from .wan_video_editor import WanVideoEditorPipeline  # noqa: F401
from .wan_enhancer import WanEnhancerPipeline  # noqa: F401
from .flux_image import FluxImagePipeline, FluxTeaCache  # noqa: F401
from .sd3_image import SD3ImagePipeline  # noqa: F401
from .sd_image import SDImagePipeline  # noqa: F401
from .sdxl_image import SDXLImagePipeline  # noqa: F401
from .sd_video import SDVideoPipeline  # noqa: F401
from .sdxl_video import SDXLVideoPipeline  # noqa: F401
