from .wan_video import WanVideoPipeline  # noqa: F401
