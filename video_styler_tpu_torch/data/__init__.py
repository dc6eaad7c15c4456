from .video import VideoData, save_video  # noqa: F401
