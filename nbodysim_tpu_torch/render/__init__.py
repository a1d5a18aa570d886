from nbodysim_tpu_torch.render.splat import (
    render_frame,
    star_colors,
    RenderConfig,
)
from nbodysim_tpu_torch.render.video import (
    AsyncFrameWriter,
    StreamingVideoWriter,
    save_png,
    save_frames,
    save_video,
)

__all__ = [
    "render_frame",
    "star_colors",
    "RenderConfig",
    "AsyncFrameWriter",
    "StreamingVideoWriter",
    "save_png",
    "save_frames",
    "save_video",
]
