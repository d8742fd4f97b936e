"""Host-side utilities of the port: visualization and its PNG/GIF codecs,
structured logging, profiling."""

from dvg_tpu_torch.utils.logging import MetricLogger
from dvg_tpu_torch.utils.profiling import StepTimer, trace_context
from dvg_tpu_torch.utils.viz import (add_border, image_grid, save_gif,
                                     save_gif_with_text, save_image)

__all__ = ["image_grid", "save_image", "save_gif", "save_gif_with_text",
           "add_border", "MetricLogger", "StepTimer", "trace_context"]
