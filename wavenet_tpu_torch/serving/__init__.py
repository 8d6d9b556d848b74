"""Serving: AOT decode artifacts and the microbatching synthesis server
with its stdlib HTTP front-end."""

from wavenet_tpu_torch.serving.aot import (AotDecoder,  # noqa: F401
                                           export_decoder, load_decoder)
from wavenet_tpu_torch.serving.server import WaveNetServer  # noqa: F401
