"""Microbatching synthesis server and its stdlib HTTP front-end."""

from wavenet_tpu_torch.serving.server import WaveNetServer  # noqa: F401
