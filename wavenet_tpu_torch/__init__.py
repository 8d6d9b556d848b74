"""wavenet_tpu_torch — the PyTorch/CUDA port of wavenet_tpu.

Plain tensor code is PyTorch; the TPU's Pallas kernels become CUDA kernels
written by hand for Hopper (csrc/).  Imports torch and never jax or
wavenet_tpu, so it runs on a GPU machine without JAX.  The serving path of
the unconditional wide presets (e.g. `full`) is ported; see README.md.
"""

from wavenet_tpu_torch.config import (MelConfig, PRESETS, WaveNetConfig,
                                      get_config)

__version__ = "0.1.0"
