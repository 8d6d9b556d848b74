"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and nvcc; they skip without one (the kernels
have no CPU mode).  They import no JAX, so on a GPU machine without JAX
they run with:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Both sides sum every dot product exactly (f64) and round once, so the
kernel must equal the plain version bit for bit.  chip_smoke.py repeats
these checks at the `full` preset's widths.
"""

import pytest
import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops import rng
from wavenet_tpu_torch.ops.cuda import decode_wide as pwide

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small(dev):
    cfg = tconfig.WaveNetConfig(num_blocks=2, max_dilation=16,
                                residual_channels=128, skip_channels=256)
    params = wn.init_params(cfg, torch.Generator().manual_seed(1), dev)
    return cfg, pwide.flatten_params(params, cfg)


def test_counter_bits_match_plain(dev):
    seeds = rng.derive_row_seeds(9, 5).to(dev)
    for t in (0, 3, 2 ** 31 - 1):
        assert torch.equal(pwide.counter_bits(seeds, t, 256).cpu(),
                           pwide.counter_bits(seeds.cpu(), t, 256))


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("batch", [1, 3, 9])
def test_decode_kernel_equals_plain(dev, small, temp, batch):
    """Free-running and primed: tokens, rings and carry bit for bit, for
    batches that give 1-row and multi-row blocks."""
    cfg, w = small
    prime = torch.randint(0, 256, (batch, 6), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(2)).to(dev)
    for forced in (None, prime):
        rings, carry, s, _, _ = pwide.setup_decode(cfg, batch, 70, forced,
                                                   seeds=5, device=dev)
        k = pwide.decode_chunk(w, cfg, rings, carry, 0, s, 70, temp, forced)
        p = pwide.decode_chunk_reference(w, cfg, rings, carry, 0, s, 70,
                                         temp, forced)
        for a, b in zip(k, p):
            assert torch.equal(a, b)


def test_decode_kernel_chunked_equals_one_shot(dev, small):
    cfg, w = small
    rings, carry, s, _, _ = pwide.setup_decode(cfg, 4, 90, seeds=8,
                                               device=dev)
    one = pwide.decode_chunk(w, cfg, rings, carry, 0, s, 90, 1.0)
    r, c, toks, t0 = rings, carry, [], 0
    for n in (1, 44, 45):
        tk, r, c = pwide.decode_chunk(w, cfg, r, c, t0, s, n, 1.0)
        toks.append(tk)
        t0 += n
    assert torch.equal(torch.cat(toks, 1), one[0])
    assert torch.equal(r, one[1]) and torch.equal(c, one[2])
    before = pwide.launches.value
    pwide.decode_chunk(w, cfg, rings, carry, 0, s, 3, 1.0)
    assert pwide.launches.value == before + 1
