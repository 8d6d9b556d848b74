"""The narrow decode kernel's plan (ops/cuda/decode.py plan and smem_bytes)
and its packed weights (pack_layers), on the CPU.

The kernel (csrc/decode.cu) stages each layer's packed blob in shared
memory where two fit beside its arrays, else reads it in place, and keeps
the head's blob resident where it fits too; a block may use 227 KiB.  These
tests pin `supported` to every width it took before this layout (the
partial-sum design, whose shared memory is copied here), hold every plan
to 227 KiB, and unpack the blobs by the kernel's own lane mapping back to
the weights they came from.  The kernel against its plain version is in
tests/test_torch_kernels.py and tests/test_torch_decode_narrow.py (on the
card).
"""

import numpy as np
import pytest
import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.ops.cuda import decode as tdec

torch.set_num_threads(1)

SMEM = 227 * 1024


def _segs_before(ndots: int, kmin: int) -> int:
    s = 1
    while ndots * s < 512 and (kmin + 2 * s - 1) // (2 * s) >= 8:
        s *= 2
    return s


def smem_before(bt, L, R, S, Q, M) -> int:
    """The shared memory of the design before this one: f64 [3R + 2S + M +
    units][bt] (inputs and the widest phase's partial sums), f32 skip sums
    and scores, ints."""
    nz = 4 * R + (2 * R if M else 0)
    units = max(nz * _segs_before(nz, M if M and M < R else R),
                (S + R) * _segs_before(S + R, R), S * _segs_before(S, S),
                Q * _segs_before(Q, S))
    return (8 * bt * (3 * R + 2 * S + M + units)
            + 4 * (bt * (S + Q) + 3 * bt + 2 * L))


def taken_before(cfg) -> bool:
    """supported() as it stood before this layout."""
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    return (cfg.kernel_size == 2 and cfg.compute_dtype == "bfloat16"
            and cfg.embed_channels == cfg.residual_channels
            and smem_before(1, cfg.num_layers, cfg.residual_channels,
                            cfg.skip_channels, cfg.quantization_channels,
                            M) <= SMEM)


def grid(Qs=(256,)):
    for R in (16, 32, 64, 96, 128, 192):
        for S in (16, 32, 48, 64, 128, 256):
            for Q in Qs:
                for M in (0, 80):
                    for speakers in (None, 109):
                        yield tconfig.WaveNetConfig(
                            num_blocks=2, max_dilation=512,
                            residual_channels=R, skip_channels=S,
                            quantization_channels=Q,
                            mel=tconfig.MelConfig(num_mels=M) if M else None,
                            global_classes=speakers)


def _plan(cfg, bt=1):
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    return tdec.plan(bt, cfg.num_layers, cfg.residual_channels,
                     cfg.skip_channels, cfg.quantization_channels, M,
                     cfg.global_classes is not None)


def test_narrow_supported_takes_what_it_took():
    """Over R in {16..192} x S in {16..256}, with and without mel (M = 80)
    and speakers, supported() equals the rule before this layout; at
    Q = 30000 it takes a superset (the scores no longer need partial
    sums): widths may grow, never shrink."""
    cfgs = list(grid())
    assert [tdec.supported(c) for c in cfgs] == [taken_before(c)
                                                 for c in cfgs]
    assert sum(map(tdec.supported, cfgs)) == len(cfgs)
    wide = list(grid(Qs=(30000,)))
    assert all(tdec.supported(c) for c in wide if taken_before(c))
    assert sum(map(tdec.supported, wide)) > sum(map(taken_before, wide))


def test_plan_fits_every_width_taken():
    """Every taken width plans within 227 KiB at one row per block, and at
    every rows per block the plan is the first of decode.PLANS that fits
    (layers staged, the head resident where it fits too, else everything
    in place), its arrays 16-byte aligned in the kernel's order."""
    for cfg in list(grid()) + list(grid(Qs=(30000,))):
        if not tdec.supported(cfg):
            continue
        M = 0 if cfg.mel is None else cfg.mel.num_mels
        for bt in (1, 2, 4, 8, 16):
            args = (bt, cfg.num_layers, cfg.residual_channels,
                    cfg.skip_channels, cfg.quantization_channels, M,
                    cfg.global_classes is not None)
            p = tdec.plan(*args)
            if bt == 1:
                assert p.smem <= SMEM
            if p.smem > SMEM:
                continue
            fits = [o for o in tdec.PLANS
                    if tdec._layout(*args, *o).smem <= SMEM]
            assert (p.stage, p.head_res) == fits[0]
            offs = [p.x, p.h, p.s, p.s1, p.z, p.skip, p.score, p.gs, p.tok,
                    p.mbar, p.stg, p.head, p.smem]
            assert p.x == 0 and offs == sorted(offs)
            assert all(o % 16 == 0 for o in offs)
            assert p.blk % 8 == 0 and p.hblk % 8 == 0


def test_plan_per_preset():
    """Every narrow preset stages its layers at one row per block:
    fastgen_bench, small and tiny with the head resident, conditional
    (mel: 91 KB a layer) with the head in place; every preset's plan fits
    at every rows per block."""
    want = {"tiny": (1, 1), "small": (1, 1), "fastgen_bench": (1, 1),
            "conditional": (1, 0)}
    for name, plan in want.items():
        cfg = tconfig.get_config(name)
        p = _plan(cfg)
        assert (p.stage, p.head_res) == plan, name
        assert all(_plan(cfg, bt).smem <= SMEM for bt in (1, 2, 4, 8, 16))
    p = _plan(tconfig.fastgen_bench())
    assert 2 * p.blk == 58_624 and 2 * p.hblk == 99_840


def _unpack(flat, G, nb, C, K, cols):
    """The kernel's lane mapping read backwards: flat [G][nb][C][32][8]
    (lane q * 8 + s, value 2 j + e at row 64 b + 16 j + 2 s + e of unit
    4 g + q's column cols(unit, c)) -> {(row, column): value}, with the
    values past K or of absent columns, which must be zero, apart."""
    x = flat.reshape(G, nb, C, 4, 8, 4, 2).float().numpy()
    g, b, c, q, s, j, e = np.indices(x.shape)
    row = 64 * b + 16 * j + 2 * s + e
    unit = 4 * g + q
    out, pad = {}, []
    for idx in np.ndindex(x.shape):
        col = cols(int(unit[idx]), int(c[idx]))
        if row[idx] >= K or col is None:
            pad.append(x[idx])
        else:
            assert (row[idx], col) not in out
            out[(int(row[idx]), col)] = x[idx]
    assert not any(pad)
    return out


def _matrix(entries, K, N):
    W = np.zeros((K, N), np.float32)
    for (k, n), v in entries.items():
        W[k, n] = v
    assert len(entries) == K * N
    return W


@pytest.mark.parametrize("widths", [(32, 16), (20, 12)])
@pytest.mark.parametrize("variant", ["plain", "mel", "speaker",
                                     "mel_speaker"])
def test_pack_layers_unpacks(variant, widths):
    """pack_layers' blobs, read with the kernel's lane mapping, give back
    flatten_params' tensors exactly (weights, the f32 biases, the head),
    with zeros in every padded place, at `tiny` widths (R = 32, S = 16)
    and at widths that leave a group of UNITS part empty (R = 20,
    S = 12), 3 layers; a changed weight makes a new pack."""
    R, S = widths
    cfg = tconfig.WaveNetConfig(
        num_blocks=1, max_dilation=4, residual_channels=R, skip_channels=S,
        mel=(tconfig.MelConfig(num_mels=80) if "mel" in variant else None),
        global_classes=3 if "speaker" in variant else None)
    w = tdec.flatten_params(twn.init_params(
        cfg, torch.Generator().manual_seed(5), "cpu"), cfg)
    L, R, S, Q = (cfg.num_layers, cfg.residual_channels, cfg.skip_channels,
                  cfg.quantization_channels)
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    pack, head = tdec.packed_layers(w, cfg)
    wb, bias, blk, h2, hbias, hblk = tdec._blobs(R, S, Q, M)
    assert pack.shape == (L, blk) and head.shape == (hblk,)
    nbR, nbS, nbM = -(-R // 64), -(-S // 64), -(-M // 64)
    gA, gB = -(-R // 4), -(-(S + R) // 4)
    gate = lambda u, c: None if u >= R else (u if c == 0 else R + u)
    f32 = lambda x: x.contiguous().view(torch.float32).numpy()
    for l in range(L):
        a = pack[l, :wb].reshape(gA, 2 * nbR + nbM, -1)
        for part, key, K, nb in (("x", "w_cur", R, nbR),
                                 ("old", "w_prev", R, nbR),
                                 ("y", "v_cond", M, nbM)):
            if not nb:
                continue
            lo = {"x": 0, "old": nbR, "y": 2 * nbR}[part]
            got = _matrix(_unpack(a[:, lo:lo + nb].reshape(-1), gA, nb, 2,
                                  K, gate), K, 2 * R)
            np.testing.assert_array_equal(got, w[key][l].float().numpy())
        sr = _matrix(_unpack(pack[l, wb:bias], gB, nbR, 1, R,
                             lambda u, c: u if u < S + R else None),
                     R, S + R)
        np.testing.assert_array_equal(sr[:, :S], w["w_skip"][l].float())
        np.testing.assert_array_equal(sr[:, S:], w["w_res"][l].float())
        b = f32(pack[l, bias:bias + 2 * (3 * R + S)])
        np.testing.assert_array_equal(b, torch.cat(
            [w["b"][l], w["b_skip"][l], w["b_res"][l]]).numpy())
        assert not pack[l, bias + 2 * (3 * R + S):].float().any()
    for flat, N, W in ((head[:h2], S, "head_w1"), (head[h2:hbias], Q,
                                                   "head_w2")):
        got = _matrix(_unpack(flat, -(-N // 4), nbS, 1, S,
                              lambda u, c, N=N: u if u < N else None), S, N)
        np.testing.assert_array_equal(got, w[W].float().numpy())
    np.testing.assert_array_equal(f32(head[hbias:hbias + 2 * (S + Q)]),
                                  torch.cat([w["head_b1"],
                                             w["head_b2"]]).numpy())
    assert tdec.packed_layers(w, cfg)[0] is pack
    w["w_res"].add_(1.0)
    assert tdec.packed_layers(w, cfg)[0] is not pack


def test_narrow_decode_phases_variants():
    """utils/decode_phases.py --kernel narrow builds its variants with
    macros that csrc/decode.cu reads, and times them at fastgen_bench,
    B = 64."""
    from wavenet_tpu_torch.ops.cuda import build
    from wavenet_tpu_torch.utils import decode_phases
    source = (build.CSRC / "decode.cu").read_text()
    flags = decode_phases.variants("narrow")
    parts = decode_phases.parts("narrow")
    assert set(parts) == {"no_ring", "no_z", "no_skip_res",
                          "no_epilogue_loads"}
    assert set(flags) == {"kernel", "skeleton", *parts,
                          *decode_phases.NARROW_ALTERNATIVES}
    assert sorted(flags["skeleton"]) == sorted("-D" + m
                                               for m in parts.values())
    assert decode_phases.NARROW_ALTERNATIVES == {
        "no_copies": ["-DWN_PHASE_NO_COPIES"]}
    for macro in list(parts.values()) + ["WN_PHASE_NO_COPIES"]:
        assert macro in source
    _, mod, preset, batch = decode_phases.KERNELS["narrow"]
    assert mod is tdec and batch == 64 and tdec.supported(preset())


def test_decode_times_narrow_cases():
    """utils/decode_times.py --kernel narrow: fastgen_bench B = 64,
    conditional B = 4, speakers B = 8, small B = 1 and fastgen_bench at
    B = 264, 528, 1,056 and 2,112, conditional at B = 1,056 and 2,112,
    each a width the narrow kernel takes."""
    from wavenet_tpu_torch.utils import decode_times
    names = [c[0] for c in decode_times.NARROW_CASES]
    assert names == ["fastgen_B64", "conditional_B4", "speaker_B8",
                     "small_B1", "fastgen_B264", "fastgen_B528",
                     "fastgen_B1056", "fastgen_B2112", "conditional_B1056",
                     "conditional_B2112"]
    for _, make, batch, _ in decode_times.NARROW_CASES:
        assert tdec.supported(make()) and batch >= 1
    if not torch.cuda.is_available():
        assert decode_times.main(["--kernel", "narrow"]) == 1
