"""Shared '/'-joined flat codec for nested param dicts, and the weight
carry-over between numpy arrays and port tensors.

flatten_tree / unflatten_tree are the key scheme of the JAX package's
WaveNet.export_npz, so one .npz file serves both packages.

bfloat16 leaves: numpy has no bf16 type of its own.  JAX hands them out as
ml_dtypes' bfloat16 arrays, and an .npz the JAX package writes stores them
under the header type '<V2', which np.load returns as a 2-byte void
array.  The port imports no ml_dtypes: params_from_numpy takes either form
through the raw 16 bits, params_to_numpy returns numpy's bfloat16 type
where one is registered (ml_dtypes, in a process that loaded JAX) and the
raw 2-byte void form elsewhere, and save_npz writes a bf16 leaf under the
header type 'bfloat16', which np.load in a process with ml_dtypes (the JAX
package's from_npz) reads back as bf16 and load_npz here reads as the
void form.
"""

from __future__ import annotations

import ast
import io
import os
import zipfile

import numpy as np
import torch
from numpy.lib import format as npy_format

_BF16_DESCR = "bfloat16"


def _is_bf16(a: np.ndarray) -> bool:
    """An ml_dtypes bfloat16 array or the 2-byte void form of one."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2
                                          and a.dtype.names is None)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.contiguous().view(torch.int16).numpy()
    try:
        return bits.view(np.dtype(_BF16_DESCR))
    except TypeError:                    # no bfloat16 registered in numpy
        return bits.view("V2")


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {'a/b/c': leaf} (insertion order); leaf values (numpy
    arrays or tensors) pass through unchanged.  The trainer and the
    checkpoints keep a mel model's nested params as these flat leaves."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten_tree(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = v
    return flat


def unflatten_tree(flat: dict) -> dict:
    """Inverse of flatten_tree; leaf values pass through unchanged."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """Nested dict of numpy arrays (e.g. JAX params via np.asarray) ->
    the same nested dict of tensors on `device`, shapes and dtypes kept (a
    bf16 leaf in either numpy form becomes a torch.bfloat16 tensor, bit for
    bit)."""
    return {k: (params_from_numpy(v, device) if isinstance(v, dict)
                else _tensor(v).to(device))
            for k, v in tree.items()}


def params_to_numpy(tree: dict) -> dict:
    """Inverse of params_from_numpy: tensors -> numpy arrays on the host
    (bf16 leaves as described in the module docstring)."""
    return {k: (params_to_numpy(v) if isinstance(v, dict) else _array(v))
            for k, v in tree.items()}


def save_npz(file, arrays: dict) -> None:
    """np.savez(file, **arrays) (uncompressed members 'key.npy'; a path
    without the '.npz' suffix gets it), with bf16 arrays in either form
    written under the header type 'bfloat16'."""
    if not hasattr(file, "write"):
        file = os.fspath(file)
        if not file.endswith(".npz"):
            file += ".npz"
    with zipfile.ZipFile(file, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for k, a in arrays.items():
            a = np.asarray(a)
            buf = io.BytesIO()
            if _is_bf16(a):
                a = np.ascontiguousarray(a)
                npy_format.write_array_header_2_0(buf, {
                    "descr": _BF16_DESCR, "fortran_order": False,
                    "shape": a.shape})
                buf.write(a.view(np.uint16).astype("<u2").tobytes())
            else:
                npy_format.write_array(buf, a, allow_pickle=False)
            zf.writestr(k + ".npy", buf.getvalue())


def _read_npy(data: bytes) -> np.ndarray:
    f = io.BytesIO(data)
    major, _ = npy_format.read_magic(f)
    n = int.from_bytes(f.read(2 if major == 1 else 4), "little")
    header = ast.literal_eval(f.read(n).decode("latin1"))
    if header["descr"] != _BF16_DESCR:
        return npy_format.read_array(io.BytesIO(data), allow_pickle=False)
    order = "F" if header["fortran_order"] else "C"
    bits = np.frombuffer(f.read(), "<u2").reshape(header["shape"],
                                                  order=order)
    return np.ascontiguousarray(bits).view("V2")


def load_npz(file) -> dict:
    """An .npz of either package -> {key: numpy array}; bf16 members (the
    JAX package's '<V2' or save_npz's 'bfloat16') come back in the 2-byte
    void form, which params_from_numpy takes."""
    with zipfile.ZipFile(file) as zf:
        return {name[:-4]: _read_npy(zf.read(name)) for name in zf.namelist()
                if name.endswith(".npy")}
