"""Single-array binary file format, bitwise compatible with the reference.

Format (see reference self_defined/save_np_array_to_file.py:4-39 and
load_np_array_from_file.py:3-27): an ASCII header line

    <name> <C|F> <dtype> <dim0> <dim1> ...\n

followed by the raw array bytes (C order on disk; an 'F' flag means the
logical array is Fortran-contiguous and is rebuilt as such on load).
Writes are fsync'd for durability. Used to ship HMM parameter artifacts
(viterbi_transition_matrix.dat, viterbi_init_probs.dat, p_steady.dat,
transition_int.dat, switch.dat) between pipeline stages.

A copy of viterbi_spl_tpu/io/array_file.py: both packages read and write
the same bytes.
"""

from __future__ import annotations

import os

import numpy as np


def save_array(file_name: str | os.PathLike, array: np.ndarray, name: str) -> None:
    """Save a single named array. Header records contiguity, dtype, shape."""
    if not isinstance(name, str) or not name or " " in name:
        raise ValueError(f"invalid record name {name!r}")
    array = np.asarray(array)
    if array.ndim < 1:
        raise ValueError("only arrays with ndim >= 1 are supported")

    c_flag = array.flags["C_CONTIGUOUS"]
    f_flag = array.flags["F_CONTIGUOUS"]
    if array.ndim == 1:
        order = "C"
    else:
        if not (c_flag or f_flag):
            array = np.ascontiguousarray(array)
            c_flag, f_flag = True, False
        order = "C" if c_flag else "F"

    data = array if order == "C" else np.ascontiguousarray(array)

    with open(file_name, "wb") as fh:
        header = " ".join(
            [name, order, str(array.dtype)] + [str(d) for d in array.shape]
        )
        fh.write(header.encode("utf-8"))
        fh.write(b"\n")
        fh.write(np.ascontiguousarray(data).tobytes())
        fh.flush()
        os.fsync(fh.fileno())


def load_array(file_name: str | os.PathLike) -> tuple[str, np.ndarray]:
    """Load a single named array. Returns (name, array).

    Also accepts the legacy headerless-order variant ``<name> <dtype> <dims...>``
    that the reference loader tolerates (load_np_array_from_file.py:21-25).
    """
    with open(file_name, "rb") as fh:
        fields = fh.readline().decode("utf-8").split()
        name = fields[0]
        if fields[1] in ("C", "F"):
            order, dtype, dims = fields[1], fields[2], [int(v) for v in fields[3:]]
        else:
            order, dtype, dims = "C", fields[1], [int(v) for v in fields[2:]]
        array = np.frombuffer(fh.read(), dtype=dtype).reshape(*dims)
        if len(dims) > 1 and order == "F":
            array = np.asfortranarray(array)
        return name, array
