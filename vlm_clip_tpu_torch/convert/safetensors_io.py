"""A reader of the safetensors format that needs no ``safetensors``
package.

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``__metadata__``), then the raw little-endian bytes of every
tensor, offsets counted from the first byte after the header.

:func:`load_file` returns numpy arrays, as ``safetensors.numpy.load_file``
does, except for BF16 entries: numpy has no bfloat16, so those come back
as torch tensors (the bytes viewed as int16, then as ``torch.bfloat16``).
The converters (``convert/hf.py``, ``vlm/qwen_convert.py``) take either.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]

# safetensors dtype tag -> numpy dtype (BF16 is handled apart)
DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "U16": np.dtype("<u2"),
    "U32": np.dtype("<u4"), "U64": np.dtype("<u8"), "BOOL": np.dtype("?"),
}


def load_file(path: str) -> Dict[str, Array]:
    """Every tensor of one safetensors file, in the header's order."""
    out: Dict[str, Array] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            begin, end = meta["data_offsets"]
            shape = tuple(meta["shape"])
            buf = bytearray(end - begin)
            f.seek(base + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: tensor {name} runs past the "
                                 "end of the file")
            tag = meta["dtype"]
            if tag == "BF16":
                raw = np.frombuffer(buf, np.dtype("<i2")).reshape(shape)
                out[name] = torch.from_numpy(raw).view(torch.bfloat16)
            elif tag in DTYPES:
                out[name] = np.frombuffer(buf, DTYPES[tag]).reshape(shape)
            else:
                raise ValueError(f"{path}: tensor {name} has dtype {tag}, "
                                 "which this reader does not take")
    return out

