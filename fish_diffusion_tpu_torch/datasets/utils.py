"""Dataset helpers (``fish_diffusion_tpu/datasets/utils.py``): the file
listing and the declarative pipeline interpreter with the ops the vocoder
and SVC datasets use (``PickKeys``, ``ListToDict``, ``PadStack``,
``ToTensor``, a numpy cast as in the JAX package, ``Transpose`` and
``UnSqueeze``). ``PadStack`` pads to a multiple of ``bucket``, as the JAX
package does."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

DEFAULT_BUCKET = 128
_DTYPES = {"float32": np.float32, "float": np.float32, "int64": np.int64,
           "long": np.int64, "int32": np.int32, "bool": np.bool_}


def list_files(path, extensions=frozenset({".npy"})) -> List[Path]:
    return sorted(p for p in Path(path).rglob("*") if p.is_file() and p.suffix in extensions)


def pad_and_stack(x: Sequence[np.ndarray], dim: int = 0,
                  bucket: Optional[int] = None):
    """Pad arrays to a common length along ``dim`` (rounded up to a
    multiple of ``bucket``) and stack -> (stacked, lens, padded_len)."""
    x = [np.asarray(i) for i in x]
    if x[0].dtype == np.float64:
        x = [i.astype(np.float32) for i in x]
    lens = np.asarray([i.shape[dim] for i in x], np.int64)
    max_len = int(lens.max())
    if bucket:
        max_len = -(-max_len // bucket) * bucket
    axis = dim if dim >= 0 else x[0].ndim + dim
    shape = list(x[0].shape)
    shape[axis] = max_len
    out = np.zeros((len(x), *shape), x[0].dtype)
    sl = [slice(None)] * x[0].ndim
    for i, arr in enumerate(x):
        sl[axis] = slice(0, arr.shape[axis])
        out[i][tuple(sl)] = arr
    return out, lens, max_len


def transform_pipeline(pipeline: List[Dict[str, Any]], data,
                       bucket: Optional[int] = None):
    for step in pipeline:
        kind = step["type"]
        if kind == "PickKeys":
            data = {k: data[k] for k in step["keys"]}
        elif kind == "ListToDict":
            keys = step.get("keys") or {j for i in data for j in i}
            data = {k: [i[k] for i in data] for k in keys}
        elif kind == "PadStack":
            for k, dim in step["keys"]:
                stacked, lens, max_len = pad_and_stack(data[k], dim, bucket=bucket)
                data[k] = stacked
                data[k + "_lens"] = lens
                data[k + "_max_len"] = max_len
        elif kind == "ToTensor":
            for k, t in step["keys"]:
                data[k] = np.asarray(data[k], dtype=_DTYPES[t] if isinstance(t, str) else t)
        elif kind == "Transpose":
            for k, *axes in step["keys"]:
                data[k] = np.swapaxes(data[k], *axes)
        elif kind == "UnSqueeze":
            for k, *axes in step["keys"]:
                data[k] = np.expand_dims(data[k], *axes)
        else:
            raise NotImplementedError(f"Unknown transform type: {kind}")
    return data
