"""Flax param trees (as numpy) -> the port's param trees.

The port keeps the Flax tree's keys and maps each leaf 1:1:

* dense ``kernel`` (in, out), ``bias``, norm ``scale``, ``embedding``, the
  packed dense ``qweight`` (K', N') int8 and its ``scales`` (1, N'), and the
  int4 packs ``qweight`` (K'/8, N') int32, ``scales`` and ``zeros``
  (K'/G, N') pass through unchanged (the packed bytes stay identical);
* 4-D conv ``kernel`` / ``qweight`` arrive HWIO and become PyTorch's
  (out, in, kh, kw).

Any other leaf (a packed layout this port does not run yet) raises, and
``load_tree`` raises on a leaf the module does not declare, so nothing is
dropped silently.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from qdm_tpu_torch.models.layers import flatten_tree, unflatten_tree

# leaf name -> the ranks it may have
LEAF_RANKS = {"kernel": (2, 4), "qweight": (2, 4), "bias": (1,), "scale": (1,),
              "embedding": (2,), "scales": (1, 2), "zeros": (2,)}


def hwio_to_oihw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(3, 2, 0, 1).contiguous()


def oihw_to_hwio_shape(shape) -> Tuple[int, ...]:
    o, i, kh, kw = shape
    return (kh, kw, i, o)


def _to_tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16 from jax
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def convert_leaf(path: Tuple[str, ...], arr) -> torch.Tensor:
    name = path[-1]
    t = _to_tensor(arr)
    if name not in LEAF_RANKS or t.dim() not in LEAF_RANKS[name]:
        raise KeyError(f"params_from_jax: leaf {'/'.join(path)!r} with shape "
                       f"{tuple(t.shape)} has no counterpart in the port")
    return hwio_to_oihw(t) if t.dim() == 4 else t


def params_from_jax(flax_params: dict) -> dict:
    """Nested Flax param dict (numpy or jax arrays) -> port param tree of
    CPU tensors in the leaves' own dtypes; the pipeline places them."""
    out: Dict[Tuple[str, ...], torch.Tensor] = {
        path: convert_leaf(path, arr) for path, arr in flatten_tree(flax_params).items()}
    return unflatten_tree(out)
