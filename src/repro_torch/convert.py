"""Data carried across from the reference: the numpy params and traces that
``StackConfig.to_params`` and ``sweep.make_cell`` produce (in either
package — both build numpy) become the port's tensors, dtypes unchanged.
The tests use it to feed both packages identical inputs."""
from __future__ import annotations

import numpy as np
import torch


def from_reference(params_np: dict, traces_np: dict,
                   device="cpu") -> tuple[dict, dict]:
    """(params, traces) numpy dicts -> the same arrays as tensors on
    `device`, each with its dtype (int32 stays int32, float32 float32,
    bool bool)."""
    return tuple({k: torch.from_numpy(np.array(v, copy=True)).to(device)
                  for k, v in tree.items()}
                 for tree in (params_np, traces_np))
