"""Data carried across from the reference: the numpy params and traces that
``StackConfig.to_params`` and ``sweep.make_cell`` produce (in either
package — both build numpy) become the port's tensors, dtypes unchanged;
so do a model's params and a whole training state.  The tests use it to
feed both packages identical inputs."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import _param_shapes
from repro_torch.models.common import unflatten_paths
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.step import TrainState


def from_reference(params_np: dict, traces_np: dict,
                   device="cpu") -> tuple[dict, dict]:
    """(params, traces) numpy dicts -> the same arrays as tensors on
    `device`, each with its dtype (int32 stays int32, float32 float32,
    bool bool)."""
    return tuple({k: torch.from_numpy(np.array(v, copy=True)).to(device)
                  for k, v in tree.items()}
                 for tree in (params_np, traces_np))


def params_from_reference(flat: dict, cfg, device="cpu") -> dict:
    """The reference's model params (its ``flatten_paths`` dict, as numpy)
    as this package's nested dict of float32 tensors on `device`.  The
    keys must equal ``configs.base._param_shapes(cfg)`` exactly, and every
    shape must match; values are unchanged."""
    shapes = _param_shapes(cfg)
    if set(flat) != set(shapes):
        raise ValueError(f"params_from_reference: keys differ from "
                         f"_param_shapes: missing "
                         f"{sorted(set(shapes) - set(flat))}, extra "
                         f"{sorted(set(flat) - set(shapes))}")
    out = {}
    for k, shape in shapes.items():
        a = np.asarray(flat[k], dtype=np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"params_from_reference: {k} has shape "
                             f"{a.shape}, want {tuple(shape)}")
        out[k] = torch.from_numpy(a.copy()).to(device)
    return unflatten_paths(out)


def state_from_reference(flat: dict, cfg, device="cpu"):
    """The reference's ``TrainState`` as this package's `TrainState` on
    `device`.  `flat` maps the reference's checkpoint leaf names
    (``.step``, ``.params/...``, ``.opt/.m/...``, ``.opt/.v/...``: its
    ``train/checkpoint._flatten`` of the state) to numpy arrays; params, m
    and v must each hold exactly ``_param_shapes(cfg)``.  Values are
    unchanged; the step stays int32."""
    def part(prefix):
        sub = {k[len(prefix):].replace("/", "."): v for k, v in flat.items()
               if k.startswith(prefix)}
        return params_from_reference(sub, cfg, device)
    step = np.asarray(flat[".step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"state_from_reference: .step is {step.dtype}"
                         f"{step.shape}, want int32 ()")
    return TrainState(step=torch.from_numpy(step.copy()).to(device),
                      params=part(".params/"),
                      opt=AdamWState(m=part(".opt/.m/"), v=part(".opt/.v/")))
