"""Moving instances, duals and model weights between host numpy and torch
devices.

The generator (`core.instance`) returns NamedTuples with numpy leaves, as
the reference's does; these helpers put them on a device.  They accept any
LPData/AxPlan-shaped NamedTuple whose leaves numpy can read, so the tests
feed one generated instance to both packages.  `lm_params_from_numpy`
carries an LM's weights across by path.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .core.types import AxBucket, AxPlan, LPData, Slab


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on.  "cuda" raises when no card
    is present: the port never falls back to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch versions on the CPU")
    return dev


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(device)


def lp_to_torch(lp, device) -> LPData:
    """LPData with numpy (or array-like) leaves -> tensors on `device`."""
    return LPData(slabs=tuple(Slab(*(_t(leaf, device) for leaf in s))
                              for s in lp.slabs),
                  b=_t(lp.b, device))


def plan_to_torch(plan, device) -> AxPlan:
    """An AxPlan -> tensors on `device`; an index-only plan keeps
    a_dm = None."""
    buckets = tuple(AxBucket(*(None if leaf is None else _t(leaf, device)
                               for leaf in b)) for b in plan.buckets)
    return AxPlan(buckets=buckets, inv_perm=_t(plan.inv_perm, device))


def to_numpy(a) -> np.ndarray:
    """A tensor on any device, or anything numpy reads, as a host array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def lp_to_numpy(lp: LPData) -> LPData:
    """Host numpy copy of an LPData with tensor (or numpy) leaves: the
    certificate's independent accumulation runs in numpy."""
    return LPData(slabs=tuple(Slab(*(to_numpy(leaf) for leaf in s))
                              for s in lp.slabs),
                  b=to_numpy(lp.b))


def lam_to_torch(lam, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(lam, np.float32), device=device)


def lam_to_numpy(lam: torch.Tensor) -> np.ndarray:
    return lam.detach().cpu().numpy()


def _host_tensor(a) -> torch.Tensor:
    """A host array as a CPU tensor; numpy has no bfloat16, so an array of
    the `ml_dtypes` bfloat16 type comes in through its 16 bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:       # torch takes no read-only memory
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_numpy(params: Mapping[str, np.ndarray], cfg,
                         device) -> Dict[str, torch.Tensor]:
    """An LM's params by path (the reference's `model.init(...)` leaves as
    host arrays) -> tensors on `device`, each in its `param_defs()` dtype.
    `Model.load_params` checks the paths and shapes."""
    from .models.model import param_defs
    defs = param_defs(cfg)
    return {path: _host_tensor(a).to(
                device=device,
                dtype=defs[path].dtype if path in defs else None)
            for path, a in params.items()}
