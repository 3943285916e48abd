"""Moving instances and duals between host numpy and torch devices.

The generator (`core.instance`) returns NamedTuples with numpy leaves, as
the reference's does; these helpers put them on a device.  They accept any
LPData/AxPlan-shaped NamedTuple whose leaves numpy can read, so the tests
feed one generated instance to both packages.
"""
from __future__ import annotations

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


def lp_to_numpy(lp: LPData) -> LPData:
    """Host numpy copy of a torch LPData (the certificate's independent
    accumulation runs in numpy)."""
    return LPData(slabs=tuple(Slab(*(leaf.cpu().numpy() for leaf in s))
                              for s in lp.slabs),
                  b=lp.b.cpu().numpy())


def lam_to_torch(lam, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(lam, np.float32), device=device)


def lam_to_numpy(lam: torch.Tensor) -> np.ndarray:
    return lam.detach().cpu().numpy()
