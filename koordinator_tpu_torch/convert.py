"""State carry-over between the JAX package's objects and the port's.

The JAX side is reached only through numpy: :func:`fields_of` turns an
object of either package into a dict of numpy arrays, and
:func:`from_numpy` builds the port's object from such a dict on a given
device.  This module imports neither ``jax`` nor anything of
``koordinator_tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koordinator_tpu_torch.device import resolve_device
from koordinator_tpu_torch.ops.assignment import ScoringConfig
from koordinator_tpu_torch.ops.gang import GangInfo
from koordinator_tpu_torch.ops.preemption import ScheduledPods
from koordinator_tpu_torch.ops.reservation import ReservationSet
from koordinator_tpu_torch.quota.admission import QuotaDeviceState
from koordinator_tpu_torch.state.cluster_state import ClusterState, PodBatch

_CLASSES = {
    "ClusterState": ClusterState,
    "PodBatch": PodBatch,
    "ScoringConfig": ScoringConfig,
    "QuotaDeviceState": QuotaDeviceState,
    "GangInfo": GangInfo,
    "ReservationSet": ReservationSet,
    "ScheduledPods": ScheduledPods,
}

#: field names per carried type (the same in both packages; a field kept
#: out of comparison, such as ScheduledPods' carried csr, is the port's own)
FIELDS = {name: tuple(f.name for f in dataclasses.fields(cls) if f.compare)
          for name, cls in _CLASSES.items()}


def fields_of(obj, kind: str) -> dict[str, np.ndarray | None]:
    """Dict of numpy arrays of any object with ``kind``'s fields (a JAX
    object or a port object alike, so it also turns the port's objects
    back into numpy); None fields stay None."""
    out = {}
    for name in FIELDS[kind]:
        v = getattr(obj, name)
        if v is None:
            out[name] = None
        elif torch.is_tensor(v):
            out[name] = v.detach().cpu().numpy()
        else:
            out[name] = np.asarray(v)
    return out


def from_numpy(kind: str, arrays: dict, device=None):
    """The port's ``kind`` object (a key of :data:`FIELDS`) built from a
    dict of numpy arrays on ``device``; a missing or None field stays
    None."""
    dev = resolve_device(device)
    kw = {}
    for name in FIELDS[kind]:
        a = arrays.get(name)
        kw[name] = (None if a is None
                    else torch.from_numpy(np.array(a, copy=True)).to(dev))
    return _CLASSES[kind](**kw)


def reservation_set_from_numpy(arrays: dict, device=None) -> ReservationSet:
    """The port's :class:`ReservationSet` from a dict of numpy arrays of a
    reservation set's fields (``fields_of(rsv, "ReservationSet")`` of the
    JAX package's set), on ``device``."""
    return from_numpy("ReservationSet", arrays, device)
