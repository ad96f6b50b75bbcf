"""Change-state data model + CSV serialization.

Equivalent of the reference change_state.{h,cpp} (khronos/src/backend/
change_state.cpp, change_state.h:64-133): `ObjectChange` with semantics
"first_absent -> first_persistent -> first_seen -> last_seen ->
last_persistent -> last_absent" (h:76-103); `BackgroundChanges` as a
per-vertex enum {kUnobserved, kPersistent, kAbsent}; CSV save/load for all.
Stamps in ns; -1 marks "no evidence".

Host copy of `khronos_tpu/changes/change_state.py`: the CSV files are the
JAX package's byte for byte, so each package reads what the other writes.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict

import numpy as np

# background vertex states
UNOBSERVED = 0
PERSISTENT = 1
ABSENT = 2


@dataclasses.dataclass
class ObjectChange:
    node_id: int
    # evidence before the object was first seen
    first_absent_ns: int = -1  # latest time before first_seen it was absent
    first_persistent_ns: int = -1  # earliest pre-first_seen presence evidence
    # evidence after the object was last seen
    last_persistent_ns: int = -1  # latest post-last_seen presence evidence
    last_absent_ns: int = -1  # earliest time after last_seen it was absent
    merged_id: int = -1  # RPGO-validated merge target


class Changes:
    """Container: object changes by node id + background vertex states."""

    def __init__(self):
        self.object_changes: Dict[int, ObjectChange] = {}
        self.background_states: np.ndarray = np.zeros((0,), np.int8)

    def save(self, directory: str):
        import os

        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "object_changes.csv"), "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(
                [
                    "node_id",
                    "first_absent_ns",
                    "first_persistent_ns",
                    "last_persistent_ns",
                    "last_absent_ns",
                    "merged_id",
                ]
            )
            for oc in self.object_changes.values():
                w.writerow(
                    [
                        oc.node_id,
                        oc.first_absent_ns,
                        oc.first_persistent_ns,
                        oc.last_persistent_ns,
                        oc.last_absent_ns,
                        oc.merged_id,
                    ]
                )
        np.savetxt(
            f"{directory}/background_changes.csv",
            self.background_states[None] if self.background_states.ndim == 1 else self.background_states,
            fmt="%d",
            delimiter=",",
        )

    @staticmethod
    def load(directory: str) -> "Changes":
        import os

        out = Changes()
        path = os.path.join(directory, "object_changes.csv")
        if os.path.exists(path):
            with open(path) as fh:
                for row in csv.DictReader(fh):
                    oc = ObjectChange(
                        node_id=int(row["node_id"]),
                        first_absent_ns=int(row["first_absent_ns"]),
                        first_persistent_ns=int(row["first_persistent_ns"]),
                        last_persistent_ns=int(row["last_persistent_ns"]),
                        last_absent_ns=int(row["last_absent_ns"]),
                        merged_id=int(row["merged_id"]),
                    )
                    out.object_changes[oc.node_id] = oc
        bpath = os.path.join(directory, "background_changes.csv")
        if os.path.exists(bpath):
            out.background_states = np.loadtxt(bpath, delimiter=",", dtype=np.int8).reshape(-1)
        return out
